"""`summary` and `sample-probs` engines.

Reference: summarize.rs:59 summarize_modbam / commands.rs:680
SampleModBaseProbs. Both operate on the sampled read representation from
thresholds.sample_reads; per-call classification (threshold call + argmax
call) is vectorized over the sampled probability matrices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .caller import ThresholdCaller
from .modcodes import DNA_BASES, mod_code_sort_key
from .thresholds import (
    Percentiles, confidences_per_base, thresholds_from_sampled,
)
from .writers import format_float, render_clean_table

CANONICAL = "__canonical__"


def _state_key(codes, j):
    return CANONICAL if j < 0 else codes[j]


def classify_group(
    codes: list, probs: np.ndarray, base: str, caller: ThresholdCaller
) -> tuple[np.ndarray, np.ndarray]:
    """Return (threshold_state, argmax_state) int arrays per position:
    -2 = filtered, -1 = canonical, j >= 0 = mod code column j."""
    m = probs.shape[1]
    live = np.where(probs >= 0, probs, np.float32(0))
    canon = np.float32(1.0) - live.sum(axis=1, dtype=np.float32)
    if m:
        thr_mod = np.array(
            [caller.mod_threshold(c, base) for c in codes], dtype=np.float32
        )
        present = probs >= 0
        pass_mod = present & (probs >= thr_mod[None, :])
        mod_p = np.where(pass_mod, probs, -np.inf)
        rev_arg = (m - 1) - np.argmax(mod_p[:, ::-1], axis=1)
        best_pass = np.take_along_axis(mod_p, rev_arg[:, None], axis=1)[:, 0]
        any_mod = pass_mod.any(axis=1)
        # argmax (no thresholds): mod wins only if strictly > canonical
        amax_p = np.where(present, probs, -np.inf)
        amax_rev = (m - 1) - np.argmax(amax_p[:, ::-1], axis=1)
        amax_best = np.take_along_axis(amax_p, amax_rev[:, None], axis=1)[:, 0]
        argmax_state = np.where(amax_best > canon, amax_rev, -1)
    else:
        pass_mod = np.zeros((len(probs), 0), dtype=bool)
        any_mod = np.zeros(len(probs), dtype=bool)
        best_pass = np.full(len(probs), -np.inf, dtype=np.float32)
        rev_arg = np.zeros(len(probs), dtype=np.int64)
        argmax_state = np.full(len(probs), -1, dtype=np.int64)
    pass_can = canon >= np.float32(caller.canonical_threshold(base))
    choose_can = pass_can & ((~any_mod) | (canon >= best_pass))
    thr_state = np.where(
        choose_can, -1, np.where(any_mod, rev_arg, -2)
    )
    return thr_state, argmax_state


@dataclass
class ModSummary:
    reads_with_mod_calls: dict  # base char -> count
    mod_call_counts: dict  # base char -> {state: count}
    filtered_mod_call_counts: dict  # base char -> {state: count}
    total_reads_used: int
    per_base_thresholds: dict  # base char -> f32
    per_base_mod_codes: dict  # base char -> set of codes
    region: str | None = None

    def mod_bases(self) -> str:
        return ",".join(sorted(self.mod_call_counts))


def summarize_sampled(
    sampled: dict,
    caller: ThresholdCaller,
    region: str | None = None,
) -> ModSummary:
    """summarize.rs:116 sampled_reads_to_summary."""
    reads_with = {}
    counts: dict[str, dict] = {}
    filtered: dict[str, dict] = {}
    observed: dict[str, set] = {}
    for per_base in sampled.values():
        for b, groups in per_base.items():
            base = DNA_BASES[b]
            reads_with[base] = reads_with.get(base, 0) + 1
            c = counts.setdefault(base, {})
            f = filtered.setdefault(base, {})
            obs = observed.setdefault(base, set())
            for codes, probs in groups:
                present_any = (probs >= 0).any(axis=0)
                obs.update(c_ for c_, p in zip(codes, present_any) if p)
                thr_state, argmax_state = classify_group(
                    codes, probs, base, caller
                )
                for j in np.unique(thr_state):
                    n = int((thr_state == j).sum())
                    if j == -2:
                        continue
                    key = _state_key(codes, int(j))
                    c[key] = c.get(key, 0) + n
                filt = thr_state == -2
                if filt.any():
                    for j in np.unique(argmax_state[filt]):
                        n = int((argmax_state[filt] == j).sum())
                        key = _state_key(codes, int(j))
                        f[key] = f.get(key, 0) + n
    # the reference reports only the caller's per-base thresholds
    # (summarize.rs:246 iter_thresholds)
    thresholds = dict(caller.per_base)
    return ModSummary(
        reads_with, counts, filtered, len(sampled), thresholds,
        observed, region,
    )


def summarize_modbam(
    bam_path: str,
    num_reads: int | None = None,
    sample_frac: float | None = None,
    seed: int | None = None,
    region: str | None = None,
    filter_percentile: float = 0.1,
    caller: ThresholdCaller | None = None,
    collapse=None,
    edge_filter=None,
    position_filter=None,
    only_mapped: bool = False,
    interval_size: int = 1_000_000,
) -> ModSummary:
    """summarize.rs:59 summarize_modbam convenience entry."""
    from .io.bam import BamReader
    from .thresholds import sample_reads

    reader = BamReader(bam_path)
    sampled = sample_reads(
        reader, num_reads, sample_frac, seed,
        include_unmapped=not only_mapped, region=region, collapse=collapse,
        edge_filter=edge_filter, position_filter=position_filter,
        interval_size=interval_size, only_mapped=only_mapped,
    )
    if caller is None:
        per_base = thresholds_from_sampled(sampled, filter_percentile)
        caller = ThresholdCaller(per_base, {}, 0.0)
    return summarize_sampled(sampled, caller, region)


def _sort_states(states):
    # BaseState Ord: Canonical < Modified? derive order: enum BaseState
    # {Canonical, Modified} -> Canonical sorts first
    def key(s):
        if s == CANONICAL:
            return (0, (0, 0, ""))
        return (1, mod_code_sort_key(s))

    return sorted(states, key=key)


def render_summary_table(s: ModSummary) -> str:
    """writers.rs:394 TableWriter for ModSummary."""
    meta = [["bases", s.mod_bases()], ["total_reads_used", str(s.total_reads_used)]]
    for base in sorted(s.reads_with_mod_calls):
        meta.append([f"count_reads_{base}", str(s.reads_with_mod_calls[base])])
    for base in sorted(s.per_base_thresholds):
        meta.append(
            [f"pass_threshold_{base}", format_float(s.per_base_thresholds[base])]
        )
    if s.region:
        meta.append(["region", s.region])
    out = []
    w = max((len(r[0]) for r in meta), default=0)
    w2 = max((len(r[1]) for r in meta), default=0)
    for k, v in meta:
        out.append(f"# {k:<{w}} {v:<{w2}} ")

    rows = [["base", "code", "pass_count", "pass_frac", "all_count", "all_frac"]]
    for base in sorted(s.per_base_mod_codes):
        pass_counts = s.mod_call_counts.get(base, {})
        filt_counts = s.filtered_mod_call_counts.get(base, {})
        total_pass = sum(pass_counts.values())
        total_all = total_pass + sum(filt_counts.values())
        remaining = set(s.per_base_mod_codes.get(base, set()))
        seen_canonical = False
        for state in _sort_states(pass_counts):
            n_pass = pass_counts[state]
            if state == CANONICAL:
                seen_canonical = True
                label = "-"
            else:
                remaining.discard(state)
                label = str(state)
            n_all = n_pass + filt_counts.get(state, 0)
            rows.append([
                base, label, str(n_pass),
                format_float(np.float32(n_pass) / np.float32(total_pass)) if total_pass else "0",
                str(n_all),
                format_float(np.float32(n_all) / np.float32(total_all)) if total_all else "0",
            ])
        if not seen_canonical:
            rows.append([base, "-", "0", "0", "0", "0"])
        for code in sorted(remaining, key=mod_code_sort_key):
            rows.append([base, str(code), "0", "0", "0", "0"])
    return "\n".join(out) + "\n" + render_clean_table(rows) + "\n"


def render_summary_tsv(s: ModSummary) -> str:
    """writers.rs:609 TsvWriter for ModSummary."""
    out = [f"mod_bases\t{s.mod_bases()}"]
    for base in sorted(s.reads_with_mod_calls):
        out.append(f"count_reads_{base}\t{s.reads_with_mod_calls[base]}")
    for base in sorted(s.mod_call_counts):
        mod_counts = s.mod_call_counts[base]
        total = sum(mod_counts.values())
        total_filtered = sum(
            s.filtered_mod_call_counts.get(base, {}).values()
        )
        for state in _sort_states(mod_counts):
            n = mod_counts[state]
            label = (
                "unmodified" if state == CANONICAL else f"modified_{state}"
            )
            filt = s.filtered_mod_call_counts.get(base, {}).get(state, 0)
            out.append(f"{base}_pass_calls_{label}\t{n}")
            out.append(
                f"{base}_pass_frac_{label}\t{format_float(n / total if total else 0.0, f64=True)}"
            )
            out.append(f"{base}_fail_calls_{label}\t{filt}")
        out.append(f"{base}_total_mod_calls\t{total}")
        out.append(f"{base}_total_fail_mod_calls\t{total_filtered}")
    out.append(f"total_reads_used\t{s.total_reads_used}")
    return "\n".join(out) + "\n"


def render_percentiles_table(
    per_base_percentiles: dict[str, Percentiles]
) -> str:
    """writers.rs:778 thresholds_table."""
    rows = [["base", "percentile", "threshold"]]
    for base in sorted(per_base_percentiles):
        for q, p in per_base_percentiles[base].qs:
            rows.append(
                [base, format_float(np.float32(q) * np.float32(100.0)),
                 format_float(p)]
            )
    return render_clean_table(rows) + "\n"


def sample_probs_percentiles(
    sampled: dict, desired_percentiles: list[float]
) -> dict[str, Percentiles]:
    out = {}
    for b, probs in confidences_per_base(sampled).items():
        out[DNA_BASES[b]] = Percentiles(probs, desired_percentiles)
    return out


def prob_histograms(sampled: dict) -> dict:
    """Per-(primary base, argmax state) qual-bin histograms of the winning
    call probability: {(base_char, state): int64[256]} with state CANONICAL
    or the winning mod code (read_ids_to_base_mod_probs.rs:104
    mle_probs_per_base_mod + :159 get_per_mod_histograms; bins are
    prob_to_qual = floor(p*256), 255 for p==1, mod_bam.rs:798)."""
    f32 = np.float32
    out: dict = {}

    def acc(key, quals):
        if not len(quals):
            return
        h = out.get(key)
        if h is None:
            h = out[key] = np.zeros(256, dtype=np.int64)
        h += np.bincount(quals, minlength=256)

    for per_base in sampled.values():
        for b_idx, groups in per_base.items():
            base = DNA_BASES[b_idx]
            for codes, probs in groups:
                n, m = probs.shape
                if n == 0:
                    continue
                live = np.where(probs >= 0, probs, f32(0))
                canon = f32(1.0) - live.sum(axis=1, dtype=f32)
                if m:
                    masked = np.where(probs >= 0, probs, -np.inf)
                    # ties between mods resolve to the LAST max (Rust
                    # max_by semantics in argmax_base_mod_call)
                    win_j = (m - 1) - np.argmax(masked[:, ::-1], axis=1)
                    best = masked[np.arange(n), win_j]
                else:
                    win_j = np.zeros(n, dtype=np.int64)
                    best = np.full(n, -np.inf, dtype=f32)
                mod_wins = best > canon  # canonical wins ties
                win_p = np.where(mod_wins, best, canon).astype(f32)
                quals = np.floor(win_p * f32(256.0)).astype(np.int64)
                quals[win_p == f32(1.0)] = 255
                np.clip(quals, 0, 255, out=quals)
                acc((base, CANONICAL), quals[~mod_wins])
                for j in range(m):
                    acc(
                        (base, codes[j]),
                        quals[mod_wins & (win_j == j)],
                    )
    return out


def _hist_sort_key(key):
    """(primary base, state) ordering: base, then Canonical < Code(char) <
    ChEbi(u32) (derived Ord on BaseState/ModCodeRepr, mod_base_code.rs:106,
    :253)."""
    base, state = key
    if state is CANONICAL:
        return (base, 0, "")
    if isinstance(state, int):
        return (base, 2, state)
    return (base, 1, str(state))


def render_probabilities_tsv(hists: dict) -> str:
    """probabilities.tsv rows (writers.rs:842-935: code, primary_base,
    range_start, range_end, count, frac, percentile_rank; percentile rank
    is the midpoint rank (cum - 0.5 n)/total * 100 in f32)."""
    f32 = np.float32
    lines = [
        "code\tprimary_base\trange_start\trange_end\tcount\tfrac"
        "\tpercentile_rank"
    ]
    for key in sorted(hists, key=_hist_sort_key):
        base, state = key
        counts = hists[key]
        total = f32(counts.sum())
        code_str = "-" if state is CANONICAL else str(state)
        cum = f32(0.0)
        for q in np.flatnonzero(counts):
            n = int(counts[q])
            frac = f32(n) / total
            cum = cum + f32(n)
            rank = ((cum - f32(0.5) * f32(n)) / total) * f32(100.0)
            lines.append(
                "\t".join(
                    [
                        code_str, base,
                        format_float(f32(q) / f32(256.0)),
                        format_float(f32(q + 1) / f32(256.0)),
                        str(n),
                        format_float(frac),
                        format_float(rank),
                    ]
                )
            )
    return "\n".join(lines) + "\n"


def histogram_chart_data(hists: dict):
    """(categories, counts_series, proportion_series) for the counts.html /
    proportion.html bar charts (writers.rs:795-985): categories are the
    union of observed qual bins labelled "[from, to)" in percent."""
    f32 = np.float32
    bins = sorted(
        {int(q) for h in hists.values() for q in np.flatnonzero(h)}
    )
    categories = [
        "[{:.2f}, {:.2f})".format(
            float(f32(q) / f32(256.0) * f32(100.0)),
            float(f32(q + 1) / f32(256.0) * f32(100.0)),
        )
        for q in bins
    ]
    counts_series = []
    prop_series = []
    for key in sorted(hists, key=_hist_sort_key):
        base, state = key
        label = f"{base}:{'-' if state is CANONICAL else state}"
        h = hists[key]
        dat = [int(h[q]) for q in bins]
        tot = sum(dat) or 1
        counts_series.append((label, dat))
        prop_series.append(
            (label, [float(f32(x) / f32(tot)) for x in dat])
        )
    return categories, counts_series, prop_series
