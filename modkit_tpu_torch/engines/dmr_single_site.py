"""Single-site DMR (`dmr pair` without --regions).

Reference equivalent: ``src/dmr/single_site.rs``. Walks every comparison
base position genome-wide in interval batches; for positions covered in
both samples computes the llk-ratio score, a MAP-based p-value from the
Beta-difference density (``ops/beta_diff.py``), and an effect size;
optionally feeds consecutive per-site scores into a 2-state Viterbi HMM
segmenter (``hmm.py``) that emits "same"/"different" BED segments.

All per-site numeric work (llk scores, pmap p-values) runs as vectorized
batch kernels per interval; only row formatting is per-site Python.
"""

from __future__ import annotations

import sys

import numpy as np

from ..bedmethyl import AggregatedCounts, aggregate_counts
from ..genome_positions import GenomePositions
from ..hmm import STATE_NAMES, HmmModel, path_to_region_labels
from ..ops.beta_diff import PMapEstimator
from ..thresholds import percentile_linear_interp
from ..writers import format_float
from .dmr import SampleIndex, score_counts_pairs


def _iter_position_batches(
    genome_positions: GenomePositions,
    contigs: list[str],
    interval_size: int,
):
    """Yield (chrom, window_start, window_end, positions) batches with at
    least interval_size positions each (single_site.rs:291-415 batching,
    flattened: one batch per yield, contigs in sorted name order)."""
    for chrom in contigs:
        size = genome_positions.contig_sizes()[chrom]
        batch_positions: list[tuple[int, str, str]] = []
        batch_lo = 0
        pos = 0
        while pos < size:
            end = min(pos + interval_size, size)
            got = genome_positions.get_positions_arrays(chrom, pos, end, ".")
            if got is not None:
                positions, is_neg, bases = got
                for p, n, b in zip(positions, is_neg, bases):
                    batch_positions.append(
                        (int(p), "-" if n else "+", chr(b))
                    )
            if len(batch_positions) >= interval_size:
                yield chrom, batch_lo, end, batch_positions
                batch_positions = []
                batch_lo = end
            pos = end
        if batch_positions:
            yield chrom, batch_lo, size, batch_positions


def _collect_counts(
    sample_index: SampleIndex,
    idxs: list[int],
    chrom: str,
    lo: int,
    hi: int,
    position_set: set,
) -> dict[tuple, list[AggregatedCounts]]:
    """position -> [AggregatedCounts per sample] for positions in the set
    (dmr/tabix.rs:204-339 organize_bedmethy_lines)."""
    out: dict[tuple, list[AggregatedCounts]] = {}
    for i in idxs:
        by_pos: dict[tuple, list] = {}
        for l in sample_index.read_lines(i, chrom, lo, hi):
            key = l.get_stranded_position(sample_index.code_lookup)
            if key in position_set:
                by_pos.setdefault(key, []).append(l)
        for key, lines in by_pos.items():
            try:
                counts = aggregate_counts(lines, sample_index.code_lookup)
            except ValueError:
                continue
            out.setdefault(key, []).append(counts)
    return out


def _collapse_counts(
    counts: list[AggregatedCounts], balance: bool
) -> AggregatedCounts:
    """single_site.rs:662-686."""
    if len(counts) == 1:
        return counts[0]
    if balance:
        total_cov = sum(c.total for c in counts)
        target_cov = np.float32(total_cov) / np.float32(len(counts))
        agg = AggregatedCounts()
        for c in counts:
            mod_counts = {}
            for code, n in c.mod_code_counts.items():
                frac = np.float32(n) / np.float32(c.total)
                mod_counts[code] = int(np.floor(frac * target_cov))
            agg = agg.combine(
                AggregatedCounts(mod_counts, int(target_cov))
            )
        return agg
    agg = AggregatedCounts()
    for c in counts:
        agg = agg.combine(c)
    return agg


def estimate_max_coverages(
    sample_index: SampleIndex,
    a_idxs: list[int],
    b_idxs: list[int],
    genome_positions: GenomePositions,
    contigs: list[str],
    interval_size: int,
    sample_n: int,
) -> tuple[int, int]:
    """95th-percentile valid coverage from the first ~sample_n records
    (single_site.rs:752-831)."""
    a_agg: list[int] = []
    b_agg: list[int] = []
    for chrom, lo, hi, positions in _iter_position_batches(
        genome_positions, contigs, interval_size
    ):
        pos_set = None
        pos_keys = None
        for idxs, agg in ((a_idxs, a_agg), (b_idxs, b_agg)):
            for i in idxs:
                cols = _collect_columns(sample_index, i, chrom, lo, hi)
                if cols is not None:
                    # columnar fast path (same per-LINE semantics)
                    if pos_keys is None:
                        pos_keys = np.fromiter(
                            (
                                p * 8 + (4 if st == "-" else 0)
                                + _BASE_IDX[b]
                                for p, st, b in positions
                            ),
                            dtype=np.int64, count=len(positions),
                        )
                        pos_keys.sort()
                    if len(cols):
                        keys = _row_keys(cols, sample_index.code_lookup)
                        sel = np.isin(keys, pos_keys)
                        agg.extend(cols[sel, 4].tolist())
                    continue
                if pos_set is None:
                    pos_set = set(positions)
                for l in sample_index.read_lines(i, chrom, lo, hi):
                    if (
                        l.get_stranded_position(sample_index.code_lookup)
                        in pos_set
                    ):
                        agg.append(l.valid_coverage)
        if min(len(a_agg), len(b_agg)) >= sample_n:
            break
    a_sorted = np.sort(np.array(a_agg, dtype=np.float32))
    b_sorted = np.sort(np.array(b_agg, dtype=np.float32))
    a_max = int(np.floor(percentile_linear_interp(a_sorted, 0.95)))
    b_max = int(np.floor(percentile_linear_interp(b_sorted, 0.95)))
    return a_max, b_max


class HmmSegmenter:
    """single_site.rs:860-1139 HmmDmrSegmenter."""

    def __init__(self, out_fp: str, hmm: HmmModel, max_gap_size: int):
        self.out = open(out_fp, "w")
        self.hmm = hmm
        self.max_gap_size = max_gap_size
        self.scores: list[float] = []
        self.positions: list[int] = []
        self.counts_a: dict[int, AggregatedCounts] = {}
        self.counts_b: dict[int, AggregatedCounts] = {}
        self.chrom: str | None = None
        self.end: int | None = None

    def add_sites(self, chrom: str, sites: list):
        """sites: (position, score, counts_a, counts_b), position-sorted."""
        if not sites:
            return
        if self.chrom is not None and chrom != self.chrom:
            self.run_current_chunk()
            self.chrom = chrom
        elif self.chrom is None:
            self.chrom = chrom
        elif self.end is not None:
            min_pos = sites[0][0]
            if not (0 <= min_pos - self.end < self.max_gap_size):
                self.run_current_chunk()
                self.chrom = chrom
        for pos, score, ca, cb in sites:
            self.scores.append(score)
            self.positions.append(pos)
            self.counts_a[pos] = ca
            self.counts_b[pos] = cb
        self.end = max(self.end or 0, max(s[0] for s in sites))

    def _counts_range(self, counts, start, end) -> AggregatedCounts:
        agg = AggregatedCounts()
        for pos in sorted(counts):
            if start <= pos < end:
                agg = agg.combine(counts[pos])
        return agg

    def run_current_chunk(self):
        if not self.scores:
            return
        path = self.hmm.viterbi_path(self.scores, self.positions)
        segments = path_to_region_labels(path, self.positions)
        pairs = []
        rows_meta = []
        for start, end, state in segments:
            ca = self._counts_range(self.counts_a, start, end)
            cb = self._counts_range(self.counts_b, start, end)
            pairs.append((ca, cb))
            rows_meta.append((start, end, state, ca, cb))
        scores = score_counts_pairs(pairs)
        for (start, end, state, ca, cb), score in zip(rows_meta, scores):
            if score is None:
                continue
            frac_a = ca.pct_modified()
            frac_b = cb.pct_modified()
            effect = np.float32(frac_a) - np.float32(frac_b)
            num_sites = sum(
                1 for p in self.counts_a if start <= p < end
            )
            self.out.write(
                f"{self.chrom}\t{start}\t{end}\t{STATE_NAMES[state]}\t"
                f"{format_float(score, f64=True)}\t{num_sites}\t"
                f"{ca.string_counts()}\t{cb.string_counts()}\t"
                f"{ca.string_percentages()}\t{cb.string_percentages()}\t"
                f"{format_float(frac_a)}\t{format_float(frac_b)}\t"
                f"{format_float(effect)}\n"
            )
        self.scores = []
        self.positions = []
        self.counts_a = {}
        self.counts_b = {}
        self.end = None

    def finish(self):
        self.run_current_chunk()
        self.out.close()


def _header(multiple_samples: bool, matched_samples: bool) -> str:
    fields = [
        "chrom", "start", "end", "name", "score", "strand",
        "a_counts", "a_total", "b_counts", "b_total",
        "a_mod_percentages", "b_mod_percentages",
        "a_pct_modified", "b_pct_modified", "map_pvalue", "effect_size",
    ]
    if multiple_samples:
        fields += [
            "balanced_map_pvalue", "balanced_effect_size",
            "pct_a_samples", "pct_b_samples",
        ]
    if matched_samples:
        fields += ["replicate_map_pvalues", "replicate_effect_sizes"]
    return "\t".join(fields) + "\n"


def _collect_columns(sample_index, idx, chrom, lo, hi):
    """[n, 6] i64 (start, code, strand01, n_mod, valid, canon) via the
    native columnar bedMethyl parser; None -> Python fallback."""
    from .. import native

    h = sample_index.handlers[idx]
    if not hasattr(h, "fetch_blob"):
        return None
    blob = h.fetch_blob(chrom, lo, hi)
    return native.parse_bedmethyl_columns(
        blob, chrom, lo, hi, sample_index.min_valid_coverage,
        list(sample_index.code_lookup),
    )


_BASE_IDX = {"A": 0, "C": 1, "G": 2, "T": 3}
_COMPL_IDX = {0: 3, 1: 2, 2: 1, 3: 0}


def _row_keys(cols: np.ndarray, code_lookup) -> np.ndarray:
    """Encoded stranded-position key per parsed row:
    start*8 + strand01*4 + base_idx (base complemented on '-')."""
    from ..modcodes import mod_code_sort_key
    from ..native import _encode_mod_code

    vocab = sorted(code_lookup, key=mod_code_sort_key)
    code_enc = np.array([_encode_mod_code(c) for c in vocab], np.int64)
    base_of = np.array(
        [_BASE_IDX[code_lookup[c]] for c in vocab], np.int64
    )
    start, code, strand = cols[:, 0], cols[:, 1], cols[:, 2]
    order_enc = np.argsort(code_enc)
    ci = order_enc[
        np.clip(
            np.searchsorted(code_enc[order_enc], code), 0, len(vocab) - 1
        )
    ]
    skey = (strand == 1).astype(np.int64)
    b = base_of[ci]
    b = np.where(skey == 1, np.array([3, 2, 1, 0])[b], b)
    return start * 8 + skey * 4 + b


def _site_table(cols: np.ndarray, code_lookup) -> tuple:
    """Group a sample's parsed columns into per-site dense count rows.

    Returns (keys_sorted [S], counts [S, C], present [S, C], totals [S],
    code_vocab) where key = start*8 + strandkey*4 + base_idx and C is the
    sorted code vocabulary. Sites failing the aggregate_counts validation
    (mixed valid/canonical within a position, or canonical + mods !=
    valid) are dropped, mirroring the scalar path's ValueError skip."""
    from ..modcodes import complement, mod_code_sort_key
    from ..native import _encode_mod_code

    vocab = sorted(code_lookup, key=mod_code_sort_key)
    code_enc = np.array(
        [_encode_mod_code(c) for c in vocab], dtype=np.int64
    )
    base_of = np.array(
        [_BASE_IDX[code_lookup[c]] for c in vocab], dtype=np.int64
    )
    if len(cols) == 0:
        return (
            np.zeros(0, np.int64), np.zeros((0, len(vocab)), np.int64),
            np.zeros((0, len(vocab)), bool), np.zeros(0, np.int64), vocab,
        )
    start, code, strand, n_mod, valid, canon = cols.T
    ci = np.searchsorted(np.sort(code_enc), code)
    order_enc = np.argsort(code_enc)
    ci = order_enc[np.clip(ci, 0, len(vocab) - 1)]
    # (native parse already filtered to known codes)
    skey = (strand == 1).astype(np.int64)  # '.' and '+' -> 0
    b = base_of[ci]
    b = np.where(skey == 1, np.array([3, 2, 1, 0])[b], b)
    key = start * 8 + skey * 4 + b
    order = np.lexsort((ci, key))
    key_s, ci_s = key[order], ci[order]
    n_mod_s, valid_s, canon_s = n_mod[order], valid[order], canon[order]
    grp = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
    gend = np.r_[grp[1:], len(key_s)]
    keys = key_s[grp]
    S, C = len(keys), len(vocab)
    counts = np.zeros((S, C), dtype=np.int64)
    present = np.zeros((S, C), dtype=bool)
    gidx = np.repeat(np.arange(S), gend - grp)
    np.add.at(counts, (gidx, ci_s), n_mod_s)
    present[gidx, ci_s] = True
    # validation (bedmethyl.py aggregate_counts): one distinct valid and
    # canonical per site, canonical + sum(mods) == valid
    vmin = np.full(S, np.iinfo(np.int64).max)
    vmax = np.zeros(S, dtype=np.int64)
    np.minimum.at(vmin, gidx, valid_s)
    np.maximum.at(vmax, gidx, valid_s)
    cmin = np.full(S, np.iinfo(np.int64).max)
    cmax = np.zeros(S, dtype=np.int64)
    np.minimum.at(cmin, gidx, canon_s)
    np.maximum.at(cmax, gidx, canon_s)
    ok = (vmin == vmax) & (cmin == cmax)
    ok &= cmin + counts.sum(axis=1) == vmin
    return keys[ok], counts[ok], present[ok], vmin[ok], vocab


def _render_sites_fast(
    chrom, keys, ca_counts, ca_present, ca_tot, cb_counts, cb_present,
    cb_tot, vocab, estimator, out, segmenter,
):
    """Vectorized score + render for the single-sample-per-side path;
    byte-identical rows to the scalar path."""
    from ..ops.llk import llk_ratio_beta, llk_ratio_dirichlet
    from ..writers import format_float
    from ..bedmethyl import AggregatedCounts

    S, C = ca_counts.shape
    if S == 0:
        return 0, 0, []
    union = ca_present | cb_present
    usum = union.sum(axis=1)
    # dmr.py score_counts_pairs: categories = max(|codes_a|, |codes_b|)+1;
    # ==2 with a >1-code union is invalid (None -> failure); the dirichlet
    # k comes from the union
    ncat = np.maximum(
        ca_present.sum(axis=1), cb_present.sum(axis=1)
    ) + 1
    mod_a = ca_counts.sum(axis=1)
    mod_b = cb_counts.sum(axis=1)
    scores = np.zeros(S, dtype=np.float64)
    ok = np.ones(S, dtype=bool)
    ok &= ~((ncat == 2) & (usum > 1))
    one = np.flatnonzero((ncat == 2) & (usum == 1))
    if len(one):
        # exactly one category code: its per-site column
        cidx = np.argmax(union[one], axis=1)
        scores[one] = np.atleast_1d(
            llk_ratio_beta(
                ca_counts[one, cidx].astype(np.float64),
                ca_tot[one].astype(np.float64),
                cb_counts[one, cidx].astype(np.float64),
                cb_tot[one].astype(np.float64),
            )
        )
    multi = np.flatnonzero(ncat > 2)
    kvec = usum + 1
    for k in np.unique(kvec[multi]) if len(multi) else ():
        sel = np.flatnonzero((ncat > 2) & (kvec == k))
        kk = int(k)
        rows_a = np.zeros((len(sel), kk), dtype=np.float64)
        rows_b = np.zeros((len(sel), kk), dtype=np.float64)
        for r, si in enumerate(sel):
            cols = np.flatnonzero(union[si])
            rows_a[r, 0] = ca_tot[si] - mod_a[si]
            rows_b[r, 0] = cb_tot[si] - mod_b[si]
            rows_a[r, 1:] = ca_counts[si, cols]
            rows_b[r, 1:] = cb_counts[si, cols]
        scores[sel] = np.atleast_1d(llk_ratio_dirichlet(rows_a, rows_b))
    pmap, effect = estimator.predict_batch(
        mod_a, ca_tot, mod_b, cb_tot
    )
    ok &= np.isfinite(pmap)
    # vectorized f32 percent strings (bedmethyl.py string_percentages)
    f32 = np.float32
    pa = (
        ca_counts.astype(f32) / ca_tot[:, None].astype(f32) * f32(100.0)
    )
    pb = (
        cb_counts.astype(f32) / cb_tot[:, None].astype(f32) * f32(100.0)
    )
    pct_a = mod_a.astype(f32) / ca_tot.astype(f32)
    pct_b = mod_b.astype(f32) / cb_tot.astype(f32)
    names = [str(c) for c in vocab]
    # per-site count/percent strings, built pattern-grouped (sites sharing
    # a presence bitmask render with the same fixed column set — no
    # per-site flatnonzero / numpy scalar ops)
    weights = 1 << np.arange(C)

    def strings_for(present, counts, pcts):
        bits = present @ weights
        sc = [None] * S
        sp = [None] * S
        for pat in np.unique(bits):
            sel = np.flatnonzero(bits == pat)
            cols = [j for j in range(C) if pat & (1 << j)]
            if not cols:
                for i in sel.tolist():
                    sc[i] = sp[i] = "."
                continue
            cnt_cols = [counts[sel, j].tolist() for j in cols]
            pct_cols = [pcts[sel, j] for j in cols]
            pct_strs = [
                np.char.mod(f"{names[j]}:%.2f", pc).tolist()
                for j, pc in zip(cols, pct_cols)
            ]
            sel_l = sel.tolist()
            for row, vals in enumerate(zip(*cnt_cols)):
                i = sel_l[row]
                sc[i] = ",".join(
                    f"{names[j]}:{v}" for j, v in zip(cols, vals)
                )
            for row, vals in enumerate(zip(*pct_strs)):
                i = sel_l[row]
                sp[i] = ",".join(vals)
        return sc, sp

    sc_a, sp_a = strings_for(ca_present, ca_counts, pa)
    sc_b, sp_b = strings_for(cb_present, cb_counts, pb)
    successes = failures = 0
    seg_sites = []
    pos_arr = (keys >> 3).tolist()
    strand_arr = ((keys >> 2) & 1).tolist()
    okl = ok.tolist()
    ca_tot_l = ca_tot.tolist()
    cb_tot_l = cb_tot.tolist()
    scores_l = scores.tolist()
    pmap_l = np.asarray(pmap).tolist()
    effect_l = np.asarray(effect).tolist()
    pct_a_l = pct_a.tolist()
    pct_b_l = pct_b.tolist()
    rows = []
    for i in range(S):
        if not okl[i]:
            failures += 1
            continue
        pos = pos_arr[i]
        strand = "-" if strand_arr[i] else "+"
        rows.append(
            f"{chrom}\t{pos}\t{pos + 1}\t.\t"
            f"{format_float(scores_l[i], f64=True)}\t{strand}\t"
            f"{sc_a[i]}\t{ca_tot_l[i]}\t{sc_b[i]}\t{cb_tot_l[i]}\t"
            f"{sp_a[i]}\t{sp_b[i]}\t"
            f"{format_float(np.float32(pct_a_l[i]))}\t"
            f"{format_float(np.float32(pct_b_l[i]))}\t"
            f"{format_float(pmap_l[i], f64=True)}\t"
            f"{format_float(effect_l[i], f64=True)}\n"
        )
        successes += 1
        if segmenter is not None:
            a_cols = np.flatnonzero(ca_present[i])
            b_cols = np.flatnonzero(cb_present[i])
            ca_obj = AggregatedCounts(
                {vocab[j]: int(ca_counts[i, j]) for j in a_cols},
                int(ca_tot[i]),
            )
            cb_obj = AggregatedCounts(
                {vocab[j]: int(cb_counts[i, j]) for j in b_cols},
                int(cb_tot[i]),
            )
            seg_sites.append((pos, float(scores[i]), ca_obj, cb_obj))
    out.write("".join(rows))
    return successes, failures, seg_sites


def run_single_site_analysis(
    sample_index: SampleIndex,
    a_idxs: list[int],
    b_idxs: list[int],
    genome_positions: GenomePositions,
    out,
    estimator: PMapEstimator,
    interval_size: int = 100_000,
    header: bool = False,
    segmenter: HmmSegmenter | None = None,
    shard: tuple[int, int] = (0, 1),
) -> tuple[int, int]:
    # multi-host: position batches owned round-robin, sentinel-framed
    # shard output merged by rank 0 (the pileup shard machinery)
    pidx, pcount = shard
    num_a, num_b = len(a_idxs), len(b_idxs)
    matched = num_a == num_b and num_a > 1
    multiple = num_a > 1 or num_b > 1
    if header and pidx == 0:
        out.write(_header(multiple, matched))

    contigs = sorted(
        c
        for c in genome_positions.contig_names()
        if any(sample_index.has_contig(i, c) for i in a_idxs)
        and any(sample_index.has_contig(i, c) for i in b_idxs)
    )
    successes = failures = 0
    for batch_idx, (chrom, lo, hi, positions) in enumerate(
        _iter_position_batches(genome_positions, contigs, interval_size)
    ):
        if pcount > 1 and batch_idx % pcount != pidx:
            continue
        # single-sample-per-side fast path: native columnar parse +
        # vectorized site grouping/scoring/rendering (byte-identical rows)
        if num_a == 1 and num_b == 1:
            ca_cols = _collect_columns(
                sample_index, a_idxs[0], chrom, lo, hi
            )
            cb_cols = _collect_columns(
                sample_index, b_idxs[0], chrom, lo, hi
            )
            if ca_cols is not None and cb_cols is not None:
                lookup = sample_index.code_lookup
                ka, ca_cnt, ca_pre, ca_tot, vocab = _site_table(
                    ca_cols, lookup
                )
                kb, cb_cnt, cb_pre, cb_tot, _ = _site_table(
                    cb_cols, lookup
                )
                pos_keys = np.fromiter(
                    (
                        p * 8 + (4 if s == "-" else 0) + _BASE_IDX[b]
                        for p, s, b in positions
                    ),
                    dtype=np.int64, count=len(positions),
                )
                pos_keys.sort()
                common = np.intersect1d(ka, kb, assume_unique=True)
                common = common[
                    np.isin(common, pos_keys, assume_unique=False)
                ]
                ia = np.searchsorted(ka, common)
                ib = np.searchsorted(kb, common)
                s_ok, s_fail, seg_sites = _render_sites_fast(
                    chrom, common, ca_cnt[ia], ca_pre[ia], ca_tot[ia],
                    cb_cnt[ib], cb_pre[ib], cb_tot[ib], vocab,
                    estimator, out, segmenter,
                )
                successes += s_ok
                failures += s_fail
                if segmenter is not None:
                    segmenter.add_sites(chrom, seg_sites)
                if pcount > 1:
                    out.write("\x00TILE\x00")
                continue
        pos_set = set(positions)
        counts_a = _collect_counts(
            sample_index, a_idxs, chrom, lo, hi, pos_set
        )
        counts_b = _collect_counts(
            sample_index, b_idxs, chrom, lo, hi, pos_set
        )
        # positions present in both, sorted (BTreeMap order: position,
        # then +strand before -strand)
        common = sorted(
            (k for k in counts_a if k in counts_b),
            key=lambda k: (k[0], 0 if k[1] == "+" else 1),
        )
        if not common:
            if pcount > 1:
                out.write("\x00TILE\x00")
            continue
        site_rows = []
        collapsed_pairs = []
        balanced_pairs = []
        for key in common:
            ca_list = counts_a[key]
            cb_list = counts_b[key]
            collapsed_pairs.append(
                (
                    _collapse_counts(ca_list, False),
                    _collapse_counts(cb_list, False),
                )
            )
            if multiple:
                balanced_pairs.append(
                    (
                        _collapse_counts(ca_list, True),
                        _collapse_counts(cb_list, True),
                    )
                )
            site_rows.append((key, ca_list, cb_list))
        llr_scores = score_counts_pairs([p for p in collapsed_pairs])
        pmap, effect = estimator.predict_batch(
            np.array([p[0].modified_counts() for p in collapsed_pairs]),
            np.array([p[0].total for p in collapsed_pairs]),
            np.array([p[1].modified_counts() for p in collapsed_pairs]),
            np.array([p[1].total for p in collapsed_pairs]),
        )
        if multiple:
            bal_pmap, bal_effect = estimator.predict_batch(
                np.array([p[0].modified_counts() for p in balanced_pairs]),
                np.array([p[0].total for p in balanced_pairs]),
                np.array([p[1].modified_counts() for p in balanced_pairs]),
                np.array([p[1].total for p in balanced_pairs]),
            )
        seg_sites = []
        for i, (key, ca_list, cb_list) in enumerate(site_rows):
            score = llr_scores[i]
            if score is None or not np.isfinite(pmap[i]):
                failures += 1
                continue
            pos, strand, _base = key
            ca, cb = collapsed_pairs[i]
            row = (
                f"{chrom}\t{pos}\t{pos + 1}\t.\t"
                f"{format_float(score, f64=True)}\t{strand}\t"
                f"{ca.string_counts()}\t{ca.total}\t"
                f"{cb.string_counts()}\t{cb.total}\t"
                f"{ca.string_percentages()}\t{cb.string_percentages()}\t"
                f"{format_float(ca.pct_modified())}\t"
                f"{format_float(cb.pct_modified())}\t"
                f"{format_float(pmap[i], f64=True)}\t"
                f"{format_float(effect[i], f64=True)}"
            )
            if multiple:
                pct_a = int(np.floor(
                    np.float32(len(ca_list))
                    / np.float32(num_a)
                    * np.float32(100.0)
                ))
                pct_b = int(np.floor(
                    np.float32(len(cb_list))
                    / np.float32(num_b)
                    * np.float32(100.0)
                ))
                row += (
                    f"\t{format_float(bal_pmap[i], f64=True)}\t"
                    f"{format_float(bal_effect[i], f64=True)}\t"
                    f"{pct_a}\t{pct_b}"
                )
            if matched:
                if len(ca_list) == len(cb_list):
                    rep_pmap, rep_eff = estimator.predict_batch(
                        np.array([c.modified_counts() for c in ca_list]),
                        np.array([c.total for c in ca_list]),
                        np.array([c.modified_counts() for c in cb_list]),
                        np.array([c.total for c in cb_list]),
                    )
                    rp = ",".join(
                        format_float(v, f64=True) for v in rep_pmap
                    )
                    re_ = ",".join(
                        format_float(v, f64=True) for v in rep_eff
                    )
                else:
                    rp = re_ = "-"
                row += f"\t{rp}\t{re_}"
            out.write(row + "\n")
            successes += 1
            seg_sites.append((pos, score, ca, cb))
        if segmenter is not None:
            segmenter.add_sites(chrom, seg_sites)
        if pcount > 1:
            out.write("\x00TILE\x00")
    if segmenter is not None:
        segmenter.finish()
    return successes, failures


def run_single_site(args, code_lookup) -> int:
    """CLI glue for `dmr pair` single-site mode
    (dmr/subcommands.rs:457-491)."""
    import os

    from .dmr import explicit_index_paths

    sample_index = SampleIndex(
        list(args.a) + list(args.b), code_lookup, args.min_valid_coverage,
        io_threads=args.io_threads, index_paths=explicit_index_paths(args),
    )
    a_idxs = list(range(len(args.a)))
    b_idxs = [i + len(args.a) for i in range(len(args.b))]
    genome_positions = GenomePositions(
        list(args.base),
        args.ref,
        mask=args.mask,
        contigs=sample_index.all_contigs(),
    )
    contigs = sorted(
        c
        for c in genome_positions.contig_names()
        if any(sample_index.has_contig(i, c) for i in a_idxs)
        and any(sample_index.has_contig(i, c) for i in b_idxs)
    )
    prior = tuple(args.prior) if args.prior else (0.55, 0.55)
    if prior[0] + prior[1] < 1.0:
        raise SystemExit("alpha + beta must be > 1.0 for numerical stability")
    if args.max_coverages:
        max_covs = (args.max_coverages[0], args.max_coverages[1])
    else:
        max_covs = estimate_max_coverages(
            sample_index,
            a_idxs,
            b_idxs,
            genome_positions,
            contigs,
            args.interval_size,
            args.n_sample_records,
        )
        print(
            f"calculated max coverage for a: {max_covs[0]} and "
            f"b: {max_covs[1]}",
            file=sys.stderr,
        )
    estimator = PMapEstimator(
        max_covs,
        len(args.a),
        len(args.b),
        prior=prior,
        rope=args.delta,
        cap_coverages=args.cap_coverages,
    )
    segmenter = None
    if args.segment:
        linear = False if args.fine_grained else not args.log_transition_decay
        if args.fine_grained:
            hmm = HmmModel(
                dmr_prior=0.1,
                diff_stay=0.9,
                significance_factor=0.01,
                decay_distance=args.decay_distance,
                linear_transitions=linear,
            )
        else:
            hmm = HmmModel(
                dmr_prior=args.dmr_prior,
                diff_stay=args.diff_stay,
                significance_factor=args.significance_factor,
                decay_distance=args.decay_distance,
                linear_transitions=linear,
            )
        segmenter = HmmSegmenter(args.segment, hmm, args.max_gap_size)
    from ..parallel.devices import (
        maybe_init_distributed, process_info, shard_path,
    )

    maybe_init_distributed()
    pidx, pcount = process_info()
    if pcount > 1 and (args.out_path is None or segmenter is not None):
        raise SystemExit(
            "multi-host dmr single-site requires -o/--out-path and no "
            "--segment (HMM segmentation is cross-batch stateful)"
        )
    if args.out_path is None:
        out = sys.stdout
        close = False
    else:
        if (
            os.path.exists(args.out_path)
            and not args.force
            and pcount == 1
        ):
            raise SystemExit(
                f"refusing to overwrite existing file {args.out_path}"
            )
        os.makedirs(os.path.dirname(args.out_path) or ".", exist_ok=True)
        path = (
            shard_path(args.out_path, pidx) if pcount > 1 else args.out_path
        )
        out = open(path, "w")
        close = True
    try:
        run_single_site_analysis(
            sample_index,
            a_idxs,
            b_idxs,
            genome_positions,
            out,
            estimator,
            interval_size=args.interval_size,
            header=args.header,
            segmenter=segmenter,
            shard=(pidx, pcount),
        )
    finally:
        if close:
            out.close()
    if pcount > 1:
        from ..parallel.devices import merge_shards, sync_processes

        sync_processes("modkit_dmr_single_site_shards")
        if pidx == 0:
            merge_shards(args.out_path, pcount)
    return 0
