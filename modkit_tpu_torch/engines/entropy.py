"""Methylation (epiallele) entropy in sliding windows of N motif positions.

Reference equivalent: ``src/entropy/``. For each window of `num_positions`
motif positions (within `window_size` bp), every primary mapped read fully
covering the window contributes an epiallele string: one symbol per
position -- '0' canonical, '1'..'9' per modification code, '*' filtered.
Methylation entropy is ``-(1/N) * sum p log2 p`` over the distribution of
epiallele patterns, with '*' wildcards fractionally distributed over the
compatible patterns (entropy/methylation_entropy.rs all_patterns_dp).

Windows mode emits one bedgraph row per window/strand; regions mode emits
descriptive statistics per BED region plus the windows file.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..caller import ThresholdCaller
from ..io.bam import BamReader
from ..io.fasta import FastaReader
from ..modcodes import mod_code_sort_key
from ..motifs import Motif
from ..thresholds import percentile_linear_interp
from ..writers import format_float

STRAND_POS = 0
STRAND_NEG = 1


# ------------------------------------------------------------- entropy ----


def _columns_alphabet(sequences: list[str], window_size: int) -> list[str]:
    """Per-column sorted alphabet of non-'*' symbols
    (methylation_entropy.rs:15-49 AlphabetInfo)."""
    s = np.frombuffer("".join(sequences).encode(), dtype=np.uint8)
    s = s.reshape(len(sequences), window_size)
    return [
        "".join(
            chr(c) for c in np.unique(s[:, i]).tolist() if c != ord("*")
        )
        for i in range(window_size)
    ]


def _matches(seq: str, pattern: str) -> bool:
    """seq (with '*' wildcards) matches a concrete pattern."""
    return all(s == "*" or s == p for s, p in zip(seq, pattern))


def all_patterns_dp(
    sequences: list[str], window_size: int, columns: list[str]
) -> list[str]:
    """methylation_entropy.rs:72-139 -- expand wildcards into the set of
    concrete patterns consistent with the observed sequences."""
    uniq = sorted(set(sequences))
    if not any("*" in s for s in uniq):
        return uniq
    acc = set(columns[0])
    for idx in range(1, window_size):
        nxt = set()
        for seq in uniq:
            prefix = seq[:idx]
            for pattern in acc:
                if _matches(prefix, pattern):
                    last = seq[idx]
                    if last == "*":
                        for x in columns[idx]:
                            nxt.add(pattern + x)
                    else:
                        nxt.add(pattern + last)
        acc = nxt
    return sorted(acc)


def calc_me_entropy(
    sequences: list[str], window_size: int, constant: float
) -> np.float32:
    """methylation_entropy.rs:142-199 (f32 arithmetic).

    Dispatches to the native C++ kernel when available (mk_me_entropy —
    same accumulation orders, and its log2f matches the reference's Rust
    f32::log2 exactly where numpy's SIMD log2 can differ by 1 ulp); the
    numpy path below is the fallback/oracle."""
    from .. import native as _native

    r = _native.me_entropy(sequences, window_size, float(np.float32(constant)))
    if r is not None:
        return np.float32(r)
    return _calc_me_entropy_py(sequences, window_size, constant)


def _calc_me_entropy_py(
    sequences: list[str], window_size: int, constant: float
) -> np.float32:
    """Pure-Python/numpy oracle for calc_me_entropy.

    Vectorized wildcard matching (the per-seq x per-pattern char loop was
    an entropy hot spot); the f32 accumulation orders of the scalar
    dict-based loop are preserved exactly — counts add in sequence order,
    and the total/shannon sums visit patterns in first-hit insertion
    order."""
    joined = "".join(sequences)
    if "*" not in joined:
        # no wildcards: each sequence matches exactly itself — plain
        # counting in first-occurrence order (the dict insertion order of
        # the scalar path)
        counts: dict = {}
        one = np.float32(1.0)
        for seq in sequences:
            counts[seq] = counts.get(seq, np.float32(0.0)) + one
        total = np.float32(0.0)
        for v in counts.values():
            total = total + v
        shannon = np.float32(0.0)
        for v in counts.values():
            p = v / total
            shannon = shannon + p * np.float32(np.log2(p))
        me = np.float32(constant) * (-shannon)
        if me == np.float32(-0.0):
            return np.float32(0.0)
        return me
    columns = _columns_alphabet(sequences, window_size)
    patterns = all_patterns_dp(sequences, window_size, columns)
    s_arr = np.frombuffer(joined.encode(), dtype=np.uint8)
    s_arr = s_arr.reshape(len(sequences), window_size)
    p_arr = np.frombuffer("".join(patterns).encode(), dtype=np.uint8)
    p_arr = p_arr.reshape(len(patterns), window_size)
    match = (
        (s_arr[:, None, :] == p_arr[None, :, :])
        | (s_arr[:, None, :] == ord("*"))
    ).all(axis=2)  # [n_seq, n_pat]
    factor = np.float32(1.0) / match.sum(axis=1).astype(np.float32)
    counts = np.zeros(len(patterns), dtype=np.float32)
    for i in range(len(sequences)):
        counts[match[i]] += factor[i]
    hit_any = match.any(axis=0)
    # dict insertion order = first sequence that hits, then pattern order
    first_seq = np.where(hit_any, match.argmax(axis=0), len(sequences))
    order = np.lexsort((np.arange(len(patterns)), first_seq))
    total = np.float32(0.0)
    for pi in order.tolist():
        if hit_any[pi]:
            total = total + counts[pi]
    shannon = np.float32(0.0)
    for pi in order.tolist():
        if not hit_any[pi]:
            continue
        p = counts[pi] / total
        shannon = shannon + p * np.float32(np.log2(p))
    me = np.float32(constant) * (-shannon)
    if me == np.float32(-0.0):
        return np.float32(0.0)
    return me


# ------------------------------------------------------------- windows ----

CANONICAL = ("canonical",)
FILTERED = ("filtered",)


@dataclass
class EntropyWindow:
    """GenomeWindow (entropy/mod.rs:37-557). Stranded or combined."""

    combine: bool
    # stranded: per-strand sorted [(base, genome_pos)]; combined:
    # neg(base,pos) -> pos(base,pos) mapping
    pos_positions: list | None = None
    neg_positions: list | None = None
    neg_to_pos: dict | None = None
    pos_patterns: list = field(default_factory=list)
    neg_patterns: list = field(default_factory=list)
    pos_cov: np.ndarray | None = None
    neg_cov: np.ndarray | None = None

    def __post_init__(self):
        n = self.size()
        if self.combine or self.pos_positions is not None:
            self.pos_cov = np.zeros(n, dtype=np.int32)
        if not self.combine and self.neg_positions is not None:
            self.neg_cov = np.zeros(n, dtype=np.int32)

    def size(self) -> int:
        if self.combine:
            return len(self.neg_to_pos)
        if self.pos_positions is not None:
            return len(self.pos_positions)
        return len(self.neg_positions)

    def interval(self, strand: str):
        """(start, end) of min/max positions for the strand, or None
        (memoized: computed once per window, queried per read)."""
        cache = getattr(self, "_iv_cache", None)
        if cache is None:
            cache = self._iv_cache = {}
        if strand in cache:
            return cache[strand]
        cache[strand] = iv = self._interval(strand)
        return iv

    def _interval(self, strand: str):
        if self.combine:
            ps = [p for (_, p) in self.neg_to_pos] + [
                p for (_, p) in self.neg_to_pos.values()
            ]
            return (min(ps), max(ps))
        positions = (
            self.pos_positions if strand == "+" else self.neg_positions
        )
        if positions is None:
            return None
        ps = [p for (_, p) in positions]
        if len(ps) == 1:
            return (ps[0], ps[0] + 1)
        return (min(ps), max(ps))

    def leftmost(self) -> int:
        vals = [
            iv[0]
            for iv in (self.interval("+"), self.interval("-"))
            if iv is not None
        ]
        return min(vals)

    def rightmost(self) -> int:
        vals = [
            iv[1]
            for iv in (self.interval("+"), self.interval("-"))
            if iv is not None
        ]
        return max(vals)

    def add_read(
        self,
        mod_calls: dict,
        ref_start: int,
        ref_end: int,
        strand: str,
        max_filtered: int,
    ):
        """entropy/mod.rs:219-329 add_read_to_patterns."""
        if ref_start < 0 or ref_end <= ref_start:
            return
        iv = self.interval(strand) if not self.combine else self.interval("+")
        if self.combine:
            iv = self.interval("+")  # combined interval covers both
        if iv is None:
            return
        if not (ref_start <= iv[0] and ref_end >= iv[1]):
            return
        if self.combine:
            if strand == "+":
                keys = sorted(
                    self.neg_to_pos.values(), key=lambda bp: bp[1]
                )
                pattern = [mod_calls.get(k, FILTERED) for k in keys]
            else:
                items = sorted(
                    self.neg_to_pos.items(), key=lambda kv: kv[1][1]
                )
                pattern = [mod_calls.get(nk, FILTERED) for nk, _pk in items]
        else:
            positions = (
                self.pos_positions if strand == "+" else self.neg_positions
            )
            if positions is None:
                return
            pattern = [mod_calls.get(k, FILTERED) for k in positions]
        if sum(1 for c in pattern if c[0] == "filtered") > max_filtered:
            return
        cov = self.pos_cov if (self.combine or strand == "+") else self.neg_cov
        for i, c in enumerate(pattern):
            if c[0] != "filtered":
                cov[i] += 1
        if self.combine or strand == "+":
            self.pos_patterns.append(pattern)
        else:
            self.neg_patterns.append(pattern)

    def _encode(self, patterns, coverages, min_coverage, code_to_char):
        if not (coverages >= min_coverage).all():
            if (coverages == 0).all():
                return "zero-coverage"
            return "insufficient-coverage"
        out = []
        for pat in patterns:
            chars = []
            for c in pat:
                if c[0] == "canonical":
                    chars.append("0")
                elif c[0] == "mod":
                    chars.append(code_to_char[c[2]])
                else:
                    chars.append("*")
            out.append("".join(chars))
        return out

    def into_entropy(self, min_coverage: int):
        """-> [(strand, start, end, result)] where result is either a
        (me_entropy, num_reads) tuple or an error string
        (entropy/mod.rs:434-544)."""
        nat = getattr(self, "_native_res", None)
        if nat is not None:
            # results computed by the native batch engine (mk_entropy_*)
            ps, pme, pnr, ms, mme, mnr = nat

            def res_of(status, me, nr):
                if status == 1:
                    return "zero-coverage"
                if status == 2:
                    return "insufficient-coverage"
                return (me, nr)

            out = []
            if self.combine or self.pos_positions is not None:
                iv = self.interval("+")
                out.append(("+", iv[0], iv[1], res_of(ps, pme, pnr)))
            if not self.combine and self.neg_positions is not None:
                iv = self.interval("-")
                out.append(("-", iv[0], iv[1], res_of(ms, mme, mnr)))
            return out
        window_size = self.size()
        constant = 1.0 / window_size
        codes = sorted(
            {
                c[2]
                for pats in (self.pos_patterns, self.neg_patterns)
                for pat in pats
                for c in pat
                if c[0] == "mod"
            },
            key=mod_code_sort_key,
        )
        code_to_char = {c: str(i + 1) for i, c in enumerate(codes)}
        out = []
        if self.combine or self.pos_positions is not None:
            iv = self.interval("+")
            enc = self._encode(
                self.pos_patterns, self.pos_cov, min_coverage, code_to_char
            )
            if isinstance(enc, str):
                res = enc
            else:
                res = (
                    calc_me_entropy(enc, window_size, constant),
                    len(enc),
                )
            out.append(("+", iv[0], iv[1], res))
        if not self.combine and self.neg_positions is not None:
            iv = self.interval("-")
            enc = self._encode(
                self.neg_patterns, self.neg_cov, min_coverage, code_to_char
            )
            if isinstance(enc, str):
                res = enc
            else:
                res = (
                    calc_me_entropy(enc, window_size, constant),
                    len(enc),
                )
            out.append(("-", iv[0], iv[1], res))
        return out


def sliding_windows(
    seq: np.ndarray,
    contig_start: int,
    motifs: list[Motif],
    combine_strands: bool,
    num_positions: int,
    window_size: int,
):
    """Yield EntropyWindows over one contig/region subsequence
    (entropy/mod.rs:1054-1181 next_window).

    Motif hits precompute ONCE per contig (the per-window 50 bp rescans
    were an entropy hot spot); each window slices the sorted hit list
    with bisect. Per-window membership matches the original rescan
    exactly: focus in [curr, end) AND the motif fits before ``end`` (a
    motif straddling the window end was not matched by the sub-sequence
    scan)."""
    from bisect import bisect_left

    all_hits = []  # (focus_contig_pos, neg_position, strand, base, fit_end)
    for motif in motifs:
        for pos, strand in motif.find_hits(seq):
            genome_pos = pos + contig_start
            base = chr(seq[pos])
            if strand == STRAND_NEG:
                base = _COMPLEMENT[base]
                motif_start = pos - motif.reverse_offset
            else:
                motif_start = pos - motif.forward_offset
            neg_position = None
            if strand == STRAND_POS:
                neg_position = motif.negative_strand_position(genome_pos)
            all_hits.append(
                (
                    genome_pos, neg_position, strand, base,
                    motif_start + motif.length,
                )
            )
    all_hits.sort(key=lambda h: h[0])
    hit_keys = [h[0] - contig_start for h in all_hits]

    n_hits = len(all_hits)

    def find_hits_from(curr: int):
        """First ``num_positions`` filtered hits per strand from curr —
        _enough_hits never looks past hits[:num_positions], and the
        failure-advance needs only the first two filtered hit positions,
        so the scan stops early instead of materializing every hit in the
        window (dense-motif windows held ~75 tuples of which 4 were
        used)."""
        end = min(curr + window_size, len(seq))
        pos_hits, neg_hits = [], []
        first_keys = []
        i = bisect_left(hit_keys, curr)
        want = num_positions
        while i < n_hits and hit_keys[i] < end:
            h = all_hits[i]
            i += 1
            if h[4] > end:  # motif straddles the window scan range
                continue
            if len(first_keys) < 2 and (
                not first_keys or first_keys[-1] != hit_keys[i - 1]
            ):
                first_keys.append(hit_keys[i - 1])
            if h[2] == STRAND_POS:
                if len(pos_hits) < want:
                    pos_hits.append(h[:4])
            elif not combine_strands and len(neg_hits) < want:
                neg_hits.append(h[:4])
            if len(pos_hits) >= want and (
                combine_strands or len(neg_hits) >= want
            ):
                if len(first_keys) >= 2 or i >= n_hits:
                    break
        return pos_hits, neg_hits, end, first_keys

    curr = _find_start_position(seq, motifs)
    if curr is None:
        return
    while curr < len(seq):
        pos_hits, neg_hits, end, first_keys = find_hits_from(curr)
        window = _enough_hits(
            pos_hits, neg_hits, combine_strands, num_positions
        )
        if window is not None:
            yield window
            curr = (window.leftmost() + 1) - contig_start
        else:
            if first_keys:
                if curr == first_keys[0]:
                    curr = (
                        first_keys[1] if len(first_keys) > 1 else end
                    )
                else:
                    curr = first_keys[0]
            else:
                curr = end


_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def _find_start_position(seq: np.ndarray, motifs: list[Motif]):
    hits = [
        hit[0]
        for motif in motifs
        for hit in motif.find_hits(seq)[:1]
    ]
    return min(hits) if hits else None


def _enough_hits(
    pos_hits, neg_hits, combine_strands: bool, num_positions: int
) -> EntropyWindow | None:
    """entropy/mod.rs:936-1052 enough_hits_for_window."""
    if combine_strands:
        neg_to_pos = {}
        for genome_pos, neg_position, _strand, base in pos_hits[
            :num_positions
        ]:
            if neg_position is not None:
                neg_to_pos[(base, neg_position)] = (base, genome_pos)
        if len(neg_to_pos) < num_positions:
            return None
        return EntropyWindow(combine=True, neg_to_pos=neg_to_pos)
    if len(pos_hits) < num_positions and len(neg_hits) < num_positions:
        return None

    def take(hits):
        positions = sorted(
            ((h[3], h[0]) for h in hits[:num_positions]),
            key=lambda bp: bp[1],
        )
        return positions if len(positions) == num_positions else None

    p = take(pos_hits)
    n = take(neg_hits)
    if p and n:
        left_p = min(x[1] for x in p)
        left_n = min(x[1] for x in n)
        if left_p < left_n:
            n = None
        elif left_n < left_p:
            p = None
    if p or n:
        return EntropyWindow(
            combine=False, pos_positions=p, neg_positions=n
        )
    return None


# ------------------------------------------------------------- reads ----


def read_mod_calls(rec, caller: ThresholdCaller):
    """Per-read (base, ref_pos) -> thresholded call map
    (entropy/mod.rs:1483-1572 process_bam_fp)."""
    from ..modtags import decode_record

    info = decode_record(rec)
    qf, rp = rec.aligned_pairs_forward()
    order = np.argsort(qf, kind="stable")
    qf_s, rp_s = qf[order], rp[order]
    strands = {st for _b, st, _g in info.iter_groups()}
    if len(strands) > 1:
        # parity with the reference, which also skips duplex reads here
        # (entropy/mod.rs:1535 debug!("duplex not yet supported"))
        from ..logging import get_logger

        get_logger().debug("duplex not yet supported")
        return None
    # union of codes per base across the read (PositionModCalls semantics)
    codes_per_base: dict[str, list] = {}
    for base, _strand, g in info.iter_groups():
        s = codes_per_base.setdefault(base, [])
        present_any = (g.probs >= 0).any(axis=0)
        for j, c in enumerate(g.codes):
            if present_any[j] and c not in s:
                s.append(c)
    for b in codes_per_base:
        codes_per_base[b] = sorted(codes_per_base[b], key=mod_code_sort_key)
    mod_calls = {}
    for base, _strand, g in info.iter_groups():
        union = codes_per_base.get(base, [])
        mod_calls.update(
            _group_calls(base, g, union, qf_s, rp_s, caller)
        )
    strand = "-" if rec.is_reverse else "+"
    return mod_calls, rec.pos, rec.reference_end(), strand


def _group_calls(base, g, union, qf_s, rp_s, caller):
    """Vectorized MultipleThresholdModCaller::call over one group's
    positions (the scalar caller.call per position was the entropy hot
    loop: ~10 us/call x 2 M calls). Candidate/tie ordering matches the
    scalar path exactly: explicit rows offer the group's present codes in
    group order then union leftovers at 0.0; inferred rows offer the
    union at 0.0 (all inferred rows of a base share one call)."""
    positions, probs, inferred = g.positions, g.probs, g.inferred
    n, m = probs.shape
    out = {}
    if n == 0:
        return out
    # sorted-array intersection instead of a per-read 5k-entry dict
    idx = np.searchsorted(qf_s, positions)
    inb = idx < len(qf_s)
    idxc = np.clip(idx, 0, max(len(qf_s) - 1, 0))
    aligned = inb & (qf_s[idxc] == positions)
    ref_pos = np.where(aligned, rp_s[idxc], -1)
    # one shared scalar call covers every inferred row of the base
    inf_rows = inferred & aligned
    if inf_rows.any():
        call0 = caller.call(
            base, {c: np.float32(0.0) for c in union}
        )
        for rp in ref_pos[inf_rows].tolist():
            out[(base, rp)] = call0
    exp_rows = (~inferred) & aligned
    if not exp_rows.any():
        return out
    present = probs >= 0
    if not bool(present[exp_rows].all()):
        # rare multi-subtag rows with absent classes: scalar fallback
        # preserves the per-row candidate dict order
        for i in np.flatnonzero(exp_rows).tolist():
            pd = {}
            for j, c in enumerate(g.codes):
                if probs[i, j] >= 0:
                    pd[c] = np.float32(probs[i, j])
            for c in union:
                if c not in pd:
                    pd[c] = np.float32(0.0)
            out[(base, int(ref_pos[i]))] = caller.call(base, pd)
        return out
    rows = np.flatnonzero(exp_rows)
    pv = probs[rows]  # [k, m] all present
    cols = list(g.codes) + [c for c in union if c not in g.codes]
    thr = np.asarray(
        [caller.mod_threshold(c, base) for c in cols], dtype=np.float32
    )
    vals = (
        np.concatenate(
            [pv, np.zeros((len(rows), len(cols) - m), np.float32)], axis=1
        )
        if len(cols) > m
        else pv
    )
    canon = np.float32(1.0) - pv.sum(axis=1, dtype=np.float32)
    best = np.full(len(rows), -np.inf, dtype=np.float32)
    best_j = np.zeros(len(rows), dtype=np.int64)
    any_mod = np.zeros(len(rows), dtype=bool)
    for j in range(len(cols)):
        pass_j = vals[:, j] >= thr[j]
        mp = np.where(pass_j, vals[:, j], -np.inf)
        take = pass_j & (mp >= best)  # later candidate wins ties
        best = np.where(take, mp, best)
        best_j = np.where(take, j, best_j)
        any_mod |= pass_j
    pass_can = canon >= np.float32(caller.canonical_threshold(base))
    choose_can = pass_can & ((~any_mod) | (canon >= best))
    rp_l = ref_pos[rows].tolist()
    cc_l = choose_can.tolist()
    am_l = any_mod.tolist()
    cn_l = canon.tolist()
    bp_l = best.tolist()
    bj_l = best_j.tolist()
    for k in range(len(rows)):
        if cc_l[k]:
            out[(base, rp_l[k])] = ("canonical", cn_l[k])
        elif am_l[k]:
            out[(base, rp_l[k])] = ("mod", bp_l[k], cols[bj_l[k]])
        else:
            out[(base, rp_l[k])] = ("filtered",)
    return out


# --------------------------------------------------------------- driver ----


def _parse_bed3_regions(path: str):
    """BedRegion::parse_str (entropy/mod.rs:1626-1666)."""
    out = []
    for line in open(path):
        line = line.rstrip("\n")
        if not line.strip():
            continue
        parts = line.split("\t")
        if len(parts) < 3:
            raise SystemExit(f"failed to parse {line!r} into BED3 line")
        chrom, start, stop = parts[0], int(parts[1]), int(parts[2])
        if stop <= start:
            raise SystemExit("end must be after start")
        name = parts[3] if len(parts) > 3 else f"{chrom}:{start}-{stop}"
        out.append((chrom, start, stop, name))
    return out


def run_entropy(args) -> int:
    import os

    from ..logging import get_logger
    from ..motifs import parse_motifs

    log = get_logger()
    from .dmr import SampleIndex  # noqa: F401  (unused; CLI symmetry)

    if args.num_positions < 1:
        raise SystemExit("num-positions must be at least 1")
    if args.min_coverage < 1:
        raise SystemExit("min-valid-coverage must be at least 1")

    # motif configuration (subcommand.rs:237-293)
    if args.cpg:
        motifs = parse_motifs(["CG", "0"])
        combine_strands = True
    elif args.motif or args.base:
        raw = list(args.motif or [])
        motifs = parse_motifs(raw) if raw else []
        if args.base:
            if args.combine_strands:
                raise SystemExit(
                    "cannot combine strands with single base modifications"
                )
            motifs += parse_motifs(
                [x for b in args.base for x in (b, "0")]
            )
        if args.combine_strands and not all(m.is_palindrome for m in motifs):
            raise SystemExit("motifs must be palindromic to combine strands")
        combine_strands = args.combine_strands
    else:
        raise SystemExit(
            "invalid input options, must provide --motif, --base, or "
            "specify --cpg"
        )

    # --io-threads: BGZF inflate workers per BAM (the reference's htslib
    # tpool, entropy/subcommand.rs io_threads)
    from ..io.cram import open_alignment_reader

    readers = [
        open_alignment_reader(p, args.ref, io_threads=args.io_threads)
        for p in args.in_bam
    ]
    header = readers[0].header
    fasta = FastaReader(args.ref)
    fasta_names = set(fasta.names())

    # threshold caller
    if args.no_filtering:
        caller = ThresholdCaller.passthrough()
    elif args.filter_threshold is not None:
        from ..cli import parse_mod_thresholds

        per_mod = parse_mod_thresholds(args.mod_thresholds)
        caller = ThresholdCaller({}, per_mod or {}, args.filter_threshold)
    else:
        from ..cli import parse_mod_thresholds
        from ..thresholds import estimate_thresholds

        per_mod = parse_mod_thresholds(args.mod_thresholds)
        num_reads = args.num_reads // len(readers)
        all_probs: dict[str, list] = {}
        from ..thresholds import sample_reads, confidences_per_base

        agg: dict = {}
        for reader in readers:
            sampled = sample_reads(reader, num_reads, None, None, False, None)
            for b, arr in confidences_per_base(sampled).items():
                agg.setdefault(b, []).append(arr)
        per_base = {}
        from ..modcodes import DNA_BASES

        for b, arrs in agg.items():
            probs = np.sort(np.concatenate(arrs))
            per_base[DNA_BASES[b] if isinstance(b, (int, np.integer)) else b] = float(
                percentile_linear_interp(probs, args.filter_percentile)
            )
        print(
            "calculated thresholds: "
            + " ".join(f"{b}: {t}" for b, t in per_base.items()),
            file=sys.stderr,
        )
        caller = ThresholdCaller(per_base, per_mod or {}, 0.0)

    max_filtered = (
        args.max_filtered_positions
        if args.max_filtered_positions is not None
        else int(args.num_positions * 0.5)
    )

    # multi-host: genome-window mode only — each process owns window
    # batches round-robin, writes a sentinel-framed shard, and rank 0
    # interleaves them back (same machinery as the pileup shard path,
    # parallel/devices.py; BASELINE.json config 5 "multi-host entropy")
    from ..parallel.devices import (
        maybe_init_distributed, process_info, shard_path,
    )

    maybe_init_distributed()
    pidx, pcount = process_info()
    shard_mode = pcount > 1
    if shard_mode and args.out_bed is None:
        raise SystemExit(
            "multi-host entropy requires an --out-bed output path"
        )

    # output writers
    windows_header = "chrom\tstart\tend\tentropy\tstrand\tnum_reads\n"
    regions_header = (
        "chrom\tstart\tend\tregion_name\tmean_entropy\tstrand\t"
        "median_entropy\tmin_entropy\tmax_entropy\tmean_num_reads\t"
        "min_num_reads\tmax_num_reads\tsuccessful_window_count\t"
        "failed_window_count\n"
    )
    regions_out = None
    regions_paths = None
    if args.regions is not None:
        if args.out_bed is None:
            raise SystemExit("must provide output directory with regions")
        os.makedirs(args.out_bed, exist_ok=True)
        prefix = f"{args.prefix}_" if args.prefix else ""
        # multi-host --regions: each rank owns regions round-robin and
        # writes shard files of BOTH outputs; rank 0 interleaves after the
        # barrier (same sentinel machinery as the pileup shard path)
        wpath = os.path.join(args.out_bed, f"{prefix}windows.bedgraph")
        rpath = os.path.join(args.out_bed, f"{prefix}regions.bed")
        regions_paths = (wpath, rpath)
        windows_out = open(
            shard_path(wpath, pidx) if shard_mode else wpath, "w"
        )
        regions_out = open(
            shard_path(rpath, pidx) if shard_mode else rpath, "w"
        )
        if args.header and (not shard_mode or pidx == 0):
            windows_out.write(windows_header)
            regions_out.write(regions_header)
    elif args.out_bed is not None:
        path = shard_path(args.out_bed, pidx) if shard_mode else args.out_bed
        windows_out = open(path, "w")
        # in shard mode only rank 0 writes the header (inside its first
        # tile block, i.e. at the top of the merged file)
        if args.header and (not shard_mode or pidx == 0):
            windows_out.write(windows_header)
    else:
        windows_out = sys.stdout
        if args.header:
            windows_out.write(windows_header)

    # work units: (tid, contig_start, seq, region_name)
    work = []
    if args.regions is not None:
        for chrom, start, stop, name in _parse_bed3_regions(args.regions):
            if chrom not in fasta_names or chrom not in header.name_to_tid:
                continue
            seq = fasta.fetch(chrom, start, stop)
            work.append((header.name_to_tid[chrom], start, seq, name))
    else:
        for tid, ref in enumerate(header.refs):
            if ref.name not in fasta_names:
                continue
            seq = fasta.fetch(ref.name)
            work.append((tid, 0, seq, None))

    def uppercase(seq):
        if args.mask:
            return seq
        lower = (seq >= ord("a")) & (seq <= ord("z"))
        return np.where(lower, seq - 32, seq).astype(np.uint8)

    n_written = n_failed = 0

    def write_window_rows(chrom, rows):
        nonlocal n_written, n_failed
        for strand, start, end, res in rows:
            if isinstance(res, str):
                n_failed += 1
                if args.verbose:
                    # --verbose-logging: debug-log each failed window with
                    # its reason (entropy/writers.rs:49-80)
                    log.debug("%s:%d-%d: %s", chrom, start, end, res)
                continue
            entropy, num_reads = res
            if args.drop_zeros and entropy == np.float32(0.0):
                continue
            windows_out.write(
                f"{chrom}\t{start}\t{end}\t{format_float(entropy)}\t"
                f"{strand}\t{num_reads}\n"
            )
            n_written += 1

    batch_span = int(
        os.environ.get(
            "MODKIT_TPU_ENTROPY_BATCH_SPAN",
            max(100_000, 4 * args.window_size),
        )
    )
    # MODKIT_TPU_ENTROPY_BASELINE=1: the reference's scan architecture as
    # the CPU baseline proxy (BASELINE.md) — window batches of
    # floor(threads * 1.5) (entropy/subcommand.rs:295) fetched+decoded
    # independently, and every read offered to every window of the batch
    # (entropy/mod.rs:1604 par_iter_mut add_read_to_patterns; no routing).
    # Decode/entropy primitives are shared with the production engine, so
    # this anchors the architecture, conservatively.
    baseline_shape = os.environ.get("MODKIT_TPU_ENTROPY_BASELINE") == "1"

    def iter_window_batches(windows_iter):
        """Group consecutive windows into fetch batches bounded by genomic
        span, so reads are fetched once per batch and routed only to the
        windows they can cover — instead of offering every read to every
        window of the contig (the reference also walks windows in interval
        batches, entropy/mod.rs:703 SlidingWindows)."""
        if baseline_shape:
            n_per = max(1, int((getattr(args, "threads", 1) or 1) * 1.5))
            batch = []
            for w in windows_iter:
                batch.append(w)
                if len(batch) >= n_per:
                    yield batch
                    batch = []
            if batch:
                yield batch
            return
        batch: list = []
        lo = hi = 0
        for w in windows_iter:
            wl, wr = w.leftmost(), w.rightmost()
            if batch and (
                max(hi, wr) - min(lo, wl) > batch_span
                or len(batch) >= 20000
            ):
                yield batch
                batch = []
            if not batch:
                lo, hi = wl, wr
            else:
                lo, hi = min(lo, wl), max(hi, wr)
            batch.append(w)
        if batch:
            yield batch

    def _native_process_batch(tid, windows) -> bool:
        """Whole-batch native path (mk_entropy_*): BGZF inflate + decode +
        per-position threshold calls + pattern assembly + entropy in C++.
        Results land on each window as ``_native_res`` for into_entropy."""
        if os.environ.get("MODKIT_TPU_DISABLE_NATIVE") == "1":
            return False
        if not all(hasattr(r, "bam_raw") for r in readers):
            return False
        from .. import native

        nb = native.EntropyBatch.create(
            windows, combine_strands, args.num_positions, max_filtered,
            caller, route_all=baseline_shape,
        )
        if nb is None:
            return False
        try:
            lo = min(w.leftmost() for w in windows)
            hi = max(w.rightmost() for w in windows)
            for reader in readers:
                nb.add(
                    reader.bam_raw,
                    reader.fetch_chunk_voffsets(tid, lo, hi),
                    tid, lo, hi, n_threads=1,
                )
            ps, pm, pn, ms, mm, mn = nb.finish(args.min_coverage)
        finally:
            nb.close()
        for i, w in enumerate(windows):
            w._native_res = (
                int(ps[i]), np.float32(pm[i]), int(pn[i]),
                int(ms[i]), np.float32(mm[i]), int(mn[i]),
            )
        return True

    def process_batch(tid, windows):
        """Fetch reads covering the batch span; add each to the windows it
        fully covers. A window is eligible only when the read covers its
        whole interval (entropy/mod.rs:219 add_read_to_patterns), so its
        leftmost must sit in [ref_start, ref_end] — bisect on sorted
        leftmosts; add_read re-checks the exact cover condition."""
        from bisect import bisect_left, bisect_right

        if _native_process_batch(tid, windows):
            return

        order = sorted(
            range(len(windows)), key=lambda i: windows[i].leftmost()
        )
        lefts = [windows[i].leftmost() for i in order]
        lo = lefts[0]
        hi = max(w.rightmost() for w in windows)
        for reader in readers:
            for rec in reader.fetch(tid, lo, hi):
                if rec.is_unmapped or rec.is_not_primary or rec.l_seq == 0:
                    continue
                try:
                    got = read_mod_calls(rec, caller)
                except Exception:
                    continue
                if got is None:
                    continue
                mod_calls, ref_start, ref_end, strand = got
                for k in range(
                    bisect_left(lefts, ref_start),
                    bisect_right(lefts, ref_end),
                ):
                    windows[order[k]].add_read(
                        mod_calls, ref_start, ref_end, strand, max_filtered
                    )

    # genome-window batches are independent: -t workers fetch + pattern-
    # count concurrently (the reference's thread pool over window batches,
    # entropy/subcommand.rs threads); the writer drains in submit order so
    # output stays genome-ordered. BamReader.fetch is stateless over the
    # in-memory BGZF bytes, so the readers are shared across workers.
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    n_workers = max(
        1, min(getattr(args, "threads", 1) or 1, os.cpu_count() or 1)
    )
    pool = ThreadPoolExecutor(n_workers) if n_workers > 1 else None
    inflight: deque = deque()

    def run_batch(tid, windows):
        process_batch(tid, windows)
        return [w.into_entropy(args.min_coverage) for w in windows]

    def drain_one():
        chrom_, fut = inflight.popleft()
        for rows in fut.result():
            write_window_rows(chrom_, rows)
        if shard_mode:
            windows_out.write("\x00TILE\x00")

    batch_idx = 0
    for tid, contig_start, raw_seq, region_name in work:
        seq = uppercase(raw_seq)
        chrom = header.tid2name(tid)
        win_iter = sliding_windows(
            seq,
            contig_start,
            motifs,
            combine_strands,
            args.num_positions,
            args.window_size,
        )
        if region_name is None:
            # genome-window mode: stream batches (multi-host: round-robin
            # batch ownership, sentinel per owned batch)
            for windows in iter_window_batches(win_iter):
                owned = not shard_mode or batch_idx % pcount == pidx
                batch_idx += 1
                if not owned:
                    continue
                if pool is None:
                    process_batch(tid, windows)
                    for w in windows:
                        write_window_rows(
                            chrom, w.into_entropy(args.min_coverage)
                        )
                    if shard_mode:
                        windows_out.write("\x00TILE\x00")
                else:
                    inflight.append(
                        (chrom, pool.submit(run_batch, tid, windows))
                    )
                    if len(inflight) > 2 * n_workers:
                        drain_one()
            continue
        # region mode: round-robin region ownership across ranks
        owned = not shard_mode or batch_idx % pcount == pidx
        batch_idx += 1
        if not owned:
            continue
        windows = list(win_iter)
        if not windows:
            if shard_mode:
                windows_out.write("\x00TILE\x00")
                regions_out.write("\x00TILE\x00")
            continue
        process_batch(tid, windows)
        per_window = [w.into_entropy(args.min_coverage) for w in windows]
        if region_name is not None:
            # region descriptive stats (entropy/mod.rs:603-692)
            pos_es, pos_nr, pos_fails = [], [], 0
            neg_es, neg_nr, neg_fails = [], [], 0
            for rows in per_window:
                for strand, _s, _e, res in rows:
                    if strand == "+":
                        if isinstance(res, str):
                            pos_fails += 1
                        else:
                            pos_es.append(res[0])
                            pos_nr.append(res[1])
                    else:
                        if isinstance(res, str):
                            neg_fails += 1
                        else:
                            neg_es.append(res[0])
                            neg_nr.append(res[1])
            interval = (
                min(w.leftmost() for w in windows),
                max(w.rightmost() for w in windows),
            )

            def stats_row(es, nr, fails, strand):
                nonlocal n_written, n_failed
                if not es:
                    n_failed += 1
                    return
                try:
                    median = percentile_linear_interp(
                        np.array(es, dtype=np.float32), 0.5
                    )
                except Exception:
                    n_failed += 1
                    return
                mean_e = np.float32(sum(np.float32(x) for x in es)) / np.float32(len(es))
                mean_nr = np.float32(sum(nr)) / np.float32(len(nr))
                regions_out.write(
                    f"{chrom}\t{interval[0]}\t{interval[1]}\t{region_name}\t"
                    f"{format_float(mean_e)}\t{strand}\t"
                    f"{format_float(median)}\t{format_float(min(es))}\t"
                    f"{format_float(max(es))}\t{format_float(mean_nr)}\t"
                    f"{min(nr)}\t{max(nr)}\t{len(es)}\t{fails}\n"
                )
                n_written += 1

            stats_row(pos_es, pos_nr, pos_fails, "+")
            if neg_es or neg_fails:
                stats_row(neg_es, neg_nr, neg_fails, "-")
            for rows in per_window:
                write_window_rows(chrom, rows)
            if shard_mode:
                windows_out.write("\x00TILE\x00")
                regions_out.write("\x00TILE\x00")

    while inflight:
        drain_one()
    if pool is not None:
        pool.shutdown(wait=False)

    if windows_out is not sys.stdout:
        windows_out.close()
    if regions_out is not None:
        regions_out.close()
    if shard_mode:
        # cross-host barrier, then rank 0 interleaves the shards back into
        # one genome-ordered bedgraph
        from ..parallel.devices import merge_shards, sync_processes

        sync_processes("modkit_entropy_shards")
        if pidx == 0:
            if regions_paths is not None:
                merge_shards(regions_paths[0], pcount)
                merge_shards(regions_paths[1], pcount)
            else:
                merge_shards(args.out_bed, pcount)
    print(
        f"finished, {n_written} rows written, {n_failed} windows failed",
        file=sys.stderr,
    )
    return 0
