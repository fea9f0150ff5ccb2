"""`pileup-hemi`: double-stranded (hemi-methylation) pattern pileup.

Reference equivalent: ``src/pileup/duplex.rs`` + ``src/read_cache.rs``
DuplexReadCache. For each positive-strand motif position, every primary
duplex read contributes a pattern pairing its positive-strand call at the
focus position with its negative-strand call at the motif's negative
partner position (e.g. ``m,m,C`` for 5mC on both strands of a CpG).
Patterns '-' denote canonical; rows carry the same 18-column bedMethyl
shape with pattern-specific counters.
"""

from __future__ import annotations

import sys

import numpy as np

from ..caller import ThresholdCaller
from ..collapse import apply_collapse
from ..errors import ModKitError
from ..io.bam import BamReader
from ..io.fasta import FastaReader
from ..modcodes import DNA_BASES, any_mod_code, complement, mod_code_sort_key
from ..modtags import DEFAULT_IMPLICIT, decode_record
from ..motifs import parse_motifs, scan_focus_positions_combine
from ..writers import format_float

CANONICAL = "-"


def _pattern_elem_key(e):
    """DuplexModCodeRepr Ord: Canonical < Code(char) < ChEbi(u32)."""
    if e == CANONICAL:
        return (0, "")
    if isinstance(e, int):
        return (2, e)
    return (1, e)


def read_duplex_calls(rec, caller, collapse=(), edge_filter=None,
                      force_allow=False):
    """{(mod_strand, group_base, ref_pos): call} per read
    (read_cache.rs:111-199 add_record; calls thresholded at insert)."""
    info = decode_record(rec)
    if info.is_empty():
        raise ModKitError("no-mod-info", "no modified base information")
    for g in info.groups.values():
        if g.skip_mode == DEFAULT_IMPLICIT and not force_allow:
            raise ModKitError("implicit-mode", "un-allowed implicit mode")
    qf, rp = rec.aligned_pairs_forward()
    ref_map = dict(zip(qf.tolist(), rp.tolist()))
    out = {}
    added = False
    for base, mod_strand, g in info.iter_groups():
        positions, probs, inferred = g.positions, g.probs, g.inferred
        codes = list(g.codes)
        if edge_filter is not None:
            if not edge_filter.read_can_be_trimmed(rec.l_seq):
                continue
            keep = edge_filter.keep_mask(positions, rec.l_seq)
            if not keep.any():
                continue
            positions, probs, inferred = (
                positions[keep], probs[keep], inferred[keep]
            )
        for mth in collapse:
            codes, probs = apply_collapse(codes, probs, mth)
        threshold_base = base if mod_strand == 0 else complement(base)
        for i in range(len(positions)):
            r_pos = ref_map.get(int(positions[i]), -1)
            if r_pos < 0:
                continue
            pr = {}
            for j, c in enumerate(codes):
                if probs[i, j] >= 0:
                    pr[c] = np.float32(probs[i, j])
            call = caller.call(threshold_base, pr)
            out[(mod_strand, base, r_pos)] = call
        added = True
    if not added:
        raise ModKitError("no-mod-info", "all positions removed")
    return out


def _duplex_call(calls, rec_reverse, read_base, pos, neg_pos):
    """DuplexReadCache::get_duplex_mod_call (read_cache.rs:423-463)."""
    if rec_reverse:
        pos_base, neg_base = complement(read_base), read_base
        pos_table, neg_table = 1, 0
    else:
        pos_base, neg_base = read_base, complement(read_base)
        pos_table, neg_table = 0, 1
    if neg_pos is None:
        return ("nocall", read_base)
    pos_call = calls.get((pos_table, pos_base, pos))
    neg_call = calls.get((neg_table, neg_base, neg_pos))
    if pos_call is None or neg_call is None:
        return ("nocall", read_base)
    if pos_call[0] == "filtered" or neg_call[0] == "filtered":
        return ("filtered", read_base)

    def elem(c):
        return CANONICAL if c[0] == "canonical" else c[2]

    return ("pattern", read_base, (elem(pos_call), elem(neg_call)))


def run_pileup_hemi(args) -> int:
    import os

    from ..cli import (
        parse_edge_filter,
        parse_filter_thresholds,
        parse_mod_thresholds,
    )
    from ..collapse import CollapseMethod
    from ..modcodes import parse_mod_code
    from ..pileup.runner import parse_region

    from ..io.cram import open_alignment_reader

    reader = open_alignment_reader(args.in_bam, args.ref)
    header = reader.header
    fasta = FastaReader(args.ref)

    if args.cpg:
        motifs = parse_motifs(["CG", "0"])
    elif args.motif:
        motifs = parse_motifs(list(args.motif))
    else:
        raise SystemExit("must provide either --cpg or --motif")
    for m in motifs:
        if not m.is_palindrome:
            raise SystemExit(
                "motif must be reverse-complement palindromic"
            )

    collapse = []
    if getattr(args, "ignore", None):
        collapse.append(
            CollapseMethod("dist", (parse_mod_code(args.ignore),))
        )
    combine_mods = bool(getattr(args, "combine_mods", False))
    edge_filter = None
    if getattr(args, "edge_filter", None):
        edge_filter = parse_edge_filter(
            args.edge_filter, args.invert_edge_filter
        )

    # threshold resolution (pileup/subcommand.rs threshold phase)
    if args.no_filtering:
        caller = ThresholdCaller.passthrough()
    else:
        per_mod = parse_mod_thresholds(args.mod_thresholds) or {}
        ft = parse_filter_thresholds(args.filter_threshold)
        if ft is not None:
            default = ft.pop("default", 0.0)
            caller = ThresholdCaller(ft, per_mod, default)
        else:
            from ..thresholds import estimate_thresholds

            per_base = estimate_thresholds(
                reader,
                num_reads=args.num_reads,
                sample_frac=None,
                seed=args.seed,
                include_unmapped=False,
                filter_percentile=args.filter_percentile,
                region=getattr(args, "sample_region", None) or args.region,
                collapse=collapse,
                edge_filter=edge_filter,
            )
            print(
                "calculated thresholds: "
                + " ".join(f"{b}: {t}" for b, t in per_base.items()),
                file=sys.stderr,
            )
            caller = ThresholdCaller(per_base, per_mod, 0.0)

    if args.region:
        tid, start, end = parse_region(args.region, header)
        tiles = [(tid, start, end)]
    else:
        tiles = [(tid, 0, r.length) for tid, r in enumerate(header.refs)]

    out = (
        open(args.out_bed, "w") if args.out_bed is not None else sys.stdout
    )
    space = " " if args.mixed_delim else "\t"
    n_rows = 0
    for tid, start, end in tiles:
        chrom = header.tid2name(tid)
        if chrom not in set(fasta.names()):
            continue
        ref_len = header.refs[tid].length
        for lo in range(start, end, args.interval_size):
            hi = min(lo + args.interval_size, end)
            focus, _ = scan_focus_positions_combine(
                motifs, fasta, chrom, tid, ref_len, lo, hi
            )
            positive_motifs = focus.positive_motifs
            if not positive_motifs:
                continue
            # collect reads overlapping the tile
            per_read = []
            skip = set()
            for rec in reader.fetch(tid, lo, hi):
                if rec.is_not_primary or rec.l_seq == 0:
                    continue
                try:
                    calls = read_duplex_calls(
                        rec, caller, collapse, edge_filter,
                        args.force_allow_implicit,
                    )
                except ModKitError:
                    skip.add(rec.name)
                    continue
                qa, ra = rec.aligned_pairs()
                seq = rec.seq_bytes()
                aligned_base = dict(
                    zip(ra.tolist(), seq[qa].tolist())
                )
                dels = set(rec.deletion_ref_positions().tolist())
                from ..pileup.events import covered_intervals

                cov = covered_intervals(rec)
                per_read.append(
                    (rec.is_reverse, calls, aligned_base, dels, cov)
                )
            for pos in sorted(positive_motifs):
                if not (lo <= pos < hi):
                    continue
                motif, _mid = positive_motifs[pos][0]
                neg_pos = motif.negative_strand_position(pos)
                counts: dict = {}
                n_delete = 0
                for is_rev, calls, aligned_base, dels, cov in per_read:
                    covering = ((cov[:, 0] <= pos) & (cov[:, 1] > pos)).any()
                    if not covering:
                        continue
                    if pos in dels:
                        n_delete += 1
                        continue
                    b = aligned_base.get(pos)
                    if b is None:
                        continue
                    read_base = chr(b)
                    if read_base not in DNA_BASES:
                        continue
                    dc = _duplex_call(
                        calls, is_rev, read_base, pos, neg_pos
                    )
                    if combine_mods and dc[0] == "pattern":
                        p0, p1 = dc[2]
                        if (p0, p1) != (CANONICAL, CANONICAL):
                            amc = any_mod_code(read_base)
                            p0 = CANONICAL if p0 == CANONICAL else amc
                            p1 = CANONICAL if p1 == CANONICAL else amc
                            dc = ("pattern", read_base, (p0, p1))
                    counts[dc] = counts.get(dc, 0) + 1
                if not counts:
                    continue
                # decode (pileup/duplex.rs:121-204)
                by_base: dict = {}
                for dc, c in counts.items():
                    by_base.setdefault(dc[1], []).append((dc, c))
                for base in sorted(by_base):
                    calls_for_base = by_base[base]
                    patterns = {
                        dc[2]: c
                        for dc, c in calls_for_base
                        if dc[0] == "pattern"
                    }
                    n_diff = sum(
                        c
                        for ob, cs in by_base.items()
                        if ob != base
                        for dc, c in cs
                        if dc[0] == "pattern"
                    )
                    n_canonical = sum(
                        c
                        for dc, c in calls_for_base
                        if dc[0] == "pattern"
                        and dc[2] == (CANONICAL, CANONICAL)
                    )
                    n_fail = sum(
                        c for dc, c in calls_for_base if dc[0] == "filtered"
                    )
                    n_nocall = sum(
                        c for dc, c in calls_for_base if dc[0] == "nocall"
                    )
                    for pattern in sorted(
                        patterns,
                        key=lambda p: (
                            _pattern_elem_key(p[0]),
                            _pattern_elem_key(p[1]),
                        ),
                    ):
                        count = patterns[pattern]
                        n_other = sum(
                            c
                            for p, c in patterns.items()
                            if p != pattern
                        )
                        valid = count + n_other
                        pct = (
                            np.float32(count)
                            / np.float32(valid)
                            * np.float32(100.0)
                        )
                        name = f"{pattern[0]},{pattern[1]},{base}"
                        out.write(
                            f"{chrom}\t{pos}\t{pos + 1}\t{name}\t{valid}\t"
                            f".\t{pos}\t{pos + 1}\t255,0,0\t{valid}{space}"
                            f"{format(float(pct), '.2f')}{space}"
                            f"{count}{space}{n_canonical}{space}"
                            f"{n_other}{space}{n_delete}{space}"
                            f"{n_fail}{space}{n_diff}{space}{n_nocall}\n"
                        )
                        n_rows += 1
    if out is not sys.stdout:
        out.close()
    print(f"finished, wrote {n_rows} rows", file=sys.stderr)
    return 0
