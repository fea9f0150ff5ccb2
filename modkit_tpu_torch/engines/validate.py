"""`validate`: accuracy of mod calls against ground-truth BED files.

Reference equivalent: ``src/validate/subcommand.rs``. Pairs of (modBAM,
ground-truth BED) are scanned; each read's per-position argmax calls are
matched against ground-truth (position, strand) labels into a contingency
table of (ground truth status, called status) -> list of call
probabilities. Ground-truth rows are balanced to the smallest class via
stratified (linspace) downsampling, accuracy is reported raw and after
removing calls below the `--filter-quantile` threshold (minus the 1/512
tag-bin epsilon).
"""

from __future__ import annotations

import math
import sys

import numpy as np

from ..io.bam import BamReader
from ..modcodes import (
    MOD_CODE_TO_DNA_BASE,
    any_mod_code,
    complement,
    mod_code_sort_key,
    parse_mod_code,
)
from ..modtags import decode_record
from ..thresholds import percentile_linear_interp
from ..writers import format_float

# BaseStatus: ("canonical",) | ("mod", code) | ("nocall",) | ("mismatch", b)
# | ("deletion",)  -- ordered like the reference enum (Canonical < Modified
# < NoCall < Mismatch < Deletion; Modified by ModCodeRepr order)
_RANK = {"canonical": 0, "mod": 1, "nocall": 2, "mismatch": 3, "deletion": 4}


def status_sort_key(status):
    if status[0] == "mod":
        return (1,) + tuple(mod_code_sort_key(status[1]))
    if status[0] == "mismatch":
        return (3, status[1])
    return (_RANK[status[0]],)


def human_display(status, validate_base: str) -> str:
    kind = status[0]
    if kind == "canonical":
        return validate_base
    if kind == "mod":
        code = status[1]
        if code in ("A", "C", "G", "T"):
            return "*"
        return str(code)
    if kind == "nocall":
        return "No Call"
    if kind == "mismatch":
        return status[1]
    return "Deletion"


def parse_ground_truth_bed(path: str):
    """validate/subcommand.rs:126-215: chrom -> strand -> {pos: status}."""
    out: dict[str, dict[str, dict[int, tuple]]] = {}
    for line in open(path):
        fields = line.split()
        if len(fields) < 6:
            continue
        chrom, start, end = fields[0], int(fields[1]), int(fields[2])
        raw = fields[3]
        strand = fields[5][0]
        if strand not in "+-":
            continue
        if raw == "-":
            status = ("canonical",)
        else:
            try:
                status = ("mod", parse_mod_code(raw))
            except ValueError:
                continue
        per_strand = out.setdefault(chrom, {}).setdefault(strand, {})
        for pos in range(start, end):
            per_strand[pos] = status
    if not out:
        raise SystemExit("zero valid positions parsed from BED file")
    return out


def derive_canonical_base(gt_list, explicit: str | None) -> str:
    can = explicit
    for gt in gt_list:
        for strand_map in gt.values():
            for pos_map in strand_map.values():
                for status in pos_map.values():
                    if status[0] != "mod":
                        continue
                    base = MOD_CODE_TO_DNA_BASE.get(status[1])
                    if base is None:
                        continue
                    if can is None:
                        can = base
                    elif can != base:
                        raise SystemExit(
                            "Multiple canonical bases represented in ground "
                            f"truth BED files: {can} {base}"
                        )
    if can is None:
        raise SystemExit(
            "Could not derive canonical base from ground truth."
        )
    return can


def _read_identity_q(rec) -> float | None:
    """-10*log10(1e-5 + NM/aligned) (validate/subcommand.rs:419-439)."""
    got = rec.get_aux("NM")
    if got is None:
        return None
    nm = got[1]
    cig = rec.cigar
    ops, lens = cig & 0xF, cig >> 4
    # M=0 I=1 D=2 .. ==7 X=8
    num_paired = int(lens[(ops == 0) | (ops == 7) | (ops == 8)].sum())
    num_indel = int(lens[(ops == 1) | (ops == 2)].sum())
    num_aligned = float(num_paired + num_indel)
    return float(
        np.float32(-10.0)
        * np.log10(np.float32(1e-5) + np.float32(nm) / np.float32(num_aligned))
    )


def process_record(rec, header, gt, can_base, collapse=(), edge_filter=None):
    """validate/subcommand.rs:272-400 process_bam_record."""
    from .extract import ReadProfile

    chrom = header.tid2name(rec.ref_id)
    cgt = gt.get(chrom)
    if cgt is None:
        return None
    profile = ReadProfile(
        rec, header, collapse=collapse, edge_filter=edge_filter, kmer_size=1
    )
    # union-of-codes per base (PositionModCalls semantics, as in extract)
    codes_per_base: dict[str, list] = {}
    for _q, base, _s, codes, prob_row, _inf in profile.entries:
        s = codes_per_base.setdefault(base, [])
        for j, c in enumerate(codes):
            if prob_row[j] >= 0 and c not in s:
                s.append(c)
    for b in codes_per_base:
        codes_per_base[b] = sorted(codes_per_base[b], key=mod_code_sort_key)

    result: dict[tuple, list] = {}
    called_ref_pos: dict[str, set] = {}
    aln_strand = profile.aln_strand
    for qpos, base, mod_strand, codes, prob_row, inferred in profile.entries:
        ref_pos = profile.ref_map.get(qpos, -1)
        if ref_pos < 0 or aln_strand is None:
            continue
        # reference mod strand (util.rs:716-726)
        ms = "+" if mod_strand == 0 else "-"
        ref_strand = "+" if ms == aln_strand else "-"
        gt_status = cgt.get(ref_strand, {}).get(ref_pos)
        if gt_status is None:
            continue
        called_ref_pos.setdefault(ref_strand, set()).add(ref_pos)
        if base != can_base:
            result.setdefault(
                (gt_status, ("mismatch", base)), []
            ).append(float("nan"))
            continue
        union = codes_per_base.get(base, [])
        probs = {}
        if inferred:
            for c in union:
                probs[c] = np.float32(0.0)
        else:
            for j, c in enumerate(codes):
                if prob_row[j] >= 0:
                    probs[c] = np.float32(prob_row[j])
            for c in union:
                if c not in probs:
                    probs[c] = np.float32(0.0)
        canonical_p = np.float32(1.0) - np.float32(
            sum(np.float32(p) for p in probs.values())
        )
        best_code, best_p = None, None
        for c, p in probs.items():
            if best_p is None or p >= best_p:
                best_code, best_p = c, p
        if best_p is not None and best_p > canonical_p:
            call = ("mod", best_code)
            prob = float(best_p)
        else:
            call = ("canonical",)
            prob = float(canonical_p)
        result.setdefault((gt_status, call), []).append(prob)

    # fill nocall/mismatch/deletion for un-called gt positions covered by
    # the alignment, per strand seen in called_ref_pos
    r_st, r_en = rec.pos, rec.reference_end()
    qf, rp = rec.aligned_pairs()
    ref_to_query = dict(zip(rp.tolist(), qf.tolist()))
    seq = rec.seq_bytes()
    for strand, positions in called_ref_pos.items():
        pos_map = cgt.get(strand)
        if pos_map is None:
            continue
        for pos, gt_status in pos_map.items():
            if not (r_st <= pos < r_en) or pos in positions:
                continue
            qpos = ref_to_query.get(pos)
            if qpos is None:
                result.setdefault(
                    (gt_status, ("deletion",)), []
                ).append(float("nan"))
                continue
            base = chr(seq[qpos])
            if rec.is_reverse:
                base = complement(base)
            if base == can_base:
                result.setdefault(
                    (gt_status, ("nocall",)), []
                ).append(float("nan"))
            else:
                result.setdefault(
                    (gt_status, ("mismatch", base)), []
                ).append(float("nan"))
    return result


def machine_table(validate_base: str, status_probs: dict) -> str:
    gt_codes = sorted(
        {k[0] for k in status_probs}, key=status_sort_key
    )
    all_codes = sorted(
        {k[0] for k in status_probs} | {k[1] for k in status_probs},
        key=status_sort_key,
    )
    parts = [
        '[["ground_truth_label","'
        + '","'.join(human_display(c, validate_base) for c in all_codes)
        + '"]'
    ]
    for gt in gt_codes:
        row = ',["' + human_display(gt, validate_base) + '"'
        for call in all_codes:
            n = len(status_probs.get((gt, call), ()))
            row += f",{n}"
        row += "]"
        parts.append(row)
    return "".join(parts) + "]"


def balance_ground_truth(status_probs: dict) -> None:
    """validate/subcommand.rs:621-676: stratified downsample each gt row
    to the smallest row total."""
    gt_totals: dict = {}
    for (gt, _call), probs in status_probs.items():
        gt_totals[gt] = gt_totals.get(gt, 0) + len(probs)
    target = min(gt_totals.values())
    for key in list(status_probs):
        gt = key[0]
        gt_total = gt_totals[gt]
        if gt_total <= target:
            continue
        to_remove = gt_total - target
        probs = status_probs[key]
        n_obs = len(probs)
        ratio = np.float32(n_obs) / np.float32(gt_total)
        samp_target = n_obs - int(
            np.round(ratio * np.float32(to_remove))
        )
        idxs = np.linspace(0.0, n_obs - 1, samp_target + 2)[1:-1]
        keep = [
            probs[int(round(x))]
            for x in idxs
            if 0 <= int(round(x)) < n_obs
        ]
        status_probs[key] = keep


def _print_table(validate_base, status_probs, pct, title, out=sys.stderr):
    gt_codes = sorted({k[0] for k in status_probs}, key=status_sort_key)
    all_codes = sorted(
        {k[0] for k in status_probs} | {k[1] for k in status_probs},
        key=status_sort_key,
    )
    gt_totals: dict = {}
    for (gt, _c), probs in status_probs.items():
        gt_totals[gt] = gt_totals.get(gt, 0) + len(probs)
    print(title, file=out)
    print(
        "\t" + "\t".join(human_display(c, validate_base) for c in all_codes),
        file=out,
    )
    for gt in gt_codes:
        cells = []
        for call in all_codes:
            n = len(status_probs.get((gt, call), ()))
            if pct:
                cells.append(f"{100.0 * n / gt_totals[gt]:.2f}%")
            else:
                cells.append(str(n))
        print(
            human_display(gt, validate_base) + "\t" + "\t".join(cells),
            file=out,
        )


def run_validate(args) -> int:
    from ..collapse import CollapseMethod

    if len(args.bam_and_bed) % 2 != 0 or not args.bam_and_bed:
        raise SystemExit("--bam-and-bed takes pairs: <BAM> <BED>")
    pairs = [
        (args.bam_and_bed[i], args.bam_and_bed[i + 1])
        for i in range(0, len(args.bam_and_bed), 2)
    ]
    collapse = ()
    if args.ignore:
        collapse = (CollapseMethod("dist", (parse_mod_code(args.ignore),)),)
    edge_filter = None
    if args.edge_filter:
        from ..cli import parse_edge_filter

        edge_filter = parse_edge_filter(
            args.edge_filter, args.invert_edge_filter
        )

    bed_paths: list[str] = []
    bam_to_beds: dict[str, list[int]] = {}
    for bam, bed in pairs:
        if bed in bed_paths:
            idx = bed_paths.index(bed)
        else:
            bed_paths.append(bed)
            idx = len(bed_paths) - 1
        bam_to_beds.setdefault(bam, []).append(idx)
    gt_list = [parse_ground_truth_bed(p) for p in bed_paths]
    can_base = derive_canonical_base(gt_list, args.canonical_base)
    print(f"Canonical base: {can_base}", file=sys.stderr)

    min_q = args.min_identity if args.min_identity is not None else 0.0
    min_len = args.min_length if args.min_length is not None else 0

    all_probs: dict[tuple, list] = {}
    for bam, bed_idxs in bam_to_beds.items():
        for bed_idx in bed_idxs:
            from ..io.cram import open_alignment_reader

            reader = open_alignment_reader(bam)
            gt = gt_list[bed_idx]
            for rec in reader.records():
                if rec.is_unmapped or rec.is_not_primary:
                    continue
                q = _read_identity_q(rec)
                if q is None:
                    continue
                if q < min_q:
                    continue
                if rec.reference_end() - rec.pos < min_len:
                    continue
                try:
                    got = process_record(
                        rec, reader.header, gt, can_base, collapse,
                        edge_filter,
                    )
                except Exception:
                    continue
                if not got:
                    continue
                for key, probs in got.items():
                    all_probs.setdefault(key, []).extend(probs)

    # ascending sort; NaNs last (f32 to_bits key for non-negative values)
    for probs in all_probs.values():
        probs.sort(key=lambda x: math.inf if math.isnan(x) else x)

    out_fh = open(args.out_filepath, "w") if args.out_filepath else None
    _print_table(can_base, all_probs, False, "Raw counts summary")
    if out_fh:
        out_fh.write(
            f"full_contingency_table: {machine_table(can_base, all_probs)}\n"
        )

    all_probs = {
        k: v
        for k, v in all_probs.items()
        if k[1][0] in ("canonical", "mod")
    }
    balance_ground_truth(all_probs)
    _print_table(can_base, all_probs, False, "Balanced counts summary")
    total = sum(len(v) for v in all_probs.values())
    correct = sum(len(v) for k, v in all_probs.items() if k[0] == k[1])
    raw_acc = np.float32(100.0) * np.float32(correct) / np.float32(total)
    print(f"Raw accuracy: {float(raw_acc):.2f}%", file=sys.stderr)
    if out_fh:
        out_fh.write(f"raw_accuracy: {format_float(raw_acc)}\n")
        out_fh.write(
            f"raw_contingency_table: {machine_table(can_base, all_probs)}\n"
        )

    flat = np.sort(
        np.array(
            [p for v in all_probs.values() for p in v], dtype=np.float32
        )
    )
    if np.isnan(flat).any():
        raise SystemExit("Failed to compare values")
    if args.filter_threshold is not None:
        thresh = np.float32(args.filter_threshold)
    else:
        thresh = percentile_linear_interp(
            flat, args.filter_quantile
        ) - np.float32(1.0 / 512.0)
    print(f"Call probability threshold: {float(thresh):.4f}", file=sys.stderr)

    total_before = sum(len(v) for v in all_probs.values())
    for k in all_probs:
        all_probs[k] = [p for p in all_probs[k] if np.float32(p) > thresh]
    filt_calls = sum(len(v) for v in all_probs.values())
    pct_removed = 100.0 * (1.0 - (filt_calls / total_before))
    correct_filt = sum(
        len(v) for k, v in all_probs.items() if k[0] == k[1]
    )
    filt_acc = (
        np.float32(100.0) * np.float32(correct_filt) / np.float32(filt_calls)
    )
    print(f"Filtered accuracy: {float(filt_acc):.2f}%", file=sys.stderr)
    if out_fh:
        out_fh.write(f"filter_threshold: {format_float(thresh)}\n")
        out_fh.write(
            f"percent_of_mod_called_removed: "
            f"{format_float(pct_removed, f64=True)}\n"
        )
        out_fh.write(f"filtered_accuracy: {format_float(filt_acc)}\n")
        out_fh.write(
            "filtered_contingency_table: "
            f"{machine_table(can_base, all_probs)}\n"
        )
        out_fh.close()
    return 0
