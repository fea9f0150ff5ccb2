"""modBAM -> modBAM rewriters: adjust-mods, call-mods, update-tags.

Reference: src/adjust.rs (adjust_mod_probs :115, adjust_modbam :211) and
commands.rs:1239 update_mod_tags. Streaming rewrite: per record decode,
transform (edge filter -> collapse/convert -> threshold call/filter ->
motif keep/discard), re-encode MM/ML. Records whose tags fail to decode are
counted per error kind and dropped from the output (adjust.rs:239-258).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..caller import ThresholdCaller
from ..errors import ErrorTally, ModKitError
from ..io.bam import (
    BamReader, BamWriter, add_modkit_pg_records, encode_aux_array_u8,
    encode_aux_string,
)
from ..modtags import (
    DEFAULT_IMPLICIT, EXPLICIT, IMPLICIT, base_occurrence_positions,
    decode_record, format_mm_ml, parse_raw_mod_tags,
)
from ..collapse import apply_collapse
from ..modcodes import DNA_BASE_IDX, DNA_IDX_COMPLEMENT
from ..motifs import Motif


@dataclass
class SequenceMotifs:
    """Basecall-space motif positions (adjust.rs:22-90): forward-pattern
    matches over the instrument-orientation sequence, offset applied."""

    motifs: list[Motif]

    def find_positions(self, fwd_seq: np.ndarray) -> np.ndarray:
        out = []
        for m in self.motifs:
            starts = m._match_starts(fwd_seq, m.classes())
            out.append(starts + m.forward_offset)
        return np.unique(np.concatenate(out)) if out else np.empty(0, np.int64)


def adjust_record_tags(
    rec,
    collapse_methods=(),
    caller: ThresholdCaller | None = None,
    edge_filter=None,
    filter_only: bool = False,
    sequence_motifs: SequenceMotifs | None = None,
    discard_motifs: bool = False,
    new_mode: str | None = None,
    drop_implicit: bool = False,
    force_mm_style: str | None = None,
) -> bytes:
    """Return new raw record bytes with rewritten MM/ML.

    Raises ModKitError for records the reference drops.
    """
    _, _, mm_style, ml_style = parse_raw_mod_tags(rec)
    info = decode_record(rec)
    fwd_seq = rec.forward_seq()

    motif_positions = None
    if sequence_motifs is not None:
        motif_positions = sequence_motifs.find_positions(fwd_seq)

    mm_agg = []
    ml_agg = []
    base_pos_cache: dict[str, np.ndarray] = {}
    for base, strand, g in info.iter_groups():
        positions, probs, inferred = g.positions, g.probs, g.inferred
        codes = list(g.codes)
        mode = g.skip_mode
        if edge_filter is not None:
            if not edge_filter.read_can_be_trimmed(rec.l_seq):
                continue
            keep = edge_filter.keep_mask(positions, rec.l_seq)
            if not keep.any():
                continue
            positions, probs, inferred = (
                positions[keep], probs[keep], inferred[keep]
            )
            mode = EXPLICIT  # mod_bam.rs:1097 edge filter forces '?'
        for mth in collapse_methods:
            codes, probs = apply_collapse(codes, probs, mth)
        if caller is not None:
            b_idx = DNA_BASE_IDX[base]
            thr_mod = np.array(
                [caller.mod_threshold(c, base) for c in codes],
                dtype=np.float32,
            ).reshape(1, -1)
            live = np.where(probs >= 0, probs, np.float32(0))
            canon = np.float32(1.0) - live.sum(axis=1, dtype=np.float32)
            m = probs.shape[1]
            if m:
                present = probs >= 0
                pass_mod = present & (probs >= thr_mod)
                mod_p = np.where(pass_mod, probs, -np.inf)
                rev = (m - 1) - np.argmax(mod_p[:, ::-1], axis=1)
                best = np.take_along_axis(mod_p, rev[:, None], axis=1)[:, 0]
                any_mod = pass_mod.any(axis=1)
            else:
                any_mod = np.zeros(len(probs), dtype=bool)
                best = np.full(len(probs), -np.inf, np.float32)
                rev = np.zeros(len(probs), dtype=np.int64)
            pass_can = canon >= np.float32(caller.canonical_threshold(base))
            choose_can = pass_can & ((~any_mod) | (canon >= best))
            filtered = ~(choose_can | any_mod)
            if filter_only:
                keep = ~filtered
                positions, probs, inferred = (
                    positions[keep], probs[keep], inferred[keep]
                )
            else:
                # hard calls: winner -> 1.0, others -> 0.0; filtered dropped
                keep = ~filtered
                positions = positions[keep]
                inferred = inferred[keep]
                kept_probs = probs[keep]
                can_k = choose_can[keep]
                rev_k = rev[keep]
                new = np.where(
                    kept_probs >= 0, np.float32(0.0), np.float32(-1.0)
                )
                rowi = np.arange(len(new))
                mod_rows = ~can_k
                new[rowi[mod_rows], rev_k[mod_rows]] = np.float32(1.0)
                probs = new
            mode = EXPLICIT  # threshold_mod_caller.rs:121 forces '?'
        if motif_positions is not None:
            hit = np.isin(positions, motif_positions)
            keep = ~hit if discard_motifs else hit
            positions, probs, inferred = (
                positions[keep], probs[keep], inferred[keep]
            )
            mode = EXPLICIT  # adjust.rs:110 forces '?'
        if new_mode is not None:
            if drop_implicit and new_mode == EXPLICIT:
                keep = ~inferred
                positions, probs, inferred = (
                    positions[keep], probs[keep], inferred[keep]
                )
                mode = EXPLICIT
            else:
                mode = new_mode

        g2 = type(g)(
            base, g.mod_strand, mode, codes, positions, probs, inferred
        )
        if base not in base_pos_cache:
            base_pos_cache[base] = base_occurrence_positions(fwd_seq, base)
        mm, ml = format_mm_ml(g2, fwd_seq, base_pos_cache[base])
        mm_agg.append(mm)
        ml_agg.append(ml)

    mm_str = "".join(mm_agg)
    ml_bytes = (
        np.concatenate(ml_agg) if ml_agg else np.empty(0, dtype=np.uint8)
    )
    out_mm_style = force_mm_style or mm_style
    out_ml_style = "ML" if out_mm_style == "MM" else ml_style
    remove = {"MM", "Mm", "ML", "Ml"}
    new_items = [
        encode_aux_string(out_mm_style, mm_str),
        encode_aux_array_u8(out_ml_style, ml_bytes),
    ]
    return rec.with_replaced_aux(remove, new_items)


def adjust_modbam(
    in_bam: str,
    out_bam: str,
    collapse_methods=(),
    caller: ThresholdCaller | None = None,
    edge_filter=None,
    filter_only: bool = False,
    motifs: list[Motif] | None = None,
    discard_motifs: bool = False,
    new_mode: str | None = None,
    drop_implicit: bool = False,
    force_mm_style: str | None = None,
    fail_fast: bool = False,
    output_sam: bool = False,
) -> dict:
    """Streaming rewrite (adjust.rs:211 adjust_modbam). Supports '-' as
    stdin input and stdout output, and SAM text output (--output-sam), as
    in the reference's get_serial_reader/get_bam_writer
    (command_utils.rs:212-240).

    The hot path runs in the native C++ span engine (record decode ->
    transform -> MM/ML re-encode, block-parallel across the thread pool)
    with the per-record Python loop below as oracle/fallback
    (tests/test_native_adjust.py asserts byte-equality of the record
    streams)."""
    import sys

    from .. import native as _native

    from ..io.cram import is_cram, open_alignment_reader

    if (
        not fail_fast
        and not output_sam
        and in_bam not in ("-", "stdin")
        and force_mm_style in (None, "MM")
        and _native.available()
        and not is_cram(in_bam)
    ):
        return _adjust_modbam_native(
            in_bam, out_bam, collapse_methods, caller, edge_filter,
            filter_only, motifs, discard_motifs, new_mode, drop_implicit,
            force_mm_style,
        )

    reader = (
        BamReader(in_bam)
        if in_bam in ("-", "stdin")
        else open_alignment_reader(in_bam)
    )
    errors = ErrorTally()
    seq_motifs = SequenceMotifs(motifs) if motifs else None
    n = 0
    hdr = add_modkit_pg_records(reader.header)
    if output_sam:
        from ..io.bam import SamWriter

        writer_cm = SamWriter(out_bam, hdr)
    elif out_bam in ("-", "stdout"):
        writer_cm = BamWriter(sys.stdout.buffer, hdr)
    else:
        writer_cm = BamWriter(out_bam, hdr)
    with writer_cm as writer:
        for rec in reader.records():
            try:
                raw = adjust_record_tags(
                    rec, collapse_methods, caller, edge_filter, filter_only,
                    seq_motifs, discard_motifs, new_mode, drop_implicit,
                    force_mm_style,
                )
                writer.write_raw(raw)
                n += 1
            except ModKitError as e:
                if fail_fast:
                    raise
                errors.add(e)
    return dict(records_written=n, errors=dict(errors))


def _adjust_modbam_native(
    in_bam, out_bam, collapse_methods, caller, edge_filter, filter_only,
    motifs, discard_motifs, new_mode, drop_implicit, force_mm_style,
) -> dict:
    """Native streaming rewrite: spans of the compressed input decode,
    transform, re-encode AND BGZF-recompress in C++ (native
    mk_adjust_span with compress_level); Python only appends the finished
    block stream after its header block."""
    import os
    import sys

    from .. import native as _native
    from ..io.bgzf import BGZF_EOF, _compress_block

    reader = BamReader(in_bam)  # header + PG chain + mmap'd raw bytes
    hdr = add_modkit_pg_records(reader.header)
    raw = reader.bam_raw
    if out_bam in ("-", "stdout"):
        fh = sys.stdout.buffer
        owns = False
    else:
        fh = open(out_bam, "wb")
        owns = True
    n = 0
    errors: dict = {}
    try:
        hb = hdr.to_bytes()
        for i in range(0, len(hb), 0xFF00):
            fh.write(_compress_block(hb[i : i + 0xFF00], 6))
        for blob, n_written, errs in _native.adjust_stream(
            raw,
            edge_filter=edge_filter,
            collapse=list(collapse_methods) if collapse_methods else None,
            caller=caller,
            filter_only=filter_only,
            motifs=motifs,
            discard_motifs=discard_motifs,
            new_mode=new_mode,
            drop_implicit=drop_implicit,
            force_mm_style=force_mm_style,
            n_threads=min(os.cpu_count() or 1, 8),
            compress_level=6,
        ):
            fh.write(blob)
            n += n_written
            for k, v in errs.items():
                errors[k] = errors.get(k, 0) + v
        fh.write(BGZF_EOF)
        fh.flush()
    finally:
        if owns:
            fh.close()
    return dict(records_written=n, errors=errors)
