"""`repair`: project MM/ML tags from a donor (pre-trim) BAM onto an
acceptor (trimmed) BAM.

Reference equivalent: ``src/repair_tags.rs``. Both BAMs must be sorted by
read name; records are zip-paired by qname (donor skips non-primary
records, unmatched donors are skipped past). The acceptor's forward
sequence must occur exactly once as a substring of the donor's forward
sequence; mod probabilities are shifted into acceptor coordinates and
re-encoded against the acceptor's base-occurrence counts, with an MN tag
set to the acceptor sequence length.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.bam import (
    BamReader,
    BamWriter,
    add_modkit_pg_records,
    encode_aux_array_u8,
    encode_aux_string,
)
from ..modtags import (
    base_occurrence_positions,
    decode_record,
    format_mm_ml,
    parse_raw_mod_tags,
)


def _find_substring_starts(haystack: str, needle: str) -> list[int]:
    """Non-overlapping match starts (Rust str::match_indices)."""
    out = []
    i = 0
    while True:
        j = haystack.find(needle, i)
        if j < 0:
            return out
        out.append(j)
        i = j + len(needle)


def _zip_pairs(donor_iter, acceptor_iter):
    """repair_tags.rs:198-291 ZipRecordsIter: name-sorted zip join."""

    def next_donor():
        for rec in donor_iter:
            if rec.is_not_primary:
                continue
            return rec
        return None

    donor = next_donor()
    for acceptor in acceptor_iter:
        while donor is not None and donor.name != acceptor.name:
            donor = next_donor()
        if donor is None:
            print("ran out of donor records", file=sys.stderr)
            return
        yield donor, acceptor


def repair_record_pair(donor, acceptor) -> bytes:
    """repair_tags.rs:293-372."""
    _, _, mm_style, ml_style = parse_raw_mod_tags(donor)
    info = decode_record(donor)
    donor_seq = donor.forward_seq().tobytes().decode()
    acceptor_fwd = acceptor.forward_seq()
    acceptor_seq = acceptor_fwd.tobytes().decode()
    starts = _find_substring_starts(donor_seq, acceptor_seq)
    if len(starts) > 1:
        raise ValueError(
            f"multiple potential corrections found for {donor.name}"
        )
    if not starts:
        raise ValueError(
            "acceptor sequence is not a substring of the donor sequence"
        )
    start = starts[0]
    end = start + len(acceptor_seq)

    mm_agg = []
    ml_agg = []
    base_pos_cache: dict[str, np.ndarray] = {}
    for base, _strand, g in info.iter_groups():
        keep = (g.positions >= start) & (g.positions < end)
        g2 = type(g)(
            base,
            g.mod_strand,
            g.skip_mode,
            list(g.codes),
            g.positions[keep] - start,
            g.probs[keep],
            g.inferred[keep],
        )
        if base not in base_pos_cache:
            base_pos_cache[base] = base_occurrence_positions(
                acceptor_fwd, base
            )
        mm, ml = format_mm_ml(g2, acceptor_fwd, base_pos_cache[base])
        mm_agg.append(mm)
        ml_agg.append(ml)
    mm_str = "".join(mm_agg)
    ml_bytes = (
        np.concatenate(ml_agg) if ml_agg else np.empty(0, dtype=np.uint8)
    )
    remove = {"MM", "Mm", "ML", "Ml", "MN"}
    import struct

    mn_item = b"MNI" + struct.pack("<I", len(acceptor_seq))
    new_items = [
        encode_aux_string(mm_style, mm_str),
        encode_aux_array_u8("ML" if mm_style == "MM" else ml_style, ml_bytes),
        mn_item,
    ]
    return acceptor.with_replaced_aux(remove, new_items)


def run_repair(args) -> int:
    from ..io.cram import open_alignment_reader

    donor_reader = open_alignment_reader(args.donor)
    acceptor_reader = open_alignment_reader(args.acceptor)
    n_repaired = n_failed = 0
    with BamWriter(
        args.output, add_modkit_pg_records(acceptor_reader.header)
    ) as writer:
        for donor, acceptor in _zip_pairs(
            donor_reader.records(), acceptor_reader.records()
        ):
            try:
                raw = repair_record_pair(donor, acceptor)
            except (ValueError, KeyError) as e:
                print(f"record failed to be repaired: {e}", file=sys.stderr)
                n_failed += 1
                continue
            writer.write_raw(raw)
            n_repaired += 1
    print(
        f"finished, repaired {n_repaired} records, {n_failed} failed.",
        file=sys.stderr,
    )
    return 0
