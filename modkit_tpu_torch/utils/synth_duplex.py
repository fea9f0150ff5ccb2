"""Synthetic two-strand modBAM: reads in both orientations with calls on both
strands of the duplex, for ``pileup-hemi``.

``utils/synth.py`` writes forward reads with ``C+`` calls only; a hemi
pileup pairs a read's call at a CpG's C with its call at the partner G,
which needs the ``G-`` calls a duplex basecaller writes. Each read here is
forward or reverse (flag 0x10) at random. SEQ is the reference strand, as
in every BAM; the MM groups count the read's own bases from its 5' end, so
on a reverse read ``C+`` covers the G's of SEQ and ``G-`` its C's. Every
such base carries a call (all-zero MM deltas) of two codes, h and m, with
ML values drawn as in ``utils/synth.py``.
"""

from __future__ import annotations

import numpy as np

from ..io.bam import BamHeader, BamWriter, Reference, build_bai
from .synth import _encode_record


def _calls(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    probs_m = rng.random(n).astype(np.float32)
    probs_h = (1.0 - probs_m) * rng.random(n).astype(np.float32)
    ml_h = np.clip((probs_h * 256).astype(np.int32), 0, 255)
    ml_m = np.clip((probs_m * 256).astype(np.int32), 0, 255)
    return ml_h, ml_m


def make_duplex_modbam(
    path: str,
    n_reads: int = 2000,
    read_len: int = 5000,
    coverage: float = 25.0,
    seed: int = 0,
    fasta_out: str | None = None,
) -> dict:
    """Write a sorted, indexed two-strand modBAM (and the FASTA its reads
    were drawn from); returns counts of reads per orientation."""
    rng = np.random.default_rng(seed)
    contig_len = max(int(n_reads * read_len / coverage), read_len + 1)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                        size=contig_len)
    if fasta_out is not None:
        with open(fasta_out, "w") as fh:
            fh.write(">synth1\n")
            text = genome.tobytes().decode()
            for i in range(0, len(text), 80):
                fh.write(text[i:i + 80] + "\n")
    starts = np.sort(rng.integers(0, contig_len - read_len, size=n_reads))
    reverse = rng.random(n_reads) < 0.5
    header = BamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:synth1\tLN:%d\n" % contig_len,
        [Reference("synth1", contig_len)],
    )
    with BamWriter(path, header) as writer:
        for i in range(n_reads):
            pos = int(starts[i])
            seq = genome[pos:pos + read_len].copy()
            n_c = int(np.count_nonzero(seq == ord("C")))
            n_g = int(np.count_nonzero(seq == ord("G")))
            # the read's own C's and G's: on a reverse read, SEQ's G's and C's
            n_top, n_bottom = (n_g, n_c) if reverse[i] else (n_c, n_g)
            groups, ml = [], []
            for stem, n in (("C+", n_top), ("G-", n_bottom)):
                if n == 0:
                    continue
                dstr = ",".join(["0"] * n)
                ml_h, ml_m = _calls(rng, n)
                groups += [f"{stem}h?,{dstr};", f"{stem}m?,{dstr};"]
                ml += [ml_h, ml_m]
            if not groups:
                continue
            raw = _encode_record(
                f"read_{i}".encode(), 0, pos, seq, "".join(groups),
                np.concatenate(ml).astype(np.uint8),
                flag=16 if reverse[i] else 0,
            )
            writer.write_raw(raw)
    build_bai(path)
    return dict(n_reads=n_reads, n_reverse=int(reverse.sum()),
                contig_len=contig_len)
