"""A synthetic modBAM with many mod codes on one canonical base.

The reads are those of ``synth.make_synthetic_modbam`` (forward reads tiled
over a random contig, a call at every C, written with the port's own
``io/bam.py`` writer and record encoding), but ``MM`` holds one
``C+<code>?`` entry per code of ``codes``, so a tile carries as many mod
classes as there are codes. Numeric codes are ChEBI ids. At every C the
codes' probabilities and the canonical one are a random split of 1.
"""

from __future__ import annotations

import numpy as np

from ..io.bam import BamHeader, BamWriter, Reference, build_bai
from .synth import _encode_record

# four letter codes of C and five ChEBI ids: nine mod classes on C
NINE_CODES = ("m", "h", "f", "c", "76792", "76794", "27551", "18296", "17802")


def make_multicode_modbam(
    path: str,
    n_reads: int = 200,
    read_len: int = 2000,
    coverage: float = 20.0,
    seed: int = 0,
    codes=NINE_CODES,
    fasta_out: str | None = None,
) -> dict:
    """Write a sorted, indexed modBAM whose reads call every code of
    ``codes`` at every C (and, with ``fasta_out``, the FASTA the reads were
    drawn from); returns summary stats."""
    rng = np.random.default_rng(seed)
    contig_len = max(int(n_reads * read_len / coverage), read_len + 1)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=contig_len)
    if fasta_out is not None:
        text = genome.tobytes().decode()
        with open(fasta_out, "w") as fh:
            fh.write(">synth1\n")
            for i in range(0, len(text), 80):
                fh.write(text[i : i + 80] + "\n")
    starts = np.sort(rng.integers(0, contig_len - read_len, size=n_reads))
    header = BamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:synth1\tLN:%d\n" % contig_len,
        [Reference("synth1", contig_len)],
    )
    k = len(codes)
    n_calls = 0
    with BamWriter(path, header) as writer:
        for i in range(n_reads):
            pos = int(starts[i])
            seq = genome[pos : pos + read_len].copy()
            c_pos = np.nonzero(seq == ord("C"))[0]
            if len(c_pos) == 0:
                continue
            split = rng.random((len(c_pos), k + 1)).astype(np.float32)
            split /= split.sum(axis=1, keepdims=True)
            ml = np.clip((split[:, :k] * 256).astype(np.int32), 0, 255)
            dstr = ",".join("0" for _ in c_pos)
            mm = "".join(f"C+{code}?,{dstr};" for code in codes)
            raw = _encode_record(
                f"read_{i}".encode(), 0, pos, seq, mm,
                ml.T.reshape(-1).astype(np.uint8),
            )
            writer.write_raw(raw)
            n_calls += k * len(c_pos)
    build_bai(path)
    return dict(n_reads=n_reads, read_len=read_len, contig_len=contig_len,
                n_mod_calls=n_calls, codes=tuple(codes))
