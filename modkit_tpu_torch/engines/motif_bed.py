"""`motif bed`: emit BED rows of motif hit positions across a FASTA.

Reference equivalent: ``src/find_motifs/motif_bed.rs:354-430`` motif_bed.
Rows are ``chrom pos pos+1 . . strand`` for every (overlapping) hit of
the IUPAC motif on either strand, contigs in FASTA order.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.fasta import FastaReader
from ..motifs import Motif


def run_motif_bed(args) -> int:
    motif = Motif(args.motif.upper(), args.offset)
    fasta = FastaReader(args.fasta)
    out = sys.stdout
    strands = "+-"
    for name in fasta.names():
        seq = fasta.fetch(name)
        if not args.mask:
            lower = (seq >= ord("a")) & (seq <= ord("z"))
            seq = np.where(lower, seq - 32, seq).astype(np.uint8)
        for pos, strand in motif.find_hits(seq):
            out.write(f"{name}\t{pos}\t{pos + 1}\t.\t.\t{strands[strand]}\n")
    return 0
