"""Genome-wide stranded base positions from a reference FASTA.

Reference equivalent: ``src/genome_positions.rs`` GenomePositions. Holds the
reference contigs as byte arrays and answers "which positions in this range
carry one of the comparison bases on which strand" -- e.g. for --base C,
positive-strand positions are 'C' bases and negative-strand positions are
'G' bases (the complement). A position belongs to at most one strand.

The scan is vectorized with numpy over the contig byte array instead of the
reference's per-character loop (genome_positions.rs:91-127).
"""

from __future__ import annotations

import numpy as np

from .io.fasta import FastaReader
from .modcodes import complement

_STRANDS = ("+", "-")


class GenomePositions:
    def __init__(
        self,
        bases: list[str],
        fasta_path: str,
        mask: bool = False,
        contigs: set[str] | None = None,
    ):
        self.pos_bases = {b.upper() for b in bases}
        self.neg_bases = {complement(b.upper()) for b in bases}
        reader = FastaReader(fasta_path)
        self._contigs: dict[str, np.ndarray] = {}
        for name in reader.names():
            if contigs is not None and name not in contigs:
                continue
            seq = reader.fetch(name)  # uint8 array
            if not mask:
                # uppercase a..z in place (genome_positions.rs:70-77)
                lower = (seq >= ord("a")) & (seq <= ord("z"))
                seq = np.where(lower, seq - 32, seq).astype(np.uint8)
            self._contigs[name] = seq

    def has_contig(self, name: str) -> bool:
        return name in self._contigs

    def contig_names(self) -> list[str]:
        return list(self._contigs)

    def contig_sizes(self):
        return {n: len(s) for n, s in self._contigs.items()}

    def get_positions_arrays(
        self, chrom: str, start: int, end: int, strand_rule: str = "."
    ):
        """(positions, strand_is_neg, base_chars) numpy arrays for the
        comparison bases in [start, end), or None if the contig is absent."""
        seq = self._contigs.get(chrom)
        if seq is None:
            return None
        window = seq[start:end]
        pos_mask = np.zeros(len(window), dtype=bool)
        neg_mask = np.zeros(len(window), dtype=bool)
        if strand_rule in ("+", "."):
            for b in self.pos_bases:
                pos_mask |= window == ord(b)
        if strand_rule in ("-", "."):
            for b in self.neg_bases:
                neg_mask |= window == ord(b)
        any_mask = pos_mask | neg_mask
        idx = np.nonzero(any_mask)[0]
        positions = idx + start
        is_neg = neg_mask[idx]
        bases = window[idx]
        return positions, is_neg, bases

    def get_positions(
        self, chrom: str, start: int, end: int, strand_rule: str = "."
    ) -> set[tuple[int, str, str]] | None:
        """Set of (position, strand, base) tuples, matching the reference's
        StrandedPosition set (genome_positions.rs:91-127)."""
        arrays = self.get_positions_arrays(chrom, start, end, strand_rule)
        if arrays is None:
            return None
        positions, is_neg, bases = arrays
        return {
            (int(p), _STRANDS[int(n)], chr(b))
            for p, n, b in zip(positions, is_neg, bases)
        }
