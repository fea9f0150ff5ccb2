"""The motif route's columnar decode equals the row decode it replaces.

``engine.decode_counts_columnar`` with a focus (and with strands combined)
rendered by ``BedMethylWriter.write_columnar`` writes the bytes of
``engine.decode_counts`` (then ``combine_strand_rows``) rendered by
``write_rows``, on random count tiles laid out as the engine lays them
out: counts only at focus positions, on the strands their rule admits.
A ``--preset traditional`` pileup formats every tile on this route.
"""

import io

import numpy as np
import pytest

from modkit_tpu_torch import tracing
from modkit_tpu_torch.motifs import (
    FocusPositions, parse_motifs, scan_focus_positions,
    scan_focus_positions_combine,
)
from modkit_tpu_torch.ops.counts import round_up_codes
from modkit_tpu_torch.pileup import engine
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth import make_synthetic_modbam
from modkit_tpu_torch.writers import BedMethylWriter

TILE_START, TILE_LEN = 1000, 600
VOCABS = {1: ["m"], 2: ["m", "h"], 3: ["m", 21839, "h"]}
MOTIFS = {
    "one": ["CG", "0"],
    # focus positions with two or more motif ids; CA is no palindrome,
    # so strand combination leaves it out
    "overlapping": ["CG", "0", "CGCG", "0", "GCGC", "1", "CA", "0"],
}


class _Fasta:
    def __init__(self, seq):
        self.seq = seq

    def fetch(self, _chrom, start, end):
        return self.seq[start:end]


class _Filter:
    """Drops a random fifth of the (position, strand) motif hits, as an
    ``--include-bed`` beside a motif does."""

    def __init__(self, rng):
        self.drop = rng.random((TILE_START + 2 * TILE_LEN, 2)) < 0.2

    def contains(self, _tid, pos, strand):
        return [not self.drop[pos, strand]]


def _focus(rng, motif_set, combine_strands):
    # CpG-rich sequence, so that motifs overlap
    seq = rng.choice(np.frombuffer(b"ACGTCGCG", dtype=np.uint8),
                     TILE_START + 2 * TILE_LEN)
    fasta, filt = _Fasta(seq), _Filter(rng)
    if motif_set == "bed":
        rule = rng.choice(np.array([-1, -1, 0, 1, 2], dtype=np.int8), TILE_LEN)
        return FocusPositions(TILE_START, rule, {}, {}, {}), [], TILE_LEN
    motifs = parse_motifs(MOTIFS[motif_set])
    end = TILE_START + TILE_LEN
    if combine_strands:
        focus, end = scan_focus_positions_combine(
            motifs, fasta, "c", 0, len(seq), TILE_START, end, filt
        )
    else:
        focus = scan_focus_positions(motifs, fasta, "c", TILE_START, end, filt, 0)
    return focus, [m.label() for m in motifs], end - TILE_START


def _tile(rng, focus, p, m):
    """Counts [p, 2, K] and the observed codes [p, 2, 4, m] of a tile whose
    events the focus rule admitted; a fifth of the admitted strands left
    uncovered, so some CpG pairs have one strand only."""
    m_pad = round_up_codes(m)
    k = 6 + 4 * (m_pad + 1)
    counts = rng.integers(0, 6, size=(p, 2, k)).astype(np.int32)
    body = counts[:, :, 6:].reshape(p, 2, 4, m_pad + 1)
    body[..., 1 + m:] = 0  # padded code columns stay empty
    rule = focus.rule[:p, None]
    admitted = ((rule == 2) | (rule == np.arange(2))) & (rng.random((p, 2)) > 0.2)
    counts *= admitted[..., None]
    observed = rng.random((p, 2, 4, m)) < 0.7
    return counts, observed


def _write(rows, labels, space="\t"):
    """The rows' bedMethyl lines (a list: on a mismatch pytest names the
    first line that differs)."""
    out = io.StringIO()
    w = BedMethylWriter(out, mixed_delimiters=space == " ")
    if isinstance(rows, engine.ColumnarRows):
        w.write_columnar("chr1", rows, labels)
    else:
        for _pos, rs in rows:
            w.write_rows("chr1", rs, labels)
    return out.getvalue().splitlines()


CASES = [
    (seed, m, motif_set, combine)
    for seed in (0, 1, 2)
    for m in (1, 2, 3)
    for motif_set in ("one", "overlapping", "bed")
    for combine in (False, True)
    if not (motif_set == "bed" and combine)
]


@pytest.mark.parametrize("seed,m,motif_set,combine_strands", CASES)
def test_columnar_motif_route_writes_the_rows_of_the_row_decode(
    seed, m, motif_set, combine_strands
):
    rng = np.random.default_rng([seed, m, len(motif_set), combine_strands])
    focus, labels, p = _focus(rng, motif_set, combine_strands)
    counts, observed = _tile(rng, focus, p, m)
    vocab = VOCABS[m]
    # combine_mods on odd seeds: one any-mod row per base
    combine_mods = bool(seed % 2)
    want = engine.decode_counts(
        counts, observed, vocab, TILE_START, combine_mods=combine_mods,
        focus=focus,
    )
    if combine_strands:
        want = engine.combine_strand_rows(want, focus)
    got = engine.decode_counts_columnar(
        counts, observed, vocab, TILE_START, combine_mods=combine_mods,
        focus=focus, combine_strands=combine_strands,
    )
    n_rows = sum(len(rs) for _pos, rs in want)
    assert n_rows > 0 and len(got) == n_rows
    for space in ("\t", " "):
        assert _write(got, labels, space) == _write(want, labels, space)
    if motif_set == "overlapping" and not combine_strands:
        assert any(",CGCG,0\t" in line for line in _write(got, labels))


def test_preset_traditional_formats_every_tile_on_the_motif_route(tmp_path):
    bam, fa = str(tmp_path / "s.bam"), str(tmp_path / "s.fa")
    make_synthetic_modbam(bam, n_reads=400, read_len=2000, coverage=20.0,
                          seed=7, contig_len=40_000, fasta_out=fa)
    rec = tracing.Records()
    tracing.set_sink(rec)
    try:
        res = run_pileup(PileupConfig(
            in_bam=bam, out=str(tmp_path / "t.bed"), preset="traditional",
            reference_fasta=fa, no_filtering=True, interval_size=5000,
            suppress_progress=True, device="cpu",
        ))
    finally:
        tracing.set_sink(None)
    routes = {r[2]: tracing.FORMAT_ROUTES[r[5]] for r in rec
              if r[0] == "format_route"}
    tiles = {r[2] for r in rec if r[0] == "tile"}
    assert res["rows"] > 0 and len(tiles) == 8
    assert routes == {t: "columnar_motif" for t in tiles}
