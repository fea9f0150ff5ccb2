"""The run's cache of inflated BGZF blocks (``native.BlockCache``).

A tile's chunks start at the BAI linear index offset of the first read
that overlaps it, so with reads longer than a tile most of a tile's blocks
are the previous tile's too. ``decode_tile_bgzf(block_cache=...)`` copies
a block that another tile inflated from the cache; every field of the
decoded tile equals the uncached decode's, whether tiles run in order, out
of order (blocks dropped and inflated again) or from four threads at once,
and a block that one decode is inflating is waited for by the others.

Data: ``make_synthetic_modbam``'s reads (6 kb, over 2 kb tiles) with random
base qualities, written on two contigs.
"""

import random
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from modkit_tpu_torch import native
from modkit_tpu_torch.io.bam import BamHeader, BamReader, BamWriter, Reference, build_bai
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth import make_synthetic_modbam

CONTIG = 40_000
TILE = 2_000
TILES = [(tid, s, min(s + TILE, CONTIG)) for tid in (0, 1) for s in range(0, CONTIG, TILE)]


def with_random_quals(raw, rng):
    """A BAM record (without its block size) whose base qualities are
    random, as a sequencer's compress: the synthetic ones are constant."""
    l_name, n_cigar, l_seq = raw[8], *struct.unpack_from("<H", raw, 12), \
        *struct.unpack_from("<i", raw, 16)
    q = 32 + l_name + 4 * n_cigar + (l_seq + 1) // 2
    return raw[:q] + rng.integers(1, 50, l_seq, dtype=np.uint8).tobytes() + raw[q + l_seq:]


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """The synthetic reads on contig ``a`` (tid 0), and again on ``b``."""
    d = tmp_path_factory.mktemp("block_cache")
    one = str(d / "one.bam")
    make_synthetic_modbam(one, n_reads=80, read_len=6_000, contig_len=CONTIG, seed=11)
    rng = np.random.default_rng(11)
    recs = [with_random_quals(r.raw(), rng) for r in BamReader(one).records()]
    header = BamHeader(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:a\tLN:{CONTIG}\n"
                       f"@SQ\tSN:b\tLN:{CONTIG}\n",
                       [Reference("a", CONTIG), Reference("b", CONTIG)])
    path = str(d / "two.bam")
    with BamWriter(path, header) as w:
        for tid in (0, 1):
            for raw in recs:
                w.write_raw(tid.to_bytes(4, "little") + raw[4:])
    build_bai(path)
    return path


def decode(reader, tile, cache=None, n_threads=1):
    tid, start, end = tile
    chunks = reader.fetch_chunk_voffsets(tid, start, end)
    return native.decode_tile_bgzf(reader.bam_raw, chunks, tid, start, end,
                                   n_threads=n_threads, block_cache=cache)


def same_tile(got, want):
    """Every field of two decoded tiles, at every position."""
    for key in ("n_used", "n_skipped", "errors", "vocab", "n_events", "m", "n_parts",
                "aligned_columns", "walked_columns", "bgzf_blocks"):
        assert getattr(got, key) == getattr(want, key), key
    assert (got._out.n_nc, got._out.n_del) == (want._out.n_nc, want._out.n_del)
    for key in ("rpos", "strand", "base", "probs"):
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    for key in ("nc_counts", "del_counts", "observed"):
        a, b = getattr(got, key), getattr(want, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key


ORDERS = {
    "in_order": TILES,
    # tiles jump ahead and back: the cache drops blocks that a later tile
    # needs, which it inflates again
    "out_of_order": random.Random(3).sample(TILES, len(TILES)),
}


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("order", list(ORDERS))
def test_cached_tiles_equal_uncached(bam, order, workers):
    reader = BamReader(bam)
    tiles = ORDERS[order]
    # the threads of a decode set its batches of blocks, and so its count
    want = [decode(reader, t, n_threads=2) for t in tiles]
    assert sum(w.n_events for w in want) > 0
    cache = native.BlockCache.create()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        got = list(pool.map(lambda t: decode(reader, t, cache, n_threads=2), tiles))
    for g, w in zip(got, want):
        same_tile(g, w)
        assert w.bgzf_blocks_reused == 0
        assert 0 <= g.bgzf_blocks_reused <= g.bgzf_blocks
    reused = sum(g.bgzf_blocks_reused for g in got)
    assert 0 < reused < sum(g.bgzf_blocks for g in got)


# each case: the tiles decoded in turn through one fresh cache (tile k of
# contig ``a``, ``b<k>`` of contig ``b``), and what the last one reuses
REUSE = {
    "single_tile": ([5], "none"),
    "adjacent_tiles": ([5, 6], "some"),
    "same_tile_again": ([5, 5], "all"),
    # without the emptying, the blocks of b5's first decode lie above
    # tile 5's and would stay
    "new_contig_empties": (["b5", 5, "b5"], "none"),
    "back_after_a_jump": ([5, 9, 6], "fewer"),  # tile 9 drops what 6 shares with 5
}


@pytest.mark.parametrize("case", list(REUSE))
def test_blocks_reused(bam, case):
    seq, expect = REUSE[case]
    reader = BamReader(bam)

    def tile(k):
        return TILES[len(TILES) // 2 + int(k[1:])] if isinstance(k, str) else TILES[k]

    cache = native.BlockCache.create()
    got = [decode(reader, tile(k), cache) for k in seq]
    last = got[-1]
    same_tile(last, decode(reader, tile(seq[-1])))
    assert last.bgzf_blocks > 1
    if expect == "none":
        assert last.bgzf_blocks_reused == 0
    elif expect == "all":
        assert last.bgzf_blocks_reused == last.bgzf_blocks
    elif expect == "some":
        assert last.bgzf_blocks_reused > 0
    else:
        cache = native.BlockCache.create()
        after_5 = [decode(reader, tile(k), cache) for k in (5, 6)][-1]
        assert last.bgzf_blocks_reused < after_5.bgzf_blocks_reused


def test_concurrent_decodes_inflate_each_block_once(bam):
    """Eight threads decode one contig at once through one cache: a block
    that another decode is inflating is waited for, not inflated again."""
    reader = BamReader(bam)
    whole = (0, 0, CONTIG)
    want = decode(reader, whole)
    cache = native.BlockCache.create()
    start = threading.Barrier(8)

    def one(_):
        start.wait()
        return decode(reader, whole, cache)

    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(one, range(8)))
    for g in got:
        same_tile(g, want)
    assert sum(g.bgzf_blocks - g.bgzf_blocks_reused for g in got) == want.bgzf_blocks


def test_pileup_output_is_the_same_without_the_cache(bam, tmp_path, monkeypatch):
    def pileup(out):
        return run_pileup(PileupConfig(in_bam=bam, out=str(out), interval_size=TILE,
                                       threads=4, suppress_progress=True, device="cpu",
                                       no_filtering=True))

    made = []
    real = native.BlockCache.create

    def counted():
        made.append(real())
        return made[-1]

    monkeypatch.setattr(native.BlockCache, "create", staticmethod(counted))
    cached = pileup(tmp_path / "cached.bed")
    monkeypatch.setattr(native.BlockCache, "create", staticmethod(lambda: None))
    plain = pileup(tmp_path / "plain.bed")
    assert len(made) == 1
    assert cached == plain and cached["rows"] > 0
    assert np.array_equal(np.fromfile(tmp_path / "cached.bed", np.uint8),
                          np.fromfile(tmp_path / "plain.bed", np.uint8))
