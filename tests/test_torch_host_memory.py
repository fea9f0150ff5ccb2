"""Host memory of the tile route: the BAM map's pages leave a reader.

``io/bgzf.py`` maps the whole BAM copy-on-write and the native calls read
it in place, so every page a tile's decode or the estimate's sample
touched stayed mapped in its reader, and counted in the process's RSS,
until the reader went: at genome scale the readers of a run mapped about
twice the BAM. ``native.release_pages`` drops the mapping of the blocks a
call has read (``MADV_DONTNEED``; the pages stay in the page cache and
read back the same bytes), and the tile workers share the run's reader,
so a run maps the BAM once. Here the pages each map holds are read from
``/proc/self/smaps``, on the CPU; the rows must not change.
"""

import ctypes
import mmap
import os
import threading

import numpy as np
import pytest

from modkit_tpu.caller import ThresholdCaller as RefCaller
from modkit_tpu.pileup.engine import PileupOptions as RefOptions
from modkit_tpu.pileup.engine import TileProcessor as RefProcessor
from modkit_tpu_torch import native
from modkit_tpu_torch.caller import ThresholdCaller
from modkit_tpu_torch.io.bam import BamReader
from modkit_tpu_torch.pileup.engine import PileupOptions, TileProcessor
from modkit_tpu_torch.thresholds import estimate_thresholds
from modkit_tpu_torch.tools.scale_bench import mapped_mb
from modkit_tpu_torch.utils.synth import make_synthetic_modbam

TILE = 20_000


def mapped_kb(path) -> int:
    """Resident kB of this process's maps of ``path`` (the scale tool's
    reading)."""
    return round(mapped_mb(str(path)) * 1024)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("host_memory") / "s.bam")
    stats = make_synthetic_modbam(path, n_reads=3000, read_len=2000,
                                  coverage=20.0, seed=17)
    return path, stats["contig_len"], os.path.getsize(path) // 1024


def spans(contig_len):
    return [(s, min(s + TILE, contig_len)) for s in range(0, contig_len, TILE)]


def test_release_pages_drops_the_chunks_blocks(tmp_path):
    size = 1 << 20
    path = tmp_path / "blob"
    path.write_bytes(np.random.default_rng(0).bytes(size))
    fd = os.open(path, os.O_RDONLY)
    try:
        raw = mmap.mmap(fd, 0, access=mmap.ACCESS_COPY)
    finally:
        os.close(fd)
    want = path.read_bytes()
    assert sum(raw[i] for i in range(0, size, mmap.PAGESIZE)) >= 0
    assert mapped_kb(path) == size // 1024
    # blocks from offset 100 000 to one block past 300 000
    native.release_pages(raw, [(100_000 << 16, 200_000 << 16),
                               (150_000 << 16 | 7, 300_000 << 16 | 9)])
    lo = 100_000 - 100_000 % mmap.PAGESIZE
    hi = -(-(300_000 + native.BGZF_MAX_BLOCK) // mmap.PAGESIZE) * (
        mmap.PAGESIZE)
    assert mapped_kb(path) == (size - (hi - lo)) // 1024
    # the bytes read back the same; past the end the range is clipped
    assert raw[:] == want
    native.release_pages(raw, [(0, (size - 10) << 16)])
    assert mapped_kb(path) == 0
    assert raw[:] == want
    native.release_pages(b"bytes have no map", [(0, 1 << 16)])
    native.release_pages(raw, [])
    raw.close()


def test_a_decoded_tile_leaves_its_reader(bam):
    """Tiles decoded and released leave almost nothing mapped, where the
    same decode without the release maps the BAM, and give the same
    rows."""
    path, contig_len, size_kb = bam
    assert size_kb > 2048
    proc = TileProcessor(ThresholdCaller.passthrough(),
                         PileupOptions(device="cpu"))
    reader = BamReader(path)
    got = [proc.finish_tile(proc.launch_tile(reader, 0, s, e),
                            chrom="synth1").text
           for s, e in spans(contig_len)]
    assert mapped_kb(path) < size_kb // 8
    # the decode alone, with no release, keeps the BAM mapped
    kept = BamReader(path)
    tiles = [native.decode_tile_bgzf(
        kept.bam_raw, kept.fetch_chunk_voffsets(0, s, e), 0, s, e)
        for s, e in spans(contig_len)]
    assert mapped_kb(path) > size_kb * 3 // 4
    del tiles, kept
    # the released pages read back: modkit_tpu's engine on its host route
    # (native decode, numpy count) over the same reader's map gives the
    # same rows
    ref = RefProcessor(RefCaller.passthrough(),
                       RefOptions(use_device=False))
    assert got == [ref.finish_tile(ref.launch_tile(reader, 0, s, e),
                                   chrom="synth1").text
                   for s, e in spans(contig_len)]


def test_the_estimate_sample_leaves_its_reader(bam):
    path, _, size_kb = bam
    reader = BamReader(path)
    per_base = estimate_thresholds(reader, num_reads=3000, seed=3,
                                   filter_percentile=0.1,
                                   interval_size=20_000)
    assert per_base
    assert mapped_kb(path) < size_kb // 8


@pytest.mark.parametrize("threads", [1, 4])
def test_a_run_maps_the_bam_once(bam, tmp_path, monkeypatch, threads):
    """The estimate and every tile worker read through the run's one
    reader, so a run maps the BAM once (a map per worker held its pages
    once more), and a finished run has joined its workers (what their
    threads held is freed when it returns); the bedMethyl is the
    one-thread run's."""
    from modkit_tpu_torch.io import bam as bam_io
    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup

    path, _, _ = bam
    opened = []
    init = bam_io.BamReader.__init__

    def counted(self, *a, **kw):
        opened.append(a[0] if a else kw["path"])
        init(self, *a, **kw)

    monkeypatch.setattr(bam_io.BamReader, "__init__", counted)
    outs = []
    for n in (1, threads):
        outs.append(tmp_path / f"t{n}.bed")
        opened.clear()
        before = set(threading.enumerate())
        run_pileup(PileupConfig(in_bam=path, out=str(outs[-1]), threads=n,
                                interval_size=TILE, suppress_progress=True,
                                device="cpu"))
        assert opened == [path]
        assert set(threading.enumerate()) <= before
    assert outs[0].read_bytes() == outs[1].read_bytes()



class _MallInfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks",
        "uordblks", "fordblks", "keepcost")]


def _malloc_in_use() -> int:
    """Bytes glibc's malloc holds for the process, every arena and map."""
    libc = ctypes.CDLL(None)
    libc.mallinfo2.restype = _MallInfo2
    info = libc.mallinfo2()
    return info.uordblks + info.hblkhd


def test_repeated_tile_decodes_hold_no_memory(bam):
    """The BGZF inflate pool starts its threads per batch of blocks; each
    thread's libdeflate decompressor is freed when the thread ends (held by
    a bare ``thread_local`` pointer, one leaked a thread: about 50 kB a call
    here, 0.5 MB a 100 kb tile of the benchmark's data)."""
    path, contig_len, _ = bam
    reader = BamReader(path)
    start, end = spans(contig_len)[0]
    chunks = reader.fetch_chunk_voffsets(0, start, end)

    def decode(n):
        for _ in range(n):
            tile = native.decode_tile_bgzf(reader.bam_raw, chunks, 0, start, end,
                                           n_threads=8)
            assert tile.n_used > 0
            del tile

    decode(20)
    before = _malloc_in_use()
    decode(200)
    assert _malloc_in_use() - before < 256 << 10
