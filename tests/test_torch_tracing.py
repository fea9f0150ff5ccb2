"""The tracer of the pileup pipeline (``modkit_tpu_torch/tracing.py``):
spans and counters of every tile, on the CPU route.

With no sink nothing is kept; with a recording sink every tile has one
span of each stage, nested in time inside its ``tile`` span (its
``focus_scan`` just before it), its counters add up to the run's, and the
rows are those of a run with no sink. ``MODKIT_TPU_PROFILE`` writes the
spans into ``trace.json`` on the profiler's clock.
"""

import json
import os
import sys
import threading
import tracemalloc
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from modkit_tpu_torch import native, tracing
from modkit_tpu_torch.io.fasta import FastaReader
from modkit_tpu_torch.motifs import (
    parse_motifs, scan_focus_positions, scan_focus_positions_combine,
)
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth import make_synthetic_modbam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import gen as bench_gen, run as bench_run  # noqa: E402

TILE = 20_000
# a tile's spans; ``estimate`` runs once, before the first tile
TILE_SPANS = ("tile", "queued", "decode", "export", "upload", "dispatch",
              "device_wait", "histogram", "format", "held", "writer_wait", "write",
              "focus_scan")
CHROM = "synth1"  # make_synthetic_modbam's contig
# the flags of a run with a focus, beside the reference (``fasta``)
FOCUS = {"none": {}, "cpg": {"cpg": True},
         "cpg_combined": {"cpg": True, "combine_strands": True}}


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "s.bam")
    make_synthetic_modbam(path, n_reads=1200, read_len=2000, coverage=20.0,
                          seed=5, contig_len=150_000, fasta_out=path[:-4] + ".fa")
    return path


def focus_flags(bam, focus):
    kw = dict(FOCUS[focus])
    if kw:
        kw["reference_fasta"] = bam[:-4] + ".fa"
    return kw


@pytest.fixture(autouse=True)
def no_profile(monkeypatch):
    monkeypatch.delenv("MODKIT_TPU_PROFILE", raising=False)
    monkeypatch.delenv("MODKIT_TPU_OFFLOAD", raising=False)
    yield
    tracing.set_sink(None)


def pileup(bam, out, interval_size=TILE, **kw):
    return run_pileup(PileupConfig(in_bam=bam, out=str(out), interval_size=interval_size,
                                   suppress_progress=True, device="cpu", **kw))


def recorded(bam, out, **kw):
    rec = tracing.Records()
    tracing.set_sink(rec)
    try:
        res = pileup(bam, out, **kw)
    finally:
        tracing.set_sink(None)
    return res, list(rec)


def test_no_sink_keeps_nothing(bam, tmp_path):
    tracemalloc.start()
    try:
        pileup(bam, tmp_path / "a.bed")
        kept = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, tracing.__file__)])
        # the threads' current tile (``begin_tile``), nothing a span or a tile
        assert sum(s.size for s in kept.statistics("filename")) < 1024
        tracemalloc.reset_peak()
        base, _ = tracemalloc.get_traced_memory()
        for i in range(10_000):
            with tracing.span("decode", i):
                pass
            tracing.count("rows", i, i)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # each span's object and clock readings go with it: nothing grows
    assert now - base < 1024 and peak - base < 4096
    assert tracing._sink is None


@pytest.mark.parametrize("route", ["native", "empty", "python", "cpg_combined"])
def test_every_tile_has_each_stage_inside_its_tile(bam, tmp_path, monkeypatch, route):
    """On the native route, where every other tile has no reads (its
    stages then span zero time at the tile's end), on the Python event
    route (one launcher, the native decoder off), and with ``--cpg
    --combine-strands`` (the focus scanned on the main thread before each
    tile's submission; without a focus its span has zero length)."""
    kw = focus_flags(bam, route if route in FOCUS else "none")
    if route == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    if route == "empty":
        from modkit_tpu_torch.pileup.engine import TileProcessor

        real = TileProcessor.launch_tile

        def half(self, reader, tid, start, end, focus=None):
            if (start // TILE) % 2:
                return None
            return real(self, reader, tid, start, end, focus)

        monkeypatch.setattr(TileProcessor, "launch_tile", half)
    res, recs = recorded(bam, tmp_path / "a.bed", **kw)
    spans = [r for r in recs if r[0] in tracing.SPANS]
    tiles = {r[2]: r for r in spans if r[0] == "tile"}
    assert len(tiles) == -(-150_000 // TILE)
    assert Counter(r[0] for r in spans if r[0] == "estimate") == {"estimate": 1}
    per_tile = Counter((r[2], r[0]) for r in spans if r[0] != "estimate")
    assert per_tile == Counter({(t, n): 1 for t in tiles for n in TILE_SPANS})
    for name, thread, tile, start, end, _ in spans:
        if name == "estimate":
            continue
        _, _, _, t0, t1, _ = tiles[tile]
        if name == "focus_scan":
            assert start <= end <= t0, tile
        else:
            assert t0 <= start <= end <= t1, (name, tile)
    scans = [r[4] - r[3] for r in spans if r[0] == "focus_scan"]
    assert all(d > 0 for d in scans) if kw else not any(scans)
    workers = {r[1] for r in spans if r[0] in tracing.WORKER_STAGES}
    main = {r[1] for r in spans if r[0] in ("write", "writer_wait", "tile", "focus_scan")}
    assert main == {threading.main_thread().name} and not workers & main


def _boundary_cpg_extension(fasta_path, length, interval):
    """The bases by which ``--cpg --combine-strands`` moves tile ends, from
    the reference alone. A CpG's C at p is its '+' site and its G at p + 1
    the '-' site, each with a footprint of two bases, so [p, p + 3) stays
    in one tile: a tile end inside it moves to p + 3, until no CpG spans
    the end, and the next tile starts there."""
    seq = FastaReader(fasta_path).fetch(CHROM, 0, length).tobytes()
    cpg = {i for i in range(length - 1) if seq[i:i + 2] == b"CG"}
    start = extended = 0
    while start < length:
        nominal = end = min(start + interval, length)
        while end < length and (end - 1 in cpg or end - 2 in cpg):
            end = (end - 1 if end - 1 in cpg else end - 2) + 3
        end = min(end, length)
        extended += end - nominal
        start = end
    return extended


@pytest.mark.parametrize("focus", list(FOCUS))
def test_counters_add_up_and_rows_are_unchanged(bam, tmp_path, monkeypatch, focus):
    """Without a focus (20 kb tiles), and with ``--cpg``, strands combined
    or not, at 2 kb tiles: about one tile end in 16 falls inside a CpG."""
    kw = focus_flags(bam, focus)
    if kw:
        kw["interval_size"] = 2_000
    events = []
    real = native.decode_tile_bgzf

    def counted(*a, **k):
        out = real(*a, **k)
        if out is not None:
            events.append(out.n_events)
        return out

    monkeypatch.setattr(native, "decode_tile_bgzf", counted)
    res, recs = recorded(bam, tmp_path / "traced.bed", **kw)
    n_events = sum(events)
    plain = pileup(bam, tmp_path / "plain.bed", **kw)
    assert (tmp_path / "traced.bed").read_bytes() == (tmp_path / "plain.bed").read_bytes()
    assert res["rows"] == plain["rows"]

    def total(name):
        return sum(r[5] for r in recs if r[0] == name)

    assert total("rows") == res["rows"]
    assert total("events") == n_events > 0
    # the writer renders the motif route's rows itself: no natively formatted text
    assert total("out_bytes") == (0 if kw else os.path.getsize(tmp_path / "traced.bed"))
    assert total("bytes_down") == total("events")  # one state byte an event
    assert total("reads_decoded") >= res["reads_used"] + res["reads_skipped"]
    assert {tracing.ROUTES[r[5]] for r in recs if r[0] == "route"} == {"quals"}

    n_tiles = sum(1 for r in recs if r[0] == "tile")
    for name in ("focus_positions", "tile_extend_bp"):
        assert sorted(r[2] for r in recs if r[0] == name) == list(range(n_tiles))
    length = 150_000
    if focus == "none":
        expected = 0
    else:
        motifs = parse_motifs([], True)
        fasta = FastaReader(kw["reference_fasta"])
        if focus == "cpg":
            # each tile's scan of its own bases: a CpG across a tile end is in neither
            scans = [scan_focus_positions(motifs, fasta, CHROM, a, min(a + 2_000, length),
                                          None, 0) for a in range(0, length, 2_000)]
        else:
            scans = [scan_focus_positions_combine(
                motifs, fasta, CHROM, 0, length, 0, length)[0]]
        expected = sum(int((f.rule >= 0).sum()) for f in scans)
        assert expected > 1000
    assert total("focus_positions") == expected
    extended = 0
    if focus == "cpg_combined":
        extended = _boundary_cpg_extension(kw["reference_fasta"], length, 2_000)
        assert extended > 0
    assert total("tile_extend_bp") == extended
    # the native decode's walk: one of each a tile, the walked columns no
    # more than the aligned ones
    for name in ("aligned_columns", "walked_columns"):
        assert sorted(r[2] for r in recs if r[0] == name) == list(range(n_tiles))
    aligned = {r[2]: r[5] for r in recs if r[0] == "aligned_columns"}
    walked = {r[2]: r[5] for r in recs if r[0] == "walked_columns"}
    assert all(walked[t] <= aligned[t] for t in aligned)
    assert 0 < total("walked_columns") < total("aligned_columns")


@pytest.mark.parametrize("focus", ["none", "cpg"])
def test_the_walk_visits_a_share_of_the_aligned_columns(tmp_path, focus):
    """On the benchmark generator's modBAM (150 kb contig, 100 kb tiles):
    with a CpG focus the decode walks under a tenth of the reads' aligned
    columns (the focus columns inside each tile), without one over half
    (the columns inside each tile)."""
    _wl, cfg = bench_run.cell("allc-5mC5hmC-30x.pileup", {"contig_length": 150_000})
    bench_gen.generate(cfg, 7, str(tmp_path), workers=2)
    kw = {"cpg": True, "reference_fasta": str(tmp_path / "ref.fa")} if focus == "cpg" else {}
    _res, recs = recorded(str(tmp_path / "reads.bam"), tmp_path / "out.bed",
                          interval_size=100_000, no_filtering=True, **kw)
    aligned = [r for r in recs if r[0] == "aligned_columns"]
    walked = [r for r in recs if r[0] == "walked_columns"]
    assert sorted(r[2] for r in aligned) == sorted(r[2] for r in walked) == [0, 1]
    share = sum(r[5] for r in walked) / sum(r[5] for r in aligned)
    assert (share < 0.1) if focus == "cpg" else (share > 0.5)


@pytest.mark.parametrize("focus", ["none", "cpg_combined"])
def test_profile_on_the_cpu_writes_the_spans(bam, tmp_path, monkeypatch, focus):
    monkeypatch.setenv("MODKIT_TPU_PROFILE", str(tmp_path / "prof"))
    pileup(bam, tmp_path / "a.bed", **focus_flags(bam, focus))
    with open(tmp_path / "prof" / "trace.json") as fh:
        doc = json.load(fh)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == set(TILE_SPANS) | {"estimate"}
    tiles = [e for e in xs if e["name"] == "tile"]
    assert sorted(e["args"]["tile"] for e in tiles) == list(range(len(tiles)))
    assert all(e["args"]["route"] in tracing.ROUTES and "rows" in e["args"]
               for e in tiles)
    # the focus scan: one a tile, on the main thread's row; its counters
    # under the tile's ``tile`` span
    rows = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    scans = [e for e in xs if e["name"] == "focus_scan"]
    assert sorted(e["args"]["tile"] for e in scans) == list(range(len(tiles)))
    assert {rows[e["pid"]] for e in scans} == {
        f"modkit_tpu_torch {threading.main_thread().name}"}
    assert all(e["dur"] > 0 for e in scans) == (focus != "none")
    positions = [e["args"]["focus_positions"] for e in tiles]
    assert all(p > 0 for p in positions) if focus != "none" else not any(positions)
    assert all(e["args"]["tile_extend_bp"] >= 0 for e in tiles)
    # in-flight tiles take lanes of one row and never overlap on a lane
    lanes: dict = {}
    for e in sorted(tiles, key=lambda e: e["ts"]):
        assert e["ts"] >= lanes.get(e["tid"], float("-inf"))
        lanes[e["tid"]] = e["ts"] + e["dur"]


def test_the_map_onto_the_profilers_clock(tmp_path):
    """A span around a profiled op lands around it on the trace's clock
    (``baseTimeNanoseconds`` and the wall clock, as torch exports)."""
    rec = tracing.Records()
    tracing.set_sink(rec)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        for i in range(5):
            with tracing.span("dispatch", i):
                with record_function(f"op{i}"):
                    torch.ones(64).sum()
    finally:
        prof.stop()
        tracing.set_sink(None)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    ops = {e["name"]: e for e in doc["traceEvents"]
           if e.get("ph") == "X" and e["name"].startswith("op")}
    spans = rec.chrome_events(doc["baseTimeNanoseconds"])
    for ev in (e for e in spans if e.get("ph") == "X"):
        op = ops[f"op{ev['args']['tile']}"]
        # the op's interval lies inside the span, up to the map's error
        assert ev["ts"] - 50 <= op["ts"] and op["ts"] + op["dur"] <= ev["ts"] + ev["dur"] + 50


def test_records_survive_many_threads():
    rec = tracing.Records()
    n_threads, n = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n):
                rec.add("span", "decode", k * n + i, i, i + k, k)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    got = list(rec)
    assert len(got) == len(rec) == n_threads * n
    assert sorted(r[2] for r in got) == list(range(n_threads * n))
    assert all(r[4] - r[3] == r[5] for r in got)
    assert rec.nbytes == tracing.RECORD_BYTES * len(rec)


def test_records_hold_a_genome_under_100_mb():
    """A genome at 100 kb tiles: about 31 000 tiles, each with every span
    and counter once."""
    rec = tracing.Records()
    names = tracing.SPANS + tracing.COUNTERS
    for tile in range(31_000):
        for name in names:
            rec.add("span", name, tile, 10**15, 10**15 + 10**9, 2**40)
    assert len(rec) == 31_000 * len(names)
    assert rec.nbytes == tracing.RECORD_BYTES * len(rec)
    assert sys.getsizeof(rec._words) < 100e6
