"""The tracer of the pileup pipeline (``modkit_tpu_torch/tracing.py``):
spans and counters of every tile, on the CPU route.

With no sink nothing is kept; with a recording sink every tile has one
span of each stage, nested in time inside its ``tile`` span, its counters
add up to the run's, and the rows are those of a run with no sink.
``MODKIT_TPU_PROFILE`` writes the spans into ``trace.json`` on the
profiler's clock.
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
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth import make_synthetic_modbam

TILE = 20_000
# a tile's spans; ``estimate`` runs once, before the first tile
TILE_SPANS = ("tile", "queued", "decode", "export", "upload", "dispatch",
              "device_wait", "histogram", "format", "held", "writer_wait", "write")


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "s.bam")
    make_synthetic_modbam(path, n_reads=1200, read_len=2000, coverage=20.0,
                          seed=5, contig_len=150_000)
    return path


@pytest.fixture(autouse=True)
def no_profile(monkeypatch):
    monkeypatch.delenv("MODKIT_TPU_PROFILE", raising=False)
    monkeypatch.delenv("MODKIT_TPU_OFFLOAD", raising=False)
    yield
    tracing.set_sink(None)


def pileup(bam, out, **kw):
    return run_pileup(PileupConfig(in_bam=bam, out=str(out), interval_size=TILE,
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


@pytest.mark.parametrize("route", ["native", "empty", "python"])
def test_every_tile_has_each_stage_inside_its_tile(bam, tmp_path, monkeypatch, route):
    """On the native route, where every other tile has no reads (its
    stages then span zero time at the tile's end), and on the Python event
    route (one launcher, the native decoder off)."""
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
    res, recs = recorded(bam, tmp_path / "a.bed")
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
        assert t0 <= start <= end <= t1, (name, tile)
    workers = {r[1] for r in spans if r[0] in tracing.WORKER_STAGES}
    main = {r[1] for r in spans if r[0] in ("write", "writer_wait", "tile")}
    assert main == {threading.main_thread().name} and not workers & main


def test_counters_add_up_and_rows_are_unchanged(bam, tmp_path, monkeypatch):
    events = []
    real = native.decode_tile_bgzf

    def counted(*a, **k):
        out = real(*a, **k)
        if out is not None:
            events.append(out.n_events)
        return out

    monkeypatch.setattr(native, "decode_tile_bgzf", counted)
    res, recs = recorded(bam, tmp_path / "traced.bed")
    n_events = sum(events)
    plain = pileup(bam, tmp_path / "plain.bed")
    assert (tmp_path / "traced.bed").read_bytes() == (tmp_path / "plain.bed").read_bytes()
    assert res["rows"] == plain["rows"]

    def total(name):
        return sum(r[5] for r in recs if r[0] == name)

    assert total("rows") == res["rows"]
    assert total("events") == n_events > 0
    assert total("out_bytes") == os.path.getsize(tmp_path / "traced.bed")
    assert total("bytes_down") == total("events")  # one state byte an event
    assert total("reads_decoded") >= res["reads_used"] + res["reads_skipped"]
    assert {tracing.ROUTES[r[5]] for r in recs if r[0] == "route"} == {"quals"}


def test_profile_on_the_cpu_writes_the_spans(bam, tmp_path, monkeypatch):
    monkeypatch.setenv("MODKIT_TPU_PROFILE", str(tmp_path / "prof"))
    pileup(bam, tmp_path / "a.bed")
    with open(tmp_path / "prof" / "trace.json") as fh:
        doc = json.load(fh)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == set(TILE_SPANS) | {"estimate"}
    tiles = [e for e in xs if e["name"] == "tile"]
    assert sorted(e["args"]["tile"] for e in tiles) == list(range(len(tiles)))
    assert all(e["args"]["route"] in tracing.ROUTES and "rows" in e["args"]
               for e in tiles)
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
