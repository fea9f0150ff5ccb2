"""The per-layer metrics are data: each reader names the program's
attributes its spans and counters wrap, and the recorder wraps what the
readers of a run name."""

import json
import os
import types

import pytest

from benchmark import run, trace
from conftest import ROOT


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", [m["name"] for m in _spec()["per_layer"]])
def test_every_reader_names_live_targets(name):
    mod = run.load_metric(name)
    assert callable(mod.read)
    for targets in getattr(mod, "SPANS", {}).values():
        for t in targets:
            trace._resolve(t)
    for targets in getattr(mod, "COUNTS", {}).values():
        for t in targets:
            trace._resolve(t)


def test_a_missing_target_fails_the_run():
    gone = types.SimpleNamespace(SPANS={"x": ["modkit_tpu_torch.native:no_such_layer"]})
    with pytest.raises(AttributeError, match="no longer exists"):
        trace.Recorder().install([gone])


def test_each_target_is_wrapped_once_and_restored():
    from benchmark import gen

    target = "benchmark.gen:rng_for"
    counter = {"n": {target: None}}
    a = types.SimpleNamespace(SPANS={"fmt": [target]}, COUNTS=counter)
    b = types.SimpleNamespace(SPANS={"fmt": [target]}, COUNTS=counter)
    real = gen.rng_for
    rec = trace.Recorder()
    rec.install([a, b])
    try:
        assert gen.rng_for(3, 1).random() == real(3, 1).random()
    finally:
        rec.remove()
    assert gen.rng_for is real
    assert [s[0] for s in rec.spans] == ["fmt"] and rec.counts == {"n": 1}


def test_ms_per_tile_needs_spans_and_tiles():
    tr = trace.Trace([("decode", 0.0, 0.5), ("decode", 1.0, 1.5)], {"tiles": 4},
                     [], (0.0, 2.0), "")
    assert tr.ms_per_tile("decode") == pytest.approx(250.0)
    assert tr.ms_per_tile("format") is None
    assert trace.Trace([], {}, [], (0.0, 1.0), "").ms_per_tile("decode") is None
