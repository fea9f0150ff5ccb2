"""A whole run on the CPU, with the harness's look for a card skipped: a
sound run is correct and its result line has the contract's keys; with
the timed path broken underneath, ``correct`` comes out false. The same
for a call set on two bases (``conftest.TWO_BASE``), with thresholds
handed in and with the estimate."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from conftest import CELLS, ROOT, SMALL, TWO_BASE, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device", "build_s", "checks"]


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _names(kind, workload):
    """The metrics of ``kind`` that BENCHMARK.json gives ``workload``."""
    return {m["name"] for m in _spec()[kind] if workload in m.get("workloads", [workload])}


def _run(workload, seed=2**32 + 5, trace=False):
    return run.run_cell(workload, seed, 0.5, trace, device="cpu", data_override=SMALL,
                        cell_spec=spec(workload) if workload in TWO_BASE else None)


@pytest.mark.parametrize("workload", CELLS + tuple(TWO_BASE))
def test_sound_run(workload):
    res = _run(workload)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == _names("end_to_end", workload)
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    assert res["device"]["platform"] == "cpu" and res["build_s"] >= 0
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("workload", [CELLS[0], CELLS[2], CELLS[3]])
def test_traced_run_reports_host_layers(workload):
    res = _run(workload, trace=True)
    assert res["correct"] is True
    # the CPU has no device trace: only the host's metrics are read
    device = {m["name"] for m in _spec()["per_layer"] if m["source"] == "device_trace"}
    assert set(res["metrics"]) == _names("per_layer", workload) - device


def _alter_text(monkeypatch):
    from modkit_tpu_torch import native

    real = native.format_rows

    def altered(*a, **k):
        out = real(*a, **k)
        text, n = out
        return text.replace(b"\t0\n", b"\t1\n", 1), n
    monkeypatch.setattr(native, "format_rows", altered)


def _alter_rows(monkeypatch):
    """One count of the first row that the motif route formats."""
    from modkit_tpu_torch.pileup import engine

    real = engine.decode_counts_columnar

    def altered(*a, **k):
        out = real(*a, **k)
        if len(out):
            out.n_can[0] += 1
        return out
    monkeypatch.setattr(engine, "decode_counts_columnar", altered)


def _alter_a_row(monkeypatch):
    """One count of the first row of 6mA (code ``a``) that the C++
    formatting writes."""
    from modkit_tpu_torch import native

    real = native.format_rows

    def altered(*a, **k):
        text, n = real(*a, **k)
        lines = text.split(b"\n")
        for i, line in enumerate(lines):
            f = line.split(b"\t")
            if len(f) > 12 and f[3] == b"a":
                f[12] = str(int(f[12]) + 1).encode()  # N_canonical
                lines[i] = b"\t".join(f)
                return b"\n".join(lines), n
        return text, n
    monkeypatch.setattr(native, "format_rows", altered)


def _drop_half(monkeypatch):
    from modkit_tpu_torch.pileup.engine import TileProcessor

    real = TileProcessor.launch_tile

    def half(self, reader, tid, start, end, focus=None):
        if (start // 100000) % 2:
            return None
        return real(self, reader, tid, start, end, focus)
    monkeypatch.setattr(TileProcessor, "launch_tile", half)


def _state_unchanged(monkeypatch):
    from modkit_tpu_torch.pileup import engine

    for name in ("threshold_state_quals_t", "threshold_state_f32"):
        real = getattr(engine, name)

        def zeros(*a, _real=real, **k):
            return torch.zeros_like(_real(*a, **k))
        monkeypatch.setattr(engine, name, zeros)


def _shift_threshold(monkeypatch, only=None):
    """The estimate one step of the confidences' 1/512 grid higher (of the
    base ``only``, or of every base)."""
    from modkit_tpu_torch import thresholds

    real = thresholds.estimate_thresholds

    def shifted(*a, **k):
        return {b: t + (1 / 512 if only in (None, b) else 0)
                for b, t in real(*a, **k).items()}
    monkeypatch.setattr(thresholds, "estimate_thresholds", shifted)


def _half_sampled(monkeypatch, only=None):
    """Half of the estimate's sample left out: the percentile taken over the
    first half of the pooled confidences (of the base index ``only``, or of
    every base)."""
    from modkit_tpu_torch import thresholds

    real = thresholds.sample_reads

    def half(*a, **k):
        out = real(*a, **k)
        if k.get("confidences_only"):
            out = {b: v[:len(v) // 2] if only in (None, b) else v for b, v in out.items()}
        return out
    monkeypatch.setattr(thresholds, "sample_reads", half)


FAULTS = {
    "answer_altered": {CELLS[0]: _alter_text, CELLS[1]: _alter_rows, CELLS[2]: _alter_rows,
                       CELLS[3]: _alter_text, "two-base.pileup": _alter_a_row,
                       "two-base.estimate": _alter_a_row},
    "half_left_out": {c: _drop_half for c in CELLS + ("two-base.pileup",)},
    "state_unchanged": {c: _state_unchanged for c in CELLS + ("two-base.pileup",)},
    "threshold_shifted": {CELLS[3]: _shift_threshold,
                          "two-base.estimate": lambda m: _shift_threshold(m, "A")},
    "half_sampled": {CELLS[3]: _half_sampled,
                     "two-base.estimate": lambda m: _half_sampled(m, run.BASE_INDEX["A"])},
}
# the checks that each fault has to trip; the rest trip the output's two
CAUGHT_BY = {
    "threshold_shifted": ("jobs_differing", "rows_differing", "threshold_differing"),
    "half_sampled": ("pool_differing",),
}


@pytest.mark.parametrize("fault,workload",
                         [(f, c) for f in sorted(FAULTS) for c in CELLS + tuple(TWO_BASE)
                          if c in FAULTS[f]])
def test_fault_is_caught(monkeypatch, workload, fault):
    FAULTS[fault][workload](monkeypatch)
    res = _run(workload)
    assert res["correct"] is False
    for check in CAUGHT_BY.get(fault, ("jobs_differing", "rows_differing")):
        assert res["checks"][check]["value"] >= 1


def test_no_card_no_result():
    """Without a CUDA device the benchmark exits non-zero and prints no
    result line."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_rows_differing_counts_multiplicity():
    a = b"x\ny\ny\n"
    assert run.rows_differing(a, b"x\ny\n") == 1
    assert run.rows_differing(a, a) == 0
    assert np.isfinite(run.RSS_PERIOD_S)
