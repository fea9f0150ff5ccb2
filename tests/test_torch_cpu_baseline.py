"""The port's all-C++ CPU baseline and the native entries it and the
measuring tools use, against modkit_tpu.

- ``modkit_tpu_torch.cpu_baseline.run_pileup_cpu`` (a byte-equal copy of
  ``modkit_tpu/cpu_baseline.py`` over the port's own ``native``, ``caller``,
  ``io.bam`` and ``thresholds``) writes the bedMethyl of
  ``modkit_tpu.cpu_baseline.run_pileup_cpu`` and of the port's
  ``run_pileup(device="cpu")``, with no filtering and with the default
  threshold estimate, at 1 and 4 threads (``tests/test_cpu_baseline.py``'s
  synthetic modBAM: 300 reads x 2 kb).
- ``NativeTile.bincount_states``, ``NativeTile.export_quals`` and
  ``bench_decode`` equal modkit_tpu's on the same tile and record;
  ``export_quals`` is None on a collapse tile, as the original's is.
"""

import numpy as np
import pytest

from modkit_tpu import native as ref_native
from modkit_tpu.cpu_baseline import run_pileup_cpu as ref_run_pileup_cpu
from modkit_tpu.utils.synth import make_synthetic_modbam
from modkit_tpu_torch import native
from modkit_tpu_torch.caller import ThresholdCaller
from modkit_tpu_torch.collapse import CollapseMethod
from modkit_tpu_torch.cpu_baseline import run_pileup_cpu
from modkit_tpu_torch.io.bam import BamReader
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cpu_baseline") / "b.bam")
    make_synthetic_modbam(path, n_reads=300, read_len=2000, coverage=15.0)
    return path


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("mode", ["no-filtering", "estimate"])
def test_cpu_baseline_equals_modkit_tpu_and_the_engine(bam, tmp_path,
                                                       monkeypatch, mode,
                                                       threads):
    # modkit_tpu's side keeps its default policy; the port reads nothing
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "auto")
    no_filtering = mode == "no-filtering"
    port = str(tmp_path / "port.bed")
    ref = str(tmp_path / "ref.bed")
    eng = str(tmp_path / "engine.bed")
    res = run_pileup_cpu(bam, port, threads=threads,
                         no_filtering=no_filtering)
    ref_res = ref_run_pileup_cpu(bam, ref, threads=threads,
                                 no_filtering=no_filtering)
    run_pileup(PileupConfig(in_bam=bam, out=eng, no_filtering=no_filtering,
                            suppress_progress=True, device="cpu"))
    assert res == ref_res and res["rows"] > 0
    assert _read(port) == _read(ref) == _read(eng)


def _tiles(path, collapse=None):
    """Each 2 kb tile of the first contig decoded by both packages."""
    reader = BamReader(path)
    length = reader.header.refs[0].length
    for start in range(0, min(length, 20_000), 2_000):
        chunks = reader.fetch_chunks_raw(0, start, start + 2_000)
        kw = dict(max_depth=8000, n_threads=1)
        if collapse is not None:
            kw["collapse"] = collapse
        yield (native.decode_tile(chunks, 0, start, start + 2_000, **kw),
               ref_native.decode_tile(chunks, 0, start, start + 2_000, **kw))


def test_bincount_states_and_export_quals_equal_modkit_tpu(bam):
    rng = np.random.default_rng(3)
    seen = 0
    for tile, ref in _tiles(bam):
        assert tile.n_events == ref.n_events
        if not tile.n_events:
            continue
        seen += 1
        m_pad = {1: 1, 2: 2}.get(tile.m, 4)
        caller = ThresholdCaller({"C": 0.6}, {}, 0.0)
        thr_mod, thr_can = caller.threshold_arrays(tile.vocab)
        states = tile.threshold_states_cpu(thr_mod.astype(np.float32),
                                           thr_can.astype(np.float32))
        assert np.array_equal(
            states, ref.threshold_states_cpu(thr_mod.astype(np.float32),
                                             thr_can.astype(np.float32)))
        got = tile.bincount_states(states, m_pad)
        assert got.shape == (2_000, 2, 1 + 4 * (m_pad + 1))
        assert np.array_equal(got, ref.bincount_states(states, m_pad))
        # arbitrary states in range, too
        other = rng.integers(0, 2 + tile.m, tile.n_events).astype(np.uint8)
        assert np.array_equal(tile.bincount_states(other, m_pad),
                              ref.bincount_states(other, m_pad))
        for n_pad in (tile.n_events, tile.n_events + 5):
            q, rq = tile.export_quals(n_pad, m_pad), ref.export_quals(
                n_pad, m_pad)
            assert q is not None and rq is not None
            for a, b in zip(q, rq):
                assert a.dtype == b.dtype and np.array_equal(
                    a[:tile.n_events], b[:tile.n_events])
            # the events-major export is the class-major one transposed
            qt = tile.export_quals_t(n_pad, m_pad)
            assert np.array_equal(q[0][:tile.n_events].T,
                                  qt[0][:, :tile.n_events])
    assert seen >= 3


def test_export_quals_is_none_on_a_collapse_tile(bam):
    collapse = [CollapseMethod("dist", ("h",))]
    seen = 0
    for tile, ref in _tiles(bam, collapse=collapse):
        if not tile.n_events:
            continue
        seen += 1
        assert tile.export_quals(tile.n_events, 1) is None
        assert ref.export_quals(tile.n_events, 1) is None
    assert seen >= 3


def test_bench_decode_runs_every_stage(bam):
    rec = next(iter(BamReader(bam)))._buf
    for stage in range(5):
        rate = native.bench_decode(rec, reps=200, stage=stage)
        assert rate > 0, stage
        assert ref_native.bench_decode(rec, reps=200, stage=stage) > 0

