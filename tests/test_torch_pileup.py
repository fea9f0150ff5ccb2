"""modkit_tpu_torch's pileup is byte-equal to modkit_tpu's, mode by mode.

One small synthetic modBAM (300 reads x 2 kb, with its FASTA) goes through
``modkit_tpu.pileup.runner.run_pileup`` and the port's ``run_pileup`` with
``device="cpu"``; every output file must be byte-equal (``cmp``). On the
CPU the port's engine runs the plain PyTorch versions of its kernels, and
each case checks which of them the run went through. The modes of the
other half of the matrix are in test_torch_pileup_modes.py.
"""

import filecmp
import os

import numpy as np
import pytest

import modkit_tpu.collapse as jax_collapse
import modkit_tpu_torch.collapse as port_collapse
from modkit_tpu.pileup.runner import PileupConfig as RefConfig
from modkit_tpu.pileup.runner import run_pileup as ref_run
from modkit_tpu.utils.synth import make_synthetic_modbam
from modkit_tpu_torch import thresholds as port_thresholds
from modkit_tpu_torch.pileup import engine as port_engine
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth import (
    make_synthetic_modbam as port_make_synthetic_modbam,
)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pileup")
    bam, fa = str(d / "s.bam"), str(d / "s.fa")
    make_synthetic_modbam(
        bam, n_reads=300, read_len=2000, coverage=20.0, seed=11, fasta_out=fa
    )
    return bam, fa


@pytest.fixture
def op_calls(monkeypatch):
    """Counts the port engine's calls of its three device ops."""
    calls = {}
    for name in ("threshold_state_quals_t", "threshold_state_f32",
                 "modcall_counts"):
        fn = getattr(port_engine, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_engine, name, spy)
    return calls


def run_both(tmp_path, bam, ref_kw, port_kw, out_is_dir=False):
    """Run both packages; return the list of compared output names."""
    ref_out = str(tmp_path / "ref")
    port_out = str(tmp_path / "port")
    if not out_is_dir:
        ref_out += ".bed"
        port_out += ".bed"
    ref_run(RefConfig(in_bam=bam, out=ref_out, suppress_progress=True,
                      **ref_kw))
    run_pileup(PileupConfig(in_bam=bam, out=port_out, suppress_progress=True,
                            device="cpu", **port_kw))
    if not out_is_dir:
        assert os.path.getsize(ref_out) > 0
        assert filecmp.cmp(ref_out, port_out, shallow=False)
        return [ref_out]
    names = sorted(os.listdir(ref_out))
    assert names and names == sorted(os.listdir(port_out))
    for f in names:
        assert filecmp.cmp(
            os.path.join(ref_out, f), os.path.join(port_out, f),
            shallow=False,
        ), f
    return names


def test_synth_copy_writes_the_same_bytes(tmp_path):
    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    fa, fb = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    sa = make_synthetic_modbam(a, n_reads=50, read_len=500, seed=4,
                               fasta_out=fa)
    sb = port_make_synthetic_modbam(b, n_reads=50, read_len=500, seed=4,
                                    fasta_out=fb)
    assert sa == sb
    for x, y in ((a, b), (a + ".bai", b + ".bai"), (fa, fb)):
        assert filecmp.cmp(x, y, shallow=False)


def test_no_filtering(tmp_path, synth, op_calls):
    run_both(tmp_path, synth[0], dict(no_filtering=True),
             dict(no_filtering=True))
    assert set(op_calls) == {"threshold_state_quals_t"}


def test_filter_threshold(tmp_path, synth, op_calls):
    kw = dict(filter_threshold={"default": 0.7, "C": 0.66})
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls.get("threshold_state_quals_t")


def test_estimated_thresholds(tmp_path, synth, op_calls):
    kw = dict(sample_frac=1.0, seed=5)
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls.get("threshold_state_quals_t")


def test_estimated_thresholds_device_sort(tmp_path, synth, monkeypatch):
    """Under MODKIT_TPU_OFFLOAD=always modkit_tpu sorts the confidences on
    its device (jnp.sort); the port, which reads no such variable, sorts
    them on the host and writes the same bedMethyl."""
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")  # modkit_tpu's side
    sorted_n = []
    interp = port_thresholds.percentile_linear_interp

    def spy(xs, q):
        assert isinstance(xs, np.ndarray)
        sorted_n.append(len(xs))
        return interp(xs, q)

    monkeypatch.setattr(port_thresholds, "percentile_linear_interp", spy)
    kw = dict(num_reads=200, seed=5)
    run_both(tmp_path, synth[0], kw, kw)
    assert sorted_n and all(n >= 2 for n in sorted_n)


def test_mod_thresholds(tmp_path, synth, op_calls):
    kw = dict(filter_threshold={"default": 0.6}, mod_thresholds={"h": 0.9})
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls.get("threshold_state_quals_t")


def test_ignore_takes_the_f32_state_path(tmp_path, synth, op_calls):
    run_both(
        tmp_path, synth[0],
        dict(filter_threshold={"default": 0.6},
             collapse=[jax_collapse.CollapseMethod("dist", ("h",))]),
        dict(filter_threshold={"default": 0.6},
             collapse=[port_collapse.CollapseMethod("dist", ("h",))]),
    )
    assert op_calls.get("threshold_state_f32")
    assert not op_calls.get("threshold_state_quals_t")


def test_combine_mods(tmp_path, synth, op_calls):
    kw = dict(no_filtering=True, combine_mods=True)
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls.get("threshold_state_quals_t")
