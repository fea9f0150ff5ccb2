"""The forced-device percentile sort of every threshold estimate.

Under MODKIT_TPU_OFFLOAD=always, modkit_tpu sorts every estimate's
confidences on its device whatever the caller passes
(``modkit_tpu/thresholds.py``). The port does the same: a caller that
passes no device (``adjust-mods``, ``call-mods``, ``extract calls``,
``pileup-hemi``, ``summary``) gets ``"cuda"`` through ``resolve_device``,
which raises without a card; a caller that passes one (pileup's run
device) keeps it. Under ``auto`` and ``never`` the host keeps the sort and
no device is touched.
"""

import contextlib
import filecmp
import io
import sys

import numpy as np
import pytest
import torch

from modkit_tpu import thresholds as ref_thresholds
from modkit_tpu.cli import main as ref_main
from modkit_tpu.io.bam import BamReader as RefReader
from modkit_tpu_torch import thresholds
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.bam import BamReader
from modkit_tpu_torch.parallel import devices
from modkit_tpu_torch.utils.synth import make_synthetic_modbam


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_thresholds") / "s.bam")
    make_synthetic_modbam(path, n_reads=150, read_len=1200, coverage=10.0,
                          seed=31)
    return path


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("cmd", [
    ["call-mods", "{bam}", "{out}", "--seed", "3"],
    ["adjust-mods", "{bam}", "{out}", "--filter-probs", "--seed", "3"],
    ["summary", "{bam}", "--seed", "3"],
])
def test_forced_sort_without_a_card_raises(cmd, bam, tmp_path, monkeypatch,
                                           no_card):
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")
    out = str(tmp_path / "o.bam")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main([x.format(bam=bam, out=out) for x in cmd])


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
def test_forced_sort_on_the_cpu_equals_the_host_sort_and_modkit_tpu(
        q, bam, monkeypatch):
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "never")
    host = thresholds.estimate_thresholds(BamReader(bam), filter_percentile=q,
                                          seed=2)
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")
    calls = []
    sort = thresholds._device_sorted

    def spy(xs, device):
        calls.append(torch.device(device))
        return sort(xs, device)

    monkeypatch.setattr(thresholds, "_device_sorted", spy)
    cuda_sorts = thresholds.CUDA_SORTS
    forced = thresholds.estimate_thresholds(
        BamReader(bam), filter_percentile=q, seed=2, device="cpu")
    ref = ref_thresholds.estimate_thresholds(
        RefReader(bam), filter_percentile=q, seed=2)
    assert calls and all(d.type == "cpu" for d in calls)
    assert thresholds.CUDA_SORTS == cuda_sorts
    assert forced == host == ref
    assert set(forced) == {"C"}


def test_forced_sort_counts_only_cuda_tensors():
    xs = np.random.default_rng(4).random(1000).astype(np.float32)
    before = thresholds.CUDA_SORTS
    got = thresholds.percentile_linear_interp_device(xs, 0.25, "cpu")
    assert got == thresholds.percentile_linear_interp(np.sort(xs), 0.25)
    assert thresholds.CUDA_SORTS == before


@pytest.mark.parametrize("mode", ["auto", "never"])
def test_auto_and_never_keep_the_host_sort(mode, bam, tmp_path, monkeypatch,
                                           no_card):
    """``call-mods`` with the default estimate: equal to modkit_tpu's, with
    no device resolved and no sort off the host."""
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", mode)
    monkeypatch.setattr(sys, "argv", ["modkit"])  # the @PG command line

    def refuse(*_a, **_k):
        raise AssertionError("the estimate touched a torch device")

    monkeypatch.setattr(devices, "resolve_device", refuse)
    monkeypatch.setattr(thresholds, "_device_sorted", refuse)
    outs = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.bam")
        assert _run(main, ["call-mods", bam, out, "--seed", "3"])[0] == 0
        outs.append(out)
    assert filecmp.cmp(*outs, shallow=False)
