"""The percentile sort of every threshold estimate.

The port sorts every estimate's confidences on the host (``np.sort``),
whatever ``MODKIT_TPU_OFFLOAD`` says. modkit_tpu still reads the variable:
under ``always`` it sorts on its device (``jnp.sort``), so these tests set
it for modkit_tpu's side and hold the port's thresholds and bytes to
modkit_tpu's.
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


def _refuse_the_card(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the estimate touched a torch device or sort")

    monkeypatch.setattr(devices, "resolve_device", refuse)
    monkeypatch.setattr(torch, "sort", refuse)


@pytest.mark.parametrize("cmd", [
    ["call-mods", "{bam}", "{out}", "--seed", "3"],
    ["adjust-mods", "{bam}", "{out}", "--filter-probs", "--seed", "3"],
    ["summary", "{bam}", "--seed", "3"],
])
def test_host_subcommands_sort_on_the_host_under_always(
        cmd, bam, tmp_path, monkeypatch, no_card):
    """``call-mods``, ``adjust-mods`` and ``summary`` estimate without a
    card under ``MODKIT_TPU_OFFLOAD=always`` (modkit_tpu's side sorts on
    its device), with no device resolved and no torch sort, and write
    modkit_tpu's bytes."""
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")
    monkeypatch.setattr(sys, "argv", ["modkit"])  # the @PG command line
    _refuse_the_card(monkeypatch)
    outs = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.bam")
        rc, text = _run(main, [x.format(bam=bam, out=out) for x in cmd])
        assert rc == 0
        outs.append(out if "{out}" in cmd else text)
    if "{out}" in cmd:
        assert filecmp.cmp(*outs, shallow=False)
    else:
        assert outs[0] == outs[1] and outs[1]


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
def test_forced_sort_on_the_cpu_equals_the_host_sort_and_modkit_tpu(
        q, bam, monkeypatch):
    """The port's estimate (sorted on the host) equals modkit_tpu's under
    ``MODKIT_TPU_OFFLOAD=always`` (its forced ``jnp.sort``, on the CPU
    here) and under ``never`` (its host sort)."""
    got = thresholds.estimate_thresholds(BamReader(bam), filter_percentile=q,
                                         seed=2)
    refs = []
    for mode in ("always", "never"):
        # read by modkit_tpu's side only
        monkeypatch.setenv("MODKIT_TPU_OFFLOAD", mode)
        refs.append(ref_thresholds.estimate_thresholds(
            RefReader(bam), filter_percentile=q, seed=2))
    assert refs == [got, got]
    assert set(got) == {"C"}


@pytest.mark.parametrize("q", [0.0, 0.25, 1.0])
def test_host_percentile_equals_modkit_tpus_device_percentile(q):
    """The one percentile the port keeps (``np.sort`` + linear
    interpolation) is bit-identical to modkit_tpu's device percentile."""
    xs = np.random.default_rng(4).random(4097).astype(np.float32)
    got = thresholds.percentile_linear_interp(np.sort(xs), q)
    want = ref_thresholds.percentile_linear_interp_device(xs, q)
    assert np.float32(got) == np.float32(want)


@pytest.mark.parametrize("mode", ["auto", "never", "always"])
def test_auto_and_never_keep_the_host_sort(mode, bam, tmp_path, monkeypatch,
                                           no_card):
    """``call-mods`` with the default estimate under each of modkit_tpu's
    modes: equal to modkit_tpu's, with no device resolved and no torch
    sort."""
    # read by modkit_tpu's side only
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", mode)
    monkeypatch.setattr(sys, "argv", ["modkit"])  # the @PG command line
    _refuse_the_card(monkeypatch)
    outs = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.bam")
        assert _run(main, ["call-mods", bam, out, "--seed", "3"])[0] == 0
        outs.append(out)
    assert filecmp.cmp(*outs, shallow=False)
