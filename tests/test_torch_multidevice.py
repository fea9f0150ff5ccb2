"""1 vs N devices: the port's pileup round-robins its tiles over
``parallel.devices.compute_devices`` (``TileProcessor._next_device``), and
the bedMethyl is byte-equal at 1 and 4 devices, and to modkit_tpu's.

Here the N devices are the CPU listed N times (``compute_devices`` patched
to return them), so every tile takes the plain call; on a card the same
test with ``cuda:0`` listed N times runs in ``tests/test_torch_cuda.py``.
Template: ``tests/test_multidevice_pileup.py``.
"""

import filecmp

import pytest
import torch

from modkit_tpu.pileup.runner import PileupConfig as RefConfig
from modkit_tpu.pileup.runner import run_pileup as ref_run
from modkit_tpu_torch.parallel import devices
from modkit_tpu_torch.pileup.engine import TileProcessor
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth import make_synthetic_modbam

INTERVAL = 2_000


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_multidevice") / "s.bam")
    make_synthetic_modbam(path, n_reads=300, read_len=1000, coverage=10.0,
                          seed=12)
    return path


MODES = {"no-filtering": dict(no_filtering=True),
         "estimate": dict(sample_frac=1.0, filter_percentile=0.25)}


@pytest.mark.parametrize("mode", list(MODES))
def test_pileup_byte_equal_at_1_and_4_devices(tmp_path, bam, monkeypatch,
                                              mode):
    picked = []
    next_device = TileProcessor._next_device

    def counting(self):
        d = next_device(self)
        picked.append((len(self.devices), d))
        return d

    monkeypatch.setattr(TileProcessor, "_next_device", counting)
    outs = {}
    for n in (1, 4):
        monkeypatch.setattr(devices, "compute_devices",
                            lambda device, n=n: [torch.device("cpu")] * n)
        picked.clear()
        outs[n] = str(tmp_path / f"port{n}.bed")
        run_pileup(PileupConfig(in_bam=bam, out=outs[n],
                                interval_size=INTERVAL, device="cpu",
                                suppress_progress=True, **MODES[mode]))
        # every tile with events picked a device from a list of n
        assert len(picked) > 8
        assert {k for k, _ in picked} == {n}
    ref_out = str(tmp_path / "ref.bed")
    ref_run(RefConfig(in_bam=bam, out=ref_out, interval_size=INTERVAL,
                      suppress_progress=True, **MODES[mode]))
    assert filecmp.cmp(outs[1], outs[4], shallow=False)
    assert filecmp.cmp(outs[4], ref_out, shallow=False)
    assert open(ref_out).read().count("\n") > 1000


def test_next_device_round_robins(monkeypatch):
    from modkit_tpu_torch.caller import ThresholdCaller
    from modkit_tpu_torch.pileup.engine import PileupOptions

    names = [torch.device("cpu")] * 3
    monkeypatch.setattr(devices, "compute_devices", lambda device: names)
    proc = TileProcessor(ThresholdCaller.passthrough(),
                         PileupOptions(device="cpu"))
    assert proc.devices == names
    for _ in range(7):
        proc._next_device()
    assert proc._dev_rr == 7
