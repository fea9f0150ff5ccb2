"""Pileup with more than 8 mod codes on one base: the port == modkit_tpu.

A modBAM whose reads call nine codes at every C (four letter codes and five
ChEBI ids, ``utils/synth_codes.py``, written with the port's own BAM
writer) goes through ``modkit_tpu``'s ``run_pileup`` and the port's CLI
with ``--device cpu``; the bedMethyl must be byte-equal. A tile then holds
M = 9 mod classes, which the port's engine pads to ``round_up_codes(9)``
and sends through the f32 state entry (the quals export takes at most 8);
on the CPU that is the kernel's plain version. The CUDA kernels at
M in {3, 9, 16} are held against the plain versions in test_torch_cuda.py.
"""

import filecmp
import subprocess
import sys

import numpy as np
import pytest

from modkit_tpu.pileup.runner import PileupConfig as RefConfig
from modkit_tpu.pileup.runner import run_pileup as ref_run
from modkit_tpu_torch.io.bam import BamReader
from modkit_tpu_torch.ops.counts import round_up_codes
from modkit_tpu_torch.pileup import engine as port_engine
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth_codes import NINE_CODES, make_multicode_modbam


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("many_codes") / "nine.bam")
    stats = make_multicode_modbam(path, n_reads=120, read_len=1500, seed=3)
    assert stats["codes"] == NINE_CODES and stats["n_mod_calls"] > 0
    return path


def test_nine_codes_in_the_modbam(bam):
    reader = BamReader(bam)
    _, mm = next(iter(reader)).get_aux("MM")
    if isinstance(mm, bytes):
        mm = mm.decode()
    assert [e.split("?")[0] for e in mm.rstrip(";").split(";")] == [
        f"C+{c}" for c in NINE_CODES]
    assert round_up_codes(len(NINE_CODES)) == 9


@pytest.mark.parametrize("flags,ref_kw", [
    (["--no-filtering"], dict(no_filtering=True)),
    (["--filter-threshold", "0.1"], dict(filter_threshold={"default": 0.1})),
])
def test_cli_on_the_cpu_equals_modkit_tpu(tmp_path, bam, flags, ref_kw):
    ref_out, port_out = str(tmp_path / "ref.bed"), str(tmp_path / "port.bed")
    ref_run(RefConfig(in_bam=bam, out=ref_out, suppress_progress=True,
                      **ref_kw))
    proc = subprocess.run(
        [sys.executable, "-m", "modkit_tpu_torch", "pileup", bam, port_out,
         "--device", "cpu", "--suppress-progress", *flags],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert filecmp.cmp(ref_out, port_out, shallow=False)
    codes = {line.split("\t")[3] for line in open(port_out)}
    assert codes == set(NINE_CODES)


def test_engine_sends_nine_classes_through_the_f32_entry(tmp_path, bam,
                                                         monkeypatch):
    seen = []
    fn = port_engine.threshold_state_f32

    def spy(probs, *a, **kw):
        seen.append(tuple(probs.shape))
        return fn(probs, *a, **kw)

    monkeypatch.setattr(port_engine, "threshold_state_f32", spy)
    # modkit_tpu's side takes its device route; the port has only one
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")
    ref_out, port_out = str(tmp_path / "ref.bed"), str(tmp_path / "port.bed")
    ref_run(RefConfig(in_bam=bam, out=ref_out, no_filtering=True,
                      suppress_progress=True))
    run_pileup(PileupConfig(in_bam=bam, out=port_out, no_filtering=True,
                            suppress_progress=True, device="cpu"))
    assert seen and all(m == 9 for _, m in seen)
    assert np.sum([n for n, _ in seen]) > 0
    assert filecmp.cmp(ref_out, port_out, shallow=False)


def test_python_event_route_sends_nine_classes_through_the_count_entry(
        tmp_path, bam, monkeypatch):
    """With the native decoder off, the tile's events go through
    ``modcall_counts`` (kernel B) at M = 9; the bytes equal modkit_tpu's."""
    seen = []
    fn = port_engine.modcall_counts

    def spy(rpos, strand, base, probs, *a, **kw):
        seen.append(tuple(probs.shape))
        return fn(rpos, strand, base, probs, *a, **kw)

    monkeypatch.setattr(port_engine, "modcall_counts", spy)
    # modkit_tpu's side takes its device route; the port has only one
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")
    monkeypatch.setenv("MODKIT_TPU_DISABLE_NATIVE", "1")
    ref_out, port_out = str(tmp_path / "ref.bed"), str(tmp_path / "port.bed")
    ref_run(RefConfig(in_bam=bam, out=ref_out, no_filtering=True,
                      suppress_progress=True))
    run_pileup(PileupConfig(in_bam=bam, out=port_out, no_filtering=True,
                            suppress_progress=True, device="cpu"))
    assert seen and all(m == 9 for _, m in seen)
    assert filecmp.cmp(ref_out, port_out, shallow=False)
