"""modkit_tpu_torch stands alone: no jax, no modkit_tpu, no silent CPU.

- An AST scan of every module of the port and of chip_smoke.py finds no
  import of ``jax`` or ``modkit_tpu`` (whole names: ``modkit_tpu_torch`` is
  the port itself).
- The port's CLI runs in a process where both are blocked, and its output
  is byte-equal (``cmp``) to modkit_tpu's on the same synthetic modBAM:
  ``pileup``, and the downstream ``extract calls`` (native stream, default
  threshold estimate) and ``dmr pair`` (over regions and per site, on the
  port's own bedMethyls); so does the count-kernel lab's entry point,
  ``tools/kernel_lab.py``.
- Without a CUDA device, an entry point that did not ask for the CPU
  raises instead of running there; a multi-host run whose coordinator
  cannot be reached fails with the fatal init error. (CRAM input runs:
  tests/test_torch_cram.py; multi-host runs: tests/test_torch_multihost.py.)
"""

import ast
import filecmp
import os
import subprocess
import sys

import pytest
import torch

from modkit_tpu.cli import main as ref_main
from modkit_tpu.pileup.runner import PileupConfig as RefConfig
from modkit_tpu.pileup.runner import run_pileup as ref_run
from modkit_tpu.utils.synth import make_synthetic_modbam
from modkit_tpu_torch.cli import build_parser
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.bam import build_bai
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from tests.test_torch_dmr import _run, port_bedmethyl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "modkit_tpu")


def _port_files():
    root = os.path.join(REPO, "modkit_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_modkit_tpu():
    files = list(_port_files())
    assert len(files) > 20
    bad = [
        (os.path.relpath(f, REPO), name)
        for f in files
        for name in _imported_names(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_isolation")
    path = str(d / "s.bam")
    make_synthetic_modbam(path, n_reads=120, read_len=1500, coverage=15.0,
                          seed=21)
    return path


def test_cli_runs_with_jax_and_modkit_tpu_blocked(tmp_path, bam):
    ref_out, port_out = str(tmp_path / "ref.bed"), str(tmp_path / "port.bed")
    ref_run(RefConfig(in_bam=bam, out=ref_out, no_filtering=True,
                      suppress_progress=True))
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        f"sys.argv = ['modkit_tpu_torch', 'pileup', {bam!r}, {port_out!r},"
        " '--device', 'cpu', '--no-filtering', '--suppress-progress']\n"
        "runpy.run_module('modkit_tpu_torch', run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert filecmp.cmp(ref_out, port_out, shallow=False)


def test_extract_and_dmr_run_with_jax_and_modkit_tpu_blocked(tmp_path):
    a_bam, fa = str(tmp_path / "a.bam"), str(tmp_path / "ref.fa")
    make_synthetic_modbam(a_bam, n_reads=120, read_len=1500, coverage=15.0,
                          seed=22, fasta_out=fa)
    b_bam = str(tmp_path / "b.bam")
    assert _run(port_main, ["adjust-mods", a_bam, b_bam, "--convert", "h",
                            "m"])[0] == 0
    build_bai(b_bam)
    a, b = (port_bedmethyl(x, str(tmp_path / f"{n}.bed"))
            for x, n in ((a_bam, "a"), (b_bam, "b")))
    roi = str(tmp_path / "roi.bed")
    with open(roi, "w") as fh:
        fh.writelines(f"synth1\t{s}\t{s + 800}\tr{s}\n"
                      for s in range(0, 11_000, 1000))
    templates = (
        ["extract", "calls", a_bam, "{out}.tsv", "--seed", "3"],
        ["dmr", "pair", "-a", a, "-b", b, "-r", roi, "--ref", fa, "--base",
         "C", "-o", "{out}.roi.bed"],
        ["dmr", "pair", "-a", a, "-b", b, "--ref", fa, "--base", "C", "-o",
         "{out}.sites.bed"],
    )
    ref_out, port_out = str(tmp_path / "ref"), str(tmp_path / "port")
    for t in templates:
        assert _run(ref_main, [x.format(out=ref_out) for x in t])[0] == 0
    calls = [[x.format(out=port_out) for x in t] for t in templates]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        "from modkit_tpu_torch.cli import main\n"
        f"for argv in {calls!r}:\n"
        "    assert main(argv) == 0\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    for suffix in (".tsv", ".roi.bed", ".sites.bed"):
        assert os.path.getsize(port_out + suffix) > 0
        assert filecmp.cmp(ref_out + suffix, port_out + suffix,
                           shallow=False), suffix


def test_kernel_lab_runs_with_jax_and_modkit_tpu_blocked():
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        "sys.argv = ['kernel_lab', '--device', 'cpu', '--events', '4000',"
        " '--positions', '1500', 'int8x1', 'group-int8', 'rep8-int8',"
        " 'a-only']\n"
        "runpy.run_module('modkit_tpu_torch.tools.kernel_lab',"
        " run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "LAB_REPS": "1"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("[equal]") == 4, proc.stdout


def test_cuda_default_raises_without_a_card(tmp_path, bam, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pileup(PileupConfig(in_bam=bam, out=str(tmp_path / "o.bed"),
                                no_filtering=True))
    assert not os.path.exists(tmp_path / "o.bed")


def test_cli_device_defaults_to_cuda():
    args = build_parser().parse_args(["pileup", "in.bam", "out.bed"])
    assert args.device == "cuda"
    assert PileupConfig(in_bam="a", out="b").device == "cuda"


def test_multi_host_is_refused(tmp_path, bam, monkeypatch):
    """A multi-host run whose coordinator cannot be reached is refused with
    the fatal init error, within MODKIT_TPU_INIT_TIMEOUT, and writes
    nothing: it never degrades to a single-process run."""
    import time

    import torch.distributed as dist

    monkeypatch.setenv("MODKIT_TPU_COORD", "localhost:1")
    monkeypatch.setenv("MODKIT_TPU_NPROC", "2")
    monkeypatch.setenv("MODKIT_TPU_PROC_ID", "1")
    monkeypatch.setenv("MODKIT_TPU_INIT_TIMEOUT", "2")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="init failed .coordinator="
                                           "localhost:1"):
        run_pileup(PileupConfig(in_bam=bam, out=str(tmp_path / "o.bed"),
                                no_filtering=True, device="cpu"))
    assert time.monotonic() - t0 < 60
    assert not dist.is_initialized()
    assert not os.listdir(tmp_path)
