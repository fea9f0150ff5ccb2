"""``entropy`` of the port (``engines/entropy.py``) against modkit_tpu's,
byte for byte.

The entropy math (``calc_me_entropy``: the native ``me_entropy`` and the
numpy oracle ``_calc_me_entropy_py``) on the values of the reference's
unit tests, then the CLI on a synthesized modBAM and its FASTA
(``utils/synth.make_synthetic_modbam``): windows, ``--regions`` (both
outputs), stranded and combined motifs, ``--no-filtering`` and the
default estimate, ``-t 1`` against ``-t 4``, and one window per batch
(``MODKIT_TPU_ENTROPY_BATCH_SPAN=1``) against the default batches. One
run goes with ``jax`` and ``modkit_tpu`` blocked. Entropy sorts its
estimate on the host, as modkit_tpu's does; MODKIT_TPU_OFFLOAD=always
(read by modkit_tpu only) changes neither side's bytes.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from modkit_tpu.cli import main as ref_main
from modkit_tpu.engines import entropy as ref_entropy
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.engines import entropy as port_entropy
from modkit_tpu_torch.utils.synth import make_synthetic_modbam
from tests.test_torch_dmr import _run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# methylation_entropy.rs test_calc_entropy and test_calc_entropy_wildcards
ENTROPY_CASES = [
    (["0000"] * 4, 4, 0.25),
    (["1111"] * 4, 4, 0.25),
    (["0010"] * 4, 4, 0.25),
    (["1111"] * 4 + ["0000"] * 4, 4, 0.25),
    (["1111", "1111", "0011", "0011", "1100", "1100", "0000", "0000"], 4,
     0.25),
    (["0000", "1111", "0101", "0111", "0111", "0111", "0000", "1111"], 4,
     0.25),
    (["1*01", "1111", "1011", "1111"], 4, 1.0),
    (["1*11", "1111", "1011", "1111"], 4, 1.0),
    (["*010", "1010", "0010"], 4, 1.0),
    (["1010"] * 4, 4, 1.0),
]


@pytest.mark.parametrize("fn", ["calc_me_entropy", "_calc_me_entropy_py"])
def test_calc_me_entropy_equals_modkit_tpu(fn):
    got = [getattr(port_entropy, fn)(*c) for c in ENTROPY_CASES]
    want = [getattr(ref_entropy, fn)(*c) for c in ENTROPY_CASES]
    assert [np.float32(x).tobytes() for x in got] == [
        np.float32(x).tobytes() for x in want]
    assert got[3] == np.float32(0.25) and got[4] == np.float32(0.5)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_entropy")
    bam, fa = str(d / "s.bam"), str(d / "ref.fa")
    make_synthetic_modbam(bam, n_reads=200, read_len=1500, coverage=15.0,
                          seed=31, fasta_out=fa)
    regions = str(d / "regions.bed")
    with open(regions, "w") as fh:
        fh.writelines(f"synth1\t{s}\t{s + 1000}\tr{s}\n"
                      for s in range(0, 18_000, 1500))
    return bam, fa, regions


MODES = {
    "windows": ["--cpg", "--no-filtering"],
    "estimate": ["--cpg"],
    "stranded": ["--motif", "CG", "0", "--no-filtering"],
    "combine-strands": ["--motif", "CG", "0", "--combine-strands",
                        "--no-filtering", "-n", "3"],
    "threads-1": ["--cpg", "--no-filtering", "-t", "1"],
}


def _entropy(main, sample, out, extra):
    bam, fa, _ = sample
    rc, err = _run(main, ["entropy", "-s", bam, "-o", out, "--ref", fa,
                          "--force", "--header", *extra])
    assert rc == 0, err
    return open(out, "rb").read()


@pytest.mark.parametrize("mode", list(MODES))
def test_entropy_equals_modkit_tpu(tmp_path, sample, mode):
    want = _entropy(ref_main, sample, str(tmp_path / "ref.bg"), MODES[mode])
    got = _entropy(port_main, sample, str(tmp_path / "port.bg"), MODES[mode])
    assert got == want
    assert got.startswith(b"chrom\t") and got.count(b"\n") > 100
    if mode == "threads-1":  # -t 1 against the default -t 4
        assert got == _entropy(port_main, sample, str(tmp_path / "t4.bg"),
                               MODES["windows"])


def test_entropy_regions_equals_modkit_tpu(tmp_path, sample):
    bam, fa, regions = sample
    for main, name in ((ref_main, "ref"), (port_main, "port")):
        rc, err = _run(main, ["entropy", "-s", bam, "-o",
                              str(tmp_path / name), "--regions", regions,
                              "--ref", fa, "--cpg", "--force", "--header"])
        assert rc == 0, err
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == ["regions.bed", "windows.bedgraph"]
    assert names == sorted(os.listdir(tmp_path / "port"))
    for f in names:
        assert os.path.getsize(tmp_path / "ref" / f) > 0
        assert filecmp.cmp(tmp_path / "ref" / f, tmp_path / "port" / f,
                           shallow=False), f


@pytest.mark.parametrize("env,value", [
    ("MODKIT_TPU_ENTROPY_BATCH_SPAN", "1"),
    ("MODKIT_TPU_OFFLOAD", "always"),
])
def test_entropy_modes_equal_the_default(tmp_path, sample, monkeypatch, env,
                                         value):
    """The port's ``-t 4`` default run against one window per batch and
    against modkit_tpu's forced offload (MODKIT_TPU_OFFLOAD, which only
    modkit_tpu reads), each also against modkit_tpu's run in that mode."""
    default = _entropy(port_main, sample, str(tmp_path / "d.bg"),
                       MODES["estimate"])
    monkeypatch.setenv(env, value)
    got = _entropy(port_main, sample, str(tmp_path / "p.bg"),
                   MODES["estimate"])
    want = _entropy(ref_main, sample, str(tmp_path / "r.bg"),
                    MODES["estimate"])
    assert got == default == want


def test_entropy_runs_with_jax_and_modkit_tpu_blocked(tmp_path, sample):
    bam, fa, _ = sample
    ref_out, port_out = str(tmp_path / "ref.bg"), str(tmp_path / "port.bg")
    argv = ["entropy", "-s", bam, "--ref", fa, "--cpg", "--force"]
    assert _run(ref_main, argv + ["-o", ref_out])[0] == 0
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        "from modkit_tpu_torch.cli import main\n"
        f"assert main({argv + ['-o', port_out]!r}) == 0\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert os.path.getsize(port_out) > 0
    assert filecmp.cmp(ref_out, port_out, shallow=False)
