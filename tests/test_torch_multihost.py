"""Multi-host shard runs of the port: two real processes in one gloo
``torch.distributed`` group on the CPU, byte-equal to one process.

Each process joins the group from MODKIT_TPU_COORD / MODKIT_TPU_NPROC /
MODKIT_TPU_PROC_ID (``parallel/devices.maybe_init_distributed``), owns
its share of the work round-robin (pileup tiles, entropy window batches or
regions, extract byte ranges, dmr position batches), writes a shard with
tile sentinels, and after the barrier rank 0 merges the shards. The two
ranks run, in one process group, the port's CLI on a synthesized modBAM:
``pileup --device cpu``, ``entropy`` (windows, and ``--regions``),
``extract full`` and ``dmr pair`` per site on the port's own bedMethyls;
each output must equal the single-process run's, and no shard may be left
behind. A coordinator that cannot be reached fails loudly, within
MODKIT_TPU_INIT_TIMEOUT. Templates: ``tests/test_multihost_pileup.py``,
``tests/test_multihost_extract.py``.
"""

import filecmp
import json
import os
import socket
import subprocess
import sys

import pytest

from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.bam import build_bai
from modkit_tpu_torch.parallel.devices import shard_path
from modkit_tpu_torch.utils.synth import make_synthetic_modbam
from tests.test_torch_dmr import _run, port_bedmethyl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180

# one rank: each command of the list through the port's CLI, in order
_RANK_SCRIPT = (
    "import json, sys\n"
    "from modkit_tpu_torch.cli import main\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    rc = main(argv)\n"
    "    if rc:\n"
    "        sys.exit(rc)\n"
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _commands(d, bam, fa, regions, bed_a, bed_b, tag):
    """(name, argv, output) of each shard run; ``tag`` names the run."""
    o = os.path.join(d, tag)
    return [
        ("pileup", ["pileup", bam, o + ".bed", "--device", "cpu", "-i",
                    "5000", "--header", "--suppress-progress"], o + ".bed"),
        ("entropy", ["entropy", "-s", bam, "-o", o + ".bedgraph", "--ref",
                     fa, "--cpg", "--header", "--force"], o + ".bedgraph"),
        ("entropy regions", ["entropy", "-s", bam, "-o", o + ".regions",
                             "--regions", regions, "--ref", fa, "--cpg",
                             "--header", "--force"], o + ".regions"),
        ("extract full", ["extract", "full", bam, o + ".tsv", "--force",
                          "--suppress-progress"], o + ".tsv"),
        ("dmr pair sites", ["dmr", "pair", "-a", bed_a, "-b", bed_b, "-o",
                            o + ".dmr.bed", "--ref", fa, "--base", "C",
                            "--header", "--interval-size", "2000", "-f"],
         o + ".dmr.bed"),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every command once in this process and once over two ranks; returns
    {name: (single output, two-rank output)}."""
    d = str(tmp_path_factory.mktemp("torch_multihost"))
    bam, fa = os.path.join(d, "a.bam"), os.path.join(d, "ref.fa")
    make_synthetic_modbam(bam, n_reads=600, read_len=1000, coverage=10.0,
                          seed=41, fasta_out=fa)
    b_bam = os.path.join(d, "b.bam")
    assert _run(port_main, ["adjust-mods", bam, b_bam, "--convert", "h",
                            "m"])[0] == 0
    build_bai(b_bam)
    bed_a = port_bedmethyl(bam, os.path.join(d, "bm_a.bed"))
    bed_b = port_bedmethyl(b_bam, os.path.join(d, "bm_b.bed"))
    regions = os.path.join(d, "regions.bed")
    with open(regions, "w") as fh:
        fh.writelines(f"synth1\t{s}\t{s + 1500}\tr{s}\n"
                      for s in range(0, 55_000, 4000))

    single = _commands(d, bam, fa, regions, bed_a, bed_b, "single")
    for name, argv, _ in single:
        rc, err = _run(port_main, argv)
        assert rc == 0, f"{name}: {err}"
    multi = _commands(d, bam, fa, regions, bed_a, bed_b, "multi")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MODKIT_TPU_COORD=f"127.0.0.1:{port}",
                   MODKIT_TPU_NPROC="2", MODKIT_TPU_PROC_ID=str(rank))
        env.pop("MODKIT_TPU_DEVICES", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT,
             json.dumps([argv for _, argv, _ in multi])],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank {rank}: {err.decode()[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {name: (s_out, m_out)
            for (name, _, s_out), (_, _, m_out) in zip(single, multi)}


def _pairs(single, multi):
    """(single, multi) file pairs: the outputs, or the files of two output
    directories, which must hold the same names."""
    if not os.path.isdir(single):
        return [(single, multi)]
    names = sorted(os.listdir(single))
    assert names and names == sorted(os.listdir(multi))
    return [(os.path.join(single, f), os.path.join(multi, f)) for f in names]


@pytest.mark.parametrize("name", ["pileup", "entropy", "entropy regions",
                                  "extract full", "dmr pair sites"])
def test_two_ranks_equal_one_process(runs, name):
    for s, m in _pairs(*runs[name]):
        assert os.path.getsize(s) > 0, s
        assert filecmp.cmp(s, m, shallow=False), os.path.basename(m)
        # the shards were merged and removed
        for rank in range(2):
            assert not os.path.exists(shard_path(m, rank))
        # one header line, at the top
        header = open(s, "rb").readline()
        assert open(m, "rb").read().count(header) == 1


def test_unreachable_coordinator_fails_loudly(tmp_path):
    """A genuine init failure exits non-zero with the coordinator named,
    within the init timeout: it never degrades to a single-process run
    that writes a partial-genome shard."""
    bam, out = str(tmp_path / "s.bam"), str(tmp_path / "o.bed")
    make_synthetic_modbam(bam, n_reads=20, read_len=500, coverage=2.0,
                          seed=1)
    env = dict(os.environ, MODKIT_TPU_COORD="localhost:1",
               MODKIT_TPU_NPROC="2", MODKIT_TPU_PROC_ID="1",
               MODKIT_TPU_INIT_TIMEOUT="3")
    p = subprocess.run(
        [sys.executable, "-c", _RANK_SCRIPT, json.dumps([
            ["pileup", bam, out, "--device", "cpu"]])],
        cwd=REPO, env=env, capture_output=True, timeout=TIMEOUT)
    assert p.returncode != 0
    assert b"torch.distributed init failed (coordinator=localhost:1)" in (
        p.stderr)
    assert not os.path.exists(out) and not os.path.exists(shard_path(out, 1))
