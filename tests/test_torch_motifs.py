"""The motif commands of the port (``engines/find_motifs.py``,
``engines/motif_bed.py``) against modkit_tpu's, byte for byte.

The inputs are those of ``tests/test_find_motifs.py``: a random 60 kb
genome from a seed and a bedMethyl in which every C of CCWGG's offset 1 is
highly modified and every other C barely. ``motif search`` (with and
without ``--skip-search``), ``motif refine``, ``motif evaluate`` and
``find-motifs`` write their tables; ``motif bed`` of CG prints the hits of
a synthesized FASTA (``utils/synth.make_synthetic_modbam``'s). One run
goes with ``jax`` and ``modkit_tpu`` blocked.
"""

import contextlib
import filecmp
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from modkit_tpu.cli import main as ref_main
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.utils.synth import make_synthetic_modbam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    rng = np.random.default_rng(7)
    n = 60_000
    s = "".join(rng.choice(list("ACGT"), size=n))
    d = tmp_path_factory.mktemp("torch_motifs")
    fa = str(d / "genome.fa")
    with open(fa, "w") as fh:
        fh.write(">ctg\n")
        fh.writelines(s[i:i + 80] + "\n" for i in range(0, n, 80))
    high = {m.start() + 1 for m in re.finditer("(?=CC[AT]GG)", s)}
    bm = str(d / "pileup.bed")
    with open(bm, "w") as fh:
        for m in re.finditer("C", s):
            pos = m.start()
            n_mod, valid = (29, 30) if pos in high else (1, 30)
            fh.write(
                f"ctg\t{pos}\t{pos + 1}\tm\t{valid}\t+\t{pos}\t{pos + 1}\t"
                f"255,0,0\t{valid} {100.0 * n_mod / valid:.2f} {n_mod} "
                f"{valid - n_mod} 0 0 0 0 0\n"
            )
    return fa, bm


SEARCH = ["--context-size", "6", "6", "--min-sites", "10"]
COMMANDS = {
    "search --skip-search": ["motif", "search", "-o", "{out}", *SEARCH,
                             "--skip-search"],
    "search": ["motif", "search", "-o", "{out}", *SEARCH],
    "refine": ["motif", "refine", "--out", "{out}", "--known-motif", "CCWGG",
               "1", "m", "--known-motif", "GATC", "3", "m", *SEARCH,
               "--min-refine-sites", "10"],
    "evaluate": ["motif", "evaluate", "--out", "{out}", "--known-motif",
                 "CCWGG", "1", "m", "--known-motif", "GATC", "3", "m",
                 "--context-size", "6", "6"],
    "find-motifs": ["find-motifs", "-o", "{out}", *SEARCH, "--skip-search"],
}


def _run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()) as err:
        rc = main(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue()


@pytest.mark.parametrize("name", list(COMMANDS))
def test_motif_command_equals_modkit_tpu(tmp_path, planted, name):
    fa, bm = planted
    outs = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        outs[tag] = str(tmp_path / f"{tag}.tsv")
        argv = [x.format(out=outs[tag]) for x in COMMANDS[name]]
        _run(main, argv + ["-i", bm, "-r", fa])
    assert filecmp.cmp(outs["ref"], outs["port"], shallow=False)
    rows = open(outs["port"]).read().splitlines()
    assert rows[0].startswith("mod_code\tmotif\toffset")
    assert any(r.split("\t")[1] == "CCWGG" for r in rows[1:])


@pytest.mark.parametrize("mask", [False, True])
def test_motif_bed_equals_modkit_tpu(tmp_path, mask):
    fa = str(tmp_path / "ref.fa")
    make_synthetic_modbam(str(tmp_path / "s.bam"), n_reads=20,
                          read_len=1000, coverage=2.0, seed=9, fasta_out=fa)
    argv = ["motif", "bed", fa, "CG", "0"] + (["-k"] if mask else [])
    want = _run(ref_main, argv)
    got = _run(port_main, argv)
    assert got == want
    seq = "".join(open(fa).read().splitlines()[1:])
    assert got.count("\n") == 2 * len(re.findall("(?=CG)", seq)) > 0


def test_motifs_run_with_jax_and_modkit_tpu_blocked(tmp_path, planted):
    fa, bm = planted
    ref_out, port_out = str(tmp_path / "ref.tsv"), str(tmp_path / "port.tsv")
    argv = COMMANDS["search"] + ["-i", bm, "-r", fa]
    _run(ref_main, [x.format(out=ref_out) for x in argv])
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        "from modkit_tpu_torch.cli import main\n"
        f"assert main({[x.format(out=port_out) for x in argv]!r}) == 0\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert filecmp.cmp(ref_out, port_out, shallow=False)
