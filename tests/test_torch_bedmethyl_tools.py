"""``bedmethyl merge``/``tobigwig``, ``stats`` and ``localize`` of the port
against modkit_tpu's.

Inputs are the port's own bedMethyls, made as in ``test_torch_dmr.py``
(pileup on the CPU of a synthesized modBAM A and of ``adjust-mods
--convert h m`` of it, B; bgzipped and tabix-indexed). Both CLIs run in
one process; every output (the bigWig's bytes too) must be byte-equal.
"""

import contextlib
import filecmp
import io
import sys

import numpy as np
import pytest

from modkit_tpu.cli import main as ref_main
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.bam import build_bai
from modkit_tpu_torch.utils.synth import make_synthetic_modbam
from tests.test_torch_dmr import port_bedmethyl


def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


@pytest.fixture(scope="module")
def beds(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bedmethyl_tools")
    a_bam = str(d / "a.bam")
    info = make_synthetic_modbam(a_bam, n_reads=200, read_len=1500,
                                 coverage=15.0, seed=9)
    b_bam = str(d / "b.bam")
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", ["modkit"])
    try:
        assert _run(port_main, ["adjust-mods", a_bam, b_bam, "--convert",
                                "h", "m"])[0] == 0
    finally:
        mp.undo()
    build_bai(b_bam)
    a, b = (port_bedmethyl(x, str(d / f"{n}.bed"))
            for x, n in ((a_bam, "a"), (b_bam, "b")))
    length = info["contig_len"]
    sizes = str(d / "sizes.tsv")
    with open(sizes, "w") as fh:
        fh.write(f"synth1\t{length}\n")
    regions = str(d / "regions.bed")
    with open(regions, "w") as fh:
        for i, start in enumerate(np.linspace(100, length - 900, 25,
                                              dtype=int)):
            fh.write(f"synth1\t{start}\t{start + 700}\tr{i}\t0\t"
                     f"{'+-'[i % 2]}\n")
    return dict(a=a, b=b, a_text=str(d / "a.bed"), sizes=sizes,
                regions=regions)


CASES = {
    "merge": ["bedmethyl", "merge", "{a}", "{b}", "-g", "{sizes}", "-o",
              "{out}", "--force"],
    "merge-self": ["bedmethyl", "merge", "{a}", "{a}", "-g", "{sizes}",
                   "-o", "{out}", "--force", "-i", "3000"],
    "tobigwig": ["bedmethyl", "tobigwig", "{a_text}", "{out}", "-g",
                 "{sizes}", "-m", "m,h"],
    "tobigwig-m-negative": ["bedmethyl", "tobigwig", "{a_text}", "{out}",
                            "-g", "{sizes}", "-m", "m",
                            "--negative-strand-values", "-u"],
    "stats": ["stats", "{a}", "--regions", "{regions}", "-o", "{out}",
              "--force"],
    "stats-codes": ["stats", "{b}", "--regions", "{regions}", "-o", "{out}",
                    "--force", "-c", "m", "--min-coverage", "10"],
    "localize": ["localize", "{a}", "--regions", "{regions}", "-r",
                 "{sizes}", "-o", "{out}", "-f"],
    "localize-stranded": ["localize", "{a}", "--regions", "{regions}", "-r",
                          "{sizes}", "-o", "{out}", "-f", "-w", "300",
                          "--stranded", "same"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_tool_equals_modkit_tpu(case, beds, tmp_path):
    outs = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / name)
        rc, err = _run(main, [x.format(out=out, **beds)
                              for x in CASES[case]])
        assert rc == 0, err
        outs.append(out)
    assert filecmp.cmp(*outs, shallow=False)
    body = open(outs[1], "rb").read()
    if case.startswith("tobigwig"):
        assert body[:4] == (0x888FFC26).to_bytes(4, "little")
    else:
        assert len(body.splitlines()) > 20
