"""``pileup-hemi`` of the port against modkit_tpu's.

The input is the two-strand modBAM of ``utils/synth_duplex.py``: reads in
both orientations, each with calls on both strands of the duplex (``C+``
and ``G-``), since a hemi pattern pairs a read's call at a CpG's C with
its call at the partner G. Both CLIs run in one process with ``--cpg``;
the bedMethyls must be byte-equal and hold patterns with a modification
on each strand. Before the bytes are compared, the output must not be
empty: an empty file equals an empty file.
"""

import contextlib
import filecmp
import io

import pytest

from modkit_tpu.cli import main as ref_main
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.bam import BamReader
from modkit_tpu_torch.utils.synth_duplex import make_duplex_modbam


@pytest.fixture(scope="module")
def duplex(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pileup_hemi")
    bam, fa = str(d / "d.bam"), str(d / "ref.fa")
    make_duplex_modbam(bam, n_reads=90, read_len=1000, coverage=12.0,
                       seed=4, fasta_out=fa)
    return bam, fa


CASES = {
    "no-filtering": ["--no-filtering"],
    "estimate": ["--seed", "2"],
    "threshold-region": ["--filter-threshold", "0.6", "--region",
                         "synth1:1000-5000", "--mixed-delim"],
    "combine-mods": ["--no-filtering", "--combine-mods", "-i", "2500"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_pileup_hemi_equals_modkit_tpu(case, duplex, tmp_path):
    bam, fa = duplex
    flags = {r.flag & 16 for r in BamReader(bam).records()}
    assert flags == {0, 16}
    results = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.bed")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(["pileup-hemi", bam, "-o", out, "--cpg", "-r", fa]
                      + CASES[case])
        assert rc == 0
        results.append((out, err.getvalue()))
    (ref_out, ref_err), (port_out, port_err) = results
    rows = [line.split()[3] for line in open(port_out)]
    assert len(rows) > 100
    patterns = [name.split(",") for name in rows]
    assert any(p[0] != "-" for p in patterns)
    assert any(p[1] != "-" for p in patterns)
    assert port_err == ref_err
    assert filecmp.cmp(ref_out, port_out, shallow=False)
