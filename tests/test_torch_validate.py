"""``validate`` of the port against modkit_tpu's.

Two ``--bam-and-bed`` pairs over one synthesized modBAM: the ground-truth
BEDs label the FASTA's C's, drawn from a seed, as 5mC (``m``) in one file
and canonical (``-``) in the other, on the forward strand. Both CLIs run
in one process; the output file and the tables printed on stderr must be
equal, with the default threshold (the filter quantile of the balanced
calls) and with ``--filter-threshold``.
"""

import contextlib
import filecmp
import io

import numpy as np
import pytest

from modkit_tpu.cli import main as ref_main
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.fasta import FastaReader
from modkit_tpu_torch.utils.synth import make_synthetic_modbam


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_validate")
    bam, fa = str(d / "s.bam"), str(d / "ref.fa")
    make_synthetic_modbam(bam, n_reads=150, read_len=1200, coverage=10.0,
                          seed=13, fasta_out=fa)
    seq = FastaReader(fa).fetch("synth1")
    c_pos = np.nonzero(seq == ord("C"))[0]
    mod = np.random.default_rng(13).random(len(c_pos)) < 0.4
    beds = {}
    for label, keep in (("m", mod), ("-", ~mod)):
        path = str(d / f"truth_{'m' if label == 'm' else 'C'}.bed")
        with open(path, "w") as fh:
            for p in c_pos[keep]:
                fh.write(f"synth1\t{p}\t{p + 1}\t{label}\t0\t+\n")
        beds[label] = path
    return bam, beds


CASES = {
    "default": [],
    "quantile": ["-p", "0.25"],
    "threshold": ["--filter-threshold", "0.8"],
    "canonical-base": ["-c", "C", "--min-length", "500"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_validate_equals_modkit_tpu(case, pairs, tmp_path):
    bam, beds = pairs
    results = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.txt")
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = main(["validate", "--bam-and-bed", bam, beds["m"],
                       "--bam-and-bed", bam, beds["-"], "-o", out]
                      + CASES[case])
        assert rc == 0
        results.append((out, err.getvalue()))
    (ref_out, ref_err), (port_out, port_err) = results
    assert port_err == ref_err and "Filtered accuracy" in port_err
    assert filecmp.cmp(ref_out, port_out, shallow=False)
    keys = [line.split(": ", 1)[0] for line in open(port_out)]
    assert keys == ["full_contingency_table", "raw_accuracy",
                    "raw_contingency_table", "filter_threshold",
                    "percent_of_mod_called_removed", "filtered_accuracy",
                    "filtered_contingency_table"]
