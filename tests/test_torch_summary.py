"""``summary`` and ``sample-probs`` of the port against modkit_tpu's.

Both CLIs run on the same synthetic modBAM and on its CRAM (the FASTA
through ``MODKIT_REF_PATH``, as neither subcommand takes ``--ref``): the
summary tables (default, ``--region``, ``--ignore h``, ``--tsv``) and the
percentile tables, probability histograms and charts of ``sample-probs
--hist`` must be byte-equal. The port also runs in a process where jax
and modkit_tpu cannot be imported, with the same result.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest

from modkit_tpu.cli import main as ref_main
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.utils.synth import make_synthetic_modbam
from modkit_tpu_torch.utils.synth_cram import write_cram

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "summary": ["summary", "{src}"],
    "summary-region": ["summary", "{src}", "--region", "synth1:3000-9000"],
    "summary-ignore": ["summary", "{src}", "--ignore", "h",
                       "--filter-threshold", "0.6"],
    "summary-tsv": ["summary", "{src}", "--tsv", "--no-filtering"],
    "sample-probs": ["sample-probs", "{src}", "--percentiles", "0.1,0.5,0.75"],
    "sample-probs-hist": ["sample-probs", "{src}", "--hist", "-o", "{out}",
                          "--prefix", "p"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_summary")
    bam, fa, cram = (str(d / f"s.{x}") for x in ("bam", "fa", "cram"))
    make_synthetic_modbam(bam, n_reads=200, read_len=1500, coverage=12.0,
                          seed=6, fasta_out=fa)
    write_cram(bam, fa, cram, records_per_container=64)
    return dict(bam=bam, fa=fa, cram=cram)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _outputs(stdout, out_dir):
    files = {}
    if os.path.isdir(out_dir):
        for f in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, f), "rb") as fh:
                files[f] = fh.read()
    return stdout, files


@pytest.mark.parametrize("src", ["bam", "cram"])
@pytest.mark.parametrize("case", list(CASES))
def test_equals_modkit_tpu(case, src, inputs, tmp_path, monkeypatch):
    monkeypatch.setenv("MODKIT_REF_PATH", inputs["fa"])
    got = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out_dir = str(tmp_path / name)
        argv = [x.format(src=inputs[src], out=out_dir) for x in CASES[case]]
        got.append(_outputs(_run(main, argv), out_dir))
    assert got[0] == got[1]
    stdout, files = got[1]
    if case == "sample-probs-hist":
        assert sorted(files) == ["p_counts.html", "p_probabilities.tsv",
                                 "p_proportion.html", "p_thresholds.tsv"]
    else:
        assert stdout.count("\n") > 3


def test_port_alone_equals_modkit_tpu(inputs, tmp_path):
    """Every case on the BAM through the port's CLI in one process where
    jax and modkit_tpu are blocked."""
    calls, ref = [], {}
    for case, template in CASES.items():
        port_dir = str(tmp_path / f"{case}.port")
        calls.append(([x.format(src=inputs["bam"], out=port_dir)
                       for x in template], str(tmp_path / f"{case}.txt")))
        ref_dir = str(tmp_path / f"{case}.ref")
        ref[case] = _outputs(_run(ref_main, [
            x.format(src=inputs["bam"], out=ref_dir) for x in template]),
            ref_dir)
    code = (
        "import contextlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        "from modkit_tpu_torch.cli import main\n"
        f"for argv, path in {calls!r}:\n"
        "    with open(path, 'w') as fh, contextlib.redirect_stdout(fh):\n"
        "        assert main(argv) == 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    for case in CASES:
        stdout = open(str(tmp_path / f"{case}.txt")).read()
        got = _outputs(stdout, str(tmp_path / f"{case}.port"))
        assert got == ref[case], case
