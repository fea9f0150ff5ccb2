"""The modBAM rewriters and tag tools of the port against modkit_tpu's.

``adjust-mods`` (``--ignore h``, ``--convert h m``), ``call-mods`` (a
fixed and an estimated threshold), ``update-tags --mode ambiguous``,
``repair`` and ``modbam check-tags``/``sample-reads`` run through the
port's CLI and modkit_tpu's, in one process and with the same command
line (the @PG record carries it), on the same synthetic modBAM. The
output BAMs and tables must be byte-equal and the messages on stderr
(record counts, error tallies) equal. Each runs with the native library
(the C++ span engine) and without it (the Python record loop), and in one
process where jax and modkit_tpu cannot be imported; ``call-mods`` and
``update-tags`` also run with a CRAM input.
"""

import contextlib
import filecmp
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from modkit_tpu import native as ref_native
from modkit_tpu.cli import main as ref_main
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.bam import BamReader, BamRecord, BamWriter
from modkit_tpu_torch.utils.synth import _encode_record, make_synthetic_modbam
from modkit_tpu_torch.utils.synth_cram import write_cram

CASES = {
    "adjust-ignore": ["adjust-mods", "{bam}", "{out}.bam", "--ignore", "h"],
    "adjust-convert": ["adjust-mods", "{bam}", "{out}.bam", "--convert", "h",
                       "m"],
    "call-fixed": ["call-mods", "{bam}", "{out}.bam", "--filter-threshold",
                   "0.7", "--mod-threshold", "h:0.8"],
    "call-estimated": ["call-mods", "{bam}", "{out}.bam", "--seed", "3"],
    "update-tags": ["update-tags", "{bam}", "{out}.bam", "--mode",
                    "ambiguous"],
    "repair": ["repair", "-d", "{bam}", "-a", "{acceptor}", "-o",
               "{out}.bam"],
    "check-tags": ["modbam", "check-tags", "{bam}", "-o", "{out}", "--force"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A synthetic modBAM with its FASTA and CRAM, and a repair acceptor:
    the same reads, trimmed by 5-60 bases at each end, without MM/ML, one
    of them changed so that it is no substring of its donor."""
    d = tmp_path_factory.mktemp("torch_rewriters")
    bam, fa, cram = (str(d / f"s.{x}") for x in ("bam", "fa", "cram"))
    make_synthetic_modbam(bam, n_reads=200, read_len=1500, coverage=12.0,
                          seed=8, fasta_out=fa)
    write_cram(bam, fa, cram, records_per_container=64)
    acceptor = str(d / "acceptor.bam")
    reader = BamReader(bam)
    rng = np.random.default_rng(8)
    with BamWriter(acceptor, reader.header) as writer:
        for i, rec in enumerate(reader.records()):
            a, b = rng.integers(5, 60, 2)
            seq = rec.seq_bytes()[a:rec.l_seq - b].copy()
            if i == 7:
                seq[len(seq) // 2] = ord("A" if seq[len(seq) // 2] != 65
                                         else "C")
            raw = _encode_record(rec.name.encode(), rec.ref_id,
                                 rec.pos + int(a), seq, "", np.zeros(0))
            writer.write_raw(BamRecord(raw).with_replaced_aux(
                {"MM", "ML"}, []))
    return dict(bam=bam, fa=fa, cram=cram, acceptor=acceptor, dir=d)


def _run(main, argv):
    """(exit code, stdout, stderr) of one CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _both(template, inputs, tmp_path, bam_key="bam"):
    """Run the template through both CLIs; returns the two results and
    the two output paths."""
    results, outs = [], []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / name)
        argv = [x.format(out=out, bam=inputs[bam_key],
                         acceptor=inputs["acceptor"]) for x in template]
        results.append(_run(main, argv))
        outs.append(out)
    return results, outs


def _same_outputs(outs, template):
    if template[0] == "modbam":
        names = sorted(os.listdir(outs[0]))
        assert names and names == sorted(os.listdir(outs[1]))
        return all(filecmp.cmp(os.path.join(outs[0], f),
                               os.path.join(outs[1], f), shallow=False)
                   for f in names)
    a, b = (o + ".bam" for o in outs)
    assert os.path.getsize(a) > 0
    return filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("native", ["native", "python"])
@pytest.mark.parametrize("case", list(CASES))
def test_rewriter_equals_modkit_tpu(case, native, inputs, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(sys, "argv", ["modkit"])  # the @PG command line
    if native == "python":
        monkeypatch.setenv("MODKIT_TPU_DISABLE_NATIVE", "1")
        monkeypatch.setattr(ref_native, "load", lambda: None)
    else:
        assert ref_native.available()
    template = CASES[case]
    (ref, port), outs = _both(template, inputs, tmp_path)
    assert ref[0] == 0 and port == ref
    assert _same_outputs(outs, template)
    if case == "repair":
        assert "repaired 199 records, 1 failed" in port[2]
    if case == "check-tags":
        assert "num records: 200" in port[2]


def test_sample_reads_exits_as_modkit_tpu(inputs, tmp_path):
    (ref, port), _ = _both(["modbam", "sample-reads", "{bam}"], inputs,
                           tmp_path)
    assert ref[0] and port == ref


@pytest.mark.parametrize("case", ["call-fixed", "update-tags"])
def test_rewriter_with_cram_input_equals_modkit_tpu(case, inputs, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(sys, "argv", ["modkit"])
    monkeypatch.setenv("MODKIT_REF_PATH", inputs["fa"])
    template = CASES[case]
    (ref, port), outs = _both(template, inputs, tmp_path, bam_key="cram")
    assert ref[0] == 0 and port == ref
    assert _same_outputs(outs, template)


def test_port_alone_equals_modkit_tpu(inputs, tmp_path, monkeypatch):
    """Every case through the port's CLI in one process where jax and
    modkit_tpu are blocked, with the same command line in the @PG record."""
    monkeypatch.setattr(sys, "argv", ["modkit"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    calls, refs = [], {}
    for case, template in CASES.items():
        fmt = dict(bam=inputs["bam"], acceptor=inputs["acceptor"])
        ref_out, port_out = (str(tmp_path / f"{case}.{k}")
                             for k in ("ref", "port"))
        assert _run(ref_main, [x.format(out=ref_out, **fmt)
                               for x in template])[0] == 0
        refs[case] = (ref_out, port_out)
        calls.append([x.format(out=port_out, **fmt) for x in template])
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        "sys.argv = ['modkit']\n"
        "from modkit_tpu_torch.cli import main\n"
        f"for argv in {calls!r}:\n"
        "    assert main(argv) == 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    for case, outs in refs.items():
        assert _same_outputs(list(outs), CASES[case]), case
