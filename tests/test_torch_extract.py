"""``extract full``/``extract calls`` of the port against modkit_tpu's.

Both CLIs run in one process on the same synthesized modBAMs (forward
reads, and the two-strand reads of ``utils/synth_duplex.py``) with their
FASTA; every output must be byte-equal. Whole-file runs take the native
stream (``native.extract_full_stream``); ``--region``, ``--include-bed``
and ``--cpg`` take the Python row route, and so does every case with the
native library off. Within the port, the native stream is also held to
the Python rows directly, with spans small enough that records carry
across them.
"""

import contextlib
import filecmp
import gzip
import io

import numpy as np
import pytest

from modkit_tpu import native as ref_native
from modkit_tpu.cli import main as ref_main
from modkit_tpu_torch import native
from modkit_tpu_torch.caller import ThresholdCaller
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.engines.extract import run_extract
from modkit_tpu_torch.io.bam import BamReader
from modkit_tpu_torch.io.fasta import FastaReader
from modkit_tpu_torch.utils.synth import make_synthetic_modbam
from modkit_tpu_torch.utils.synth_duplex import make_duplex_modbam

# whole-file cases: the native stream, or the Python rows without the
# native library
CASES = {
    "full": ["extract", "full", "{bam}", "{out}"],
    "full-ref-kmer": ["extract", "full", "{bam}", "{out}", "--ref", "{fa}",
                      "--kmer-size", "7"],
    "full-bgzf": ["extract", "full", "{bam}", "{out}", "--bgzf"],
    "calls-no-filtering": ["extract", "calls", "{bam}", "{out}",
                           "--no-filtering"],
    "calls-threshold": ["extract", "calls", "{bam}", "{out}",
                        "--filter-threshold", "0.7", "--mod-threshold",
                        "h:0.8"],
    "calls-estimate": ["extract", "calls", "{bam}", "{out}", "--seed", "3"],
}
# cases that always take the Python rows
PYTHON_CASES = {
    "full-region": ["extract", "full", "{bam}", "{out}", "--region",
                    "synth1:1500-5000"],
    "full-include-bed": ["extract", "full", "{bam}", "{out}",
                         "--include-bed", "{bed}"],
    "full-cpg": ["extract", "full", "{bam}", "{out}", "--cpg", "--ref",
                 "{fa}"],
    "calls-estimate-region": ["extract", "calls", "{bam}", "{out}",
                              "--region", "synth1:1000-6000", "-p", "0.2"],
}


N_READS = 80


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_extract")
    out = {}
    for kind, make in (("forward", make_synthetic_modbam),
                       ("duplex", make_duplex_modbam)):
        bam, fa = str(d / f"{kind}.bam"), str(d / f"{kind}.fa")
        make(bam, n_reads=N_READS, read_len=1000, coverage=10.0, seed=17,
             fasta_out=fa)
        out[kind] = dict(bam=bam, fa=fa)
    # an include BED: a 40-base window every 120 bases, strands alternating
    bed = str(d / "include.bed")
    with open(bed, "w") as fh:
        for i, start in enumerate(range(0, 8_000, 120)):
            fh.write(f"synth1\t{start}\t{start + 40}\tw{i}\t0\t"
                     f"{'+-'[i % 2]}\n")
    return out, bed


def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def _read(path):
    raw = open(path, "rb").read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def _both(template, files, bed, tmp_path):
    outs = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.tsv")
        assert _run(main, [x.format(out=out, bed=bed, **files)
                           for x in template])[0] == 0
        outs.append(out)
    assert filecmp.cmp(*outs, shallow=False)
    rows = _read(outs[1]).splitlines()
    assert rows[0].startswith(b"read_id\t") and len(rows) > 50


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("kind", ["forward", "duplex"])
@pytest.mark.parametrize("case", list(CASES))
def test_extract_equals_modkit_tpu(case, kind, route, inputs, tmp_path,
                                   monkeypatch):
    files, bed = inputs
    if route == "python":
        monkeypatch.setenv("MODKIT_TPU_DISABLE_NATIVE", "1")
        monkeypatch.setattr(ref_native, "load", lambda: None)
    _both(CASES[case], files[kind], bed, tmp_path)


@pytest.mark.parametrize("kind", ["forward", "duplex"])
@pytest.mark.parametrize("case", list(PYTHON_CASES))
def test_extract_python_route_equals_modkit_tpu(case, kind, inputs,
                                                tmp_path):
    files, bed = inputs
    _both(PYTHON_CASES[case], files[kind], bed, tmp_path)


@pytest.mark.parametrize("kind", ["forward", "duplex"])
@pytest.mark.parametrize("mode", ["full", "calls"])
def test_native_stream_equals_the_python_rows(mode, kind, inputs, tmp_path,
                                              monkeypatch):
    """run_extract's native stream against its Python route, then
    ``extract_full_stream`` itself with 4 KiB spans against the same
    rows."""
    files, _ = inputs
    bam, fa = files[kind]["bam"], files[kind]["fa"]
    caller = (ThresholdCaller({"C": 0.6}, {"h": 0.75}, 0.5)
              if mode == "calls" else None)
    kw = dict(mode=mode, reference_fasta=fa, caller=caller,
              include_header=False)
    fast, slow = str(tmp_path / "native.tsv"), str(tmp_path / "python.tsv")
    assert native.available()
    got = run_extract(bam, fast, **kw)
    monkeypatch.setenv("MODKIT_TPU_DISABLE_NATIVE", "1")
    want = run_extract(bam, slow, **kw)
    monkeypatch.delenv("MODKIT_TPU_DISABLE_NATIVE")
    assert got == want and want["reads"] == N_READS
    assert filecmp.cmp(fast, slow, shallow=False)

    reader = BamReader(bam)
    fasta = FastaReader(fa)
    ref_seqs = {n: fasta.fetch(n) for n in fasta.names()}
    parts, n_reads = [], 0
    for text, nr, errs in native.extract_full_stream(
            reader.bam_raw, [r.name for r in reader.header.refs],
            ref_seqs=ref_seqs, caller=caller, n_threads=2,
            span_comp_bytes=4096):
        assert not errs
        parts.append(text)
        n_reads += nr
    assert n_reads == N_READS
    assert b"".join(parts) == open(slow, "rb").read()


def test_duplex_reads_are_on_both_strands(inputs):
    files, _ = inputs
    flags = np.array([r.flag for r in
                      BamReader(files["duplex"]["bam"]).records()])
    assert 0 < np.count_nonzero(flags & 16) < len(flags)
