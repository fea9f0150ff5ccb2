"""CRAM input: the port's test-CRAM writer and its CRAM pileup.

- (a) ``utils/synth_cram.write_cram`` turns a synthetic modBAM into a CRAM
  3.0 file that modkit_tpu's own ``CramReader`` (written against samtools'
  outputs) reads back to the source BAM's records: name, flag, position,
  MAPQ, CIGAR, sequence, qualities, MM and ML. The decoder adds NM/MD,
  which the writer does not store, so those are not compared.
- (b) ``python -m modkit_tpu_torch pileup x.cram out.bed --ref x.fa
  --device cpu``, run with jax and modkit_tpu blocked, writes the bytes of
  ``python -m modkit_tpu pileup`` on the same CRAM and of the port's
  pileup of the source BAM, in four modes.
- (c) The port's ``CramReader`` decodes every container natively
  (``native.cram_decode_container``) to the records its Python decoder
  gives.
- (d) A CRAM with no FASTA raises as in modkit_tpu.
- (e) A nine-code modBAM as a CRAM: pileup byte-equal to modkit_tpu.

Every comparison is exact.
"""

import filecmp
import os
import subprocess
import sys

import pytest

from modkit_tpu import native as ref_native
from modkit_tpu.cli import main as ref_main
from modkit_tpu.io.bam import BamReader as RefBamReader
from modkit_tpu.io.cram import CramReader as RefCramReader
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.cram import CramReader
from modkit_tpu_torch.utils.synth import make_synthetic_modbam
from modkit_tpu_torch.utils.synth_codes import make_multicode_modbam
from modkit_tpu_torch.utils.synth_cram import write_cram

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "no-filtering": ["--no-filtering"],
    "estimate": [],
    "cpg-combine-strands": ["--cpg", "--combine-strands"],
    "region": ["--region", "synth1:4000-15000", "--no-filtering"],
}
COMMON = ["-i", "5000", "--suppress-progress"]


def _inputs(d, name, make):
    bam, fa, cram = (str(d / f"{name}.{x}") for x in ("bam", "fa", "cram"))
    make(bam, fa)
    write_cram(bam, fa, cram, records_per_container=100)
    return bam, fa, cram


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cram")
    return _inputs(d, "s", lambda bam, fa: make_synthetic_modbam(
        bam, n_reads=300, read_len=1500, coverage=15.0, seed=4,
        fasta_out=fa))


@pytest.fixture(scope="module")
def nine(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cram_nine")
    return _inputs(d, "nine", lambda bam, fa: make_multicode_modbam(
        bam, n_reads=150, read_len=1500, seed=3, fasta_out=fa))


def _fields(rec):
    ml = rec.get_aux("ML")
    return (rec.name, rec.flag, rec.ref_id, rec.pos, rec.mapq,
            rec.cigar.tobytes(), rec.seq_bytes().tobytes(),
            rec.quals().tobytes(), rec.get_aux("MM"),
            (ml[0], ml[1].tobytes()))


# ---- (a) the writer, read back by modkit_tpu ----

@pytest.mark.parametrize("decode", ["native", "python"])
@pytest.mark.parametrize("which", ["synth", "nine"])
def test_writer_reads_back_with_modkit_tpu(request, which, decode,
                                           monkeypatch):
    bam, fa, cram = request.getfixturevalue(which)
    if decode == "python":
        monkeypatch.setattr(ref_native, "load", lambda: None)
    else:
        assert ref_native.available()
    want = [_fields(r) for r in RefBamReader(bam).records()]
    reader = RefCramReader(cram, fa)
    got = [_fields(r) for r in reader.records()]
    assert len(want) > 100 and got == want
    # the index lets a region fetch decode only its containers
    assert len(reader._crai) > 1
    tid, lo, hi = 0, 4000, 6000
    assert ([_fields(r) for r in RefCramReader(cram, fa).fetch(tid, lo, hi)]
            == [_fields(r) for r in RefBamReader(bam).fetch(tid, lo, hi)])


def test_writer_refuses_a_record_that_is_not_a_reference_match(tmp_path,
                                                               synth):
    bam, fa, _ = synth
    seq = open(fa).read().split("\n", 1)[1].replace("\n", "")
    flipped = "A" if seq[2000] != "A" else "C"
    bad_fa = tmp_path / "bad.fa"
    bad_fa.write_text(">synth1\n" + seq[:2000] + flipped + seq[2001:] + "\n")
    with pytest.raises(ValueError, match="not a full reference match"):
        write_cram(bam, str(bad_fa), str(tmp_path / "bad.cram"))


# ---- (b) pileup on the CPU, with jax and modkit_tpu blocked ----

@pytest.fixture(scope="module")
def port_outputs(synth, tmp_path_factory):
    """The port's CLI over the CRAM in every mode, in one process where
    jax and modkit_tpu cannot be imported."""
    _bam, fa, cram = synth
    d = tmp_path_factory.mktemp("torch_cram_port")
    outs = {mode: str(d / f"{mode}.bed") for mode in MODES}
    calls = [["pileup", cram, outs[mode], "--ref", fa, "--device", "cpu",
              *COMMON, *flags] for mode, flags in MODES.items()]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['modkit_tpu'] = None\n"
        "from modkit_tpu_torch.cli import main\n"
        f"for argv in {calls!r}:\n"
        "    assert main(argv) == 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return outs


@pytest.mark.parametrize("mode", list(MODES))
def test_cram_pileup_equals_modkit_tpu_and_the_bam(mode, synth,
                                                   port_outputs, tmp_path):
    bam, fa, cram = synth
    ref_out = str(tmp_path / "ref.bed")
    bam_out = str(tmp_path / "bam.bed")
    flags = MODES[mode]
    assert ref_main(["pileup", cram, ref_out, "--ref", fa, *COMMON,
                     *flags]) == 0
    assert port_main(["pileup", bam, bam_out, "--ref", fa, "--device", "cpu",
                      *COMMON, *flags]) == 0
    assert os.path.getsize(ref_out) > 0
    assert filecmp.cmp(port_outputs[mode], ref_out, shallow=False)
    assert filecmp.cmp(port_outputs[mode], bam_out, shallow=False)


# ---- (c) native and Python decode of the port's reader ----

@pytest.mark.parametrize("which", ["synth", "nine"])
def test_native_decode_equals_python_decode(request, which, monkeypatch):
    _bam, fa, cram = request.getfixturevalue(which)
    reader = CramReader(cram, fa)
    offsets = sorted({e[3] for e in reader._crai})
    assert len(offsets) > 1
    native = [reader._native_decode_container(off) for off in offsets]
    assert all(recs for recs in native)
    monkeypatch.setenv("MODKIT_TPU_DISABLE_NATIVE", "1")
    python = CramReader(cram, fa)
    assert python._native_decode_container(offsets[0]) is None
    for off, recs in zip(offsets, native):
        assert [r.raw() for r in python._decode_container_at(off)] == recs


# ---- (d) no FASTA ----

def test_cram_without_fasta_raises_as_modkit_tpu(synth, tmp_path,
                                                 monkeypatch):
    _bam, _fa, cram = synth
    monkeypatch.delenv("MODKIT_REF_PATH", raising=False)
    errors = []
    for main in (ref_main, port_main):
        extra = ["--device", "cpu"] if main is port_main else []
        with pytest.raises(ValueError) as err:
            main(["pileup", cram, str(tmp_path / "o.bed"), "--no-filtering",
                  *COMMON, *extra])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "requires the reference FASTA" in errors[1]


# ---- (e) nine mod codes ----

@pytest.mark.parametrize("mode", ["no-filtering", "estimate"])
def test_nine_code_cram_pileup_equals_modkit_tpu(mode, nine, tmp_path):
    bam, fa, cram = nine
    outs = {k: str(tmp_path / f"{k}.bed") for k in ("ref", "port", "bam")}
    flags = MODES[mode]
    assert ref_main(["pileup", cram, outs["ref"], "--ref", fa, *COMMON,
                     *flags]) == 0
    for key, src in (("port", cram), ("bam", bam)):
        assert port_main(["pileup", src, outs[key], "--ref", fa, "--device",
                          "cpu", *COMMON, *flags]) == 0
    assert os.path.getsize(outs["ref"]) > 0
    assert filecmp.cmp(outs["port"], outs["ref"], shallow=False)
    assert filecmp.cmp(outs["port"], outs["bam"], shallow=False)
