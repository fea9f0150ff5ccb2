"""``dmr pair``/``dmr multi`` of the port against modkit_tpu's.

The bedMethyls are the port's own pileups: sample A is a synthesized
modBAM, sample B is ``adjust-mods --convert h m`` of A (every 5hmC call
becomes 5mC, so the samples differ wherever A has a 5hmC call), each
piled up on the CPU, then bgzipped and tabix-indexed with the copied
``io/tabix.py``. Both CLIs run
in one process on them and every output must be byte-equal: ``dmr pair``
over regions and per site (the native and the Python bedMethyl parse,
with and without HMM segments), and ``dmr multi`` over A, B and A again.
The scoring pieces (``ops/llk.py``, ``ops/beta_diff.py``, ``hmm.py``) are
held exactly equal to modkit_tpu's on seeded arrays.
"""

import contextlib
import filecmp
import io
import os
import sys

import numpy as np
import pytest

from modkit_tpu import hmm as ref_hmm
from modkit_tpu import native as ref_native
from modkit_tpu.cli import main as ref_main
from modkit_tpu.ops import beta_diff as ref_beta_diff
from modkit_tpu.ops import llk as ref_llk
from modkit_tpu_torch import hmm, native
from modkit_tpu_torch.cli import main as port_main
from modkit_tpu_torch.io.bam import build_bai
from modkit_tpu_torch.io.tabix import bgzip_text, build_tabix
from modkit_tpu_torch.ops import beta_diff, llk
from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
from modkit_tpu_torch.utils.synth import make_synthetic_modbam


def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def port_bedmethyl(bam: str, out: str) -> str:
    """The port's pileup of ``bam`` on the CPU, bgzipped and indexed;
    returns the ``.bed.gz`` path."""
    run_pileup(PileupConfig(in_bam=bam, out=out, no_filtering=True,
                            suppress_progress=True, device="cpu"))
    gz = out + ".gz"
    bgzip_text(out, gz)
    build_tabix(gz)
    return gz


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dmr")
    a_bam, fa = str(d / "a.bam"), str(d / "ref.fa")
    info = make_synthetic_modbam(a_bam, n_reads=240, read_len=1500,
                                 coverage=15.0, seed=5, fasta_out=fa)
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
    roi = str(d / "roi.bed")
    with open(roi, "w") as fh:
        for i, start in enumerate(np.linspace(0, length - 600, 30,
                                              dtype=int)):
            fh.write(f"synth1\t{start}\t{start + 600}\troi{i}\n")
    return dict(a=a, b=b, fa=fa, roi=roi, dir=d, length=length)


CASES = {
    "pair-regions": ["dmr", "pair", "-a", "{a}", "-b", "{b}", "-r", "{roi}",
                     "--ref", "{fa}", "--base", "C", "-o", "{out}/o.bed"],
    "pair-regions-header": ["dmr", "pair", "-a", "{a}", "-b", "{b}", "-r",
                            "{roi}", "--ref", "{fa}", "--base", "C",
                            "--header", "--min-valid-coverage", "8", "-o",
                            "{out}/o.bed"],
    "pair-single-site": ["dmr", "pair", "-a", "{a}", "-b", "{b}", "--ref",
                         "{fa}", "--base", "C", "-o", "{out}/o.bed"],
    "pair-single-site-segments": ["dmr", "pair", "-a", "{a}", "-b", "{b}",
                                  "--ref", "{fa}", "--base", "C", "--header",
                                  "--segment", "{out}/seg.bed", "-o",
                                  "{out}/o.bed"],
    "multi": ["dmr", "multi", "-s", "{a}", "a", "-s", "{b}", "b", "-s",
              "{a}", "c", "-r", "{roi}", "--ref", "{fa}", "--base", "C",
              "-o", "{out}"],
}


def _both(template, samples, tmp_path):
    outs = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = tmp_path / name
        out.mkdir()
        rc, err = _run(main, [x.format(out=out, **samples)
                              for x in template])
        assert rc == 0, err
        outs.append(out)
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1]))
    for f in names:
        assert os.path.getsize(outs[1] / f) > 0, f
        assert filecmp.cmp(outs[0] / f, outs[1] / f, shallow=False), f
    return outs[1], names


@pytest.mark.parametrize("parse", ["native", "python"])
@pytest.mark.parametrize("case", list(CASES))
def test_dmr_equals_modkit_tpu(case, parse, samples, tmp_path, monkeypatch):
    if parse == "python":
        monkeypatch.setattr(native, "load", lambda: None)
        monkeypatch.setattr(ref_native, "load", lambda: None)
    else:
        assert native.available()
    out, names = _both(CASES[case], samples, tmp_path)
    if case == "multi":
        assert names == ["a_b.bed", "a_c.bed", "b_c.bed"]
    elif case.endswith("segments"):
        assert names == ["o.bed", "seg.bed"]
    rows = [line for line in open(out / names[0])
            if not line.startswith(("chrom", "#"))]
    assert len(rows) >= 20


def test_single_site_finds_the_converted_sites(samples, tmp_path):
    """B moved every h call of A to m: per site, A's and B's counts
    differ wherever A has an h call."""
    out, _ = _both(CASES["pair-single-site"], samples, tmp_path)
    rows = [line.rstrip("\n").split("\t") for line in open(out / "o.bed")]
    assert len(rows) > 1000
    assert sum(r[6] != r[8] for r in rows) > len(rows) // 2


def test_llk_ratios_equal_modkit_tpu():
    rng = np.random.default_rng(41)
    n_a, n_b = rng.integers(0, 60, 500), rng.integers(0, 60, 500)
    k_a = rng.integers(0, n_a + 1)
    k_b = rng.integers(0, n_b + 1)
    got = llk.llk_ratio_beta(k_a, n_a, k_b, n_b)
    assert np.array_equal(got, ref_llk.llk_ratio_beta(k_a, n_a, k_b, n_b))
    ca, cb = rng.integers(0, 40, (2, 300, 3))
    got = llk.llk_ratio_dirichlet(ca, cb)
    assert np.array_equal(got, ref_llk.llk_ratio_dirichlet(ca, cb))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("cap", [False, True])
def test_pmap_estimator_equals_modkit_tpu(cap):
    rng = np.random.default_rng(43)
    cov_a, cov_b = rng.integers(1, 90, (2, 800))
    mod_a, mod_b = rng.integers(0, cov_a + 1), rng.integers(0, cov_b + 1)
    args = ((40, 35), 1, 2)
    kw = dict(prior=(0.55, 0.6), rope=0.05, cap_coverages=cap)
    got = beta_diff.PMapEstimator(*args, **kw).predict_batch(
        mod_a, cov_a, mod_b, cov_b)
    want = ref_beta_diff.PMapEstimator(*args, **kw).predict_batch(
        mod_a, cov_a, mod_b, cov_b)
    for g, w in zip(got, want):
        assert np.array_equal(g, w, equal_nan=True)


@pytest.mark.parametrize("linear", [True, False])
def test_hmm_viterbi_path_equals_modkit_tpu(linear):
    rng = np.random.default_rng(47)
    scores = list(np.where(rng.random(400) < 0.2, rng.random(400) * 30,
                           -rng.random(400)))
    positions = list(np.cumsum(rng.integers(1, 300, 400)))
    kw = dict(dmr_prior=0.1, diff_stay=0.9, significance_factor=0.01,
              decay_distance=500, linear_transitions=linear)
    got = hmm.HmmModel(**kw).viterbi_path(scores, positions)
    assert got == ref_hmm.HmmModel(**kw).viterbi_path(scores, positions)
    assert 0 < sum(got) < len(got)
    assert (hmm.path_to_region_labels(got, positions)
            == ref_hmm.path_to_region_labels(got, positions))
