"""The reference's default estimate (``estimate.py``) equals the program's:
the reads its sampling schedule takes, in the order it takes them, the
multiset of their pooled confidences, and the threshold, of each called
base, on the CPU at a small size, for the estimate cell and for a call set
on two bases. Controls that sample other reads, or that take the
percentile by nearest rank, differ from it."""

import numpy as np
import pytest

from benchmark import estimate, gen, reference, run
from conftest import CELLS, spec

SEED = 2**33 + 17
# the estimate cell's own flags, whose quota at this size is every read (the
# defaults parsed, and one pass over the whole file); then merged regions
# under the floor of 50 draws with reads across intervals; then regions
# whose first reads were taken by an earlier region and count against its
# draw
CASES = {
    "cell": [],
    "merged": ["--num-reads", "60", "--sampling-interval-size", "20000"],
    "taken_twice": ["--num-reads", "200", "--sampling-interval-size", "20000"],
}


@pytest.fixture(scope="module", params=[CELLS[3], "two-base.estimate"])
def small_cell(request, tmp_path_factory):
    """An estimate cell's modBAM at ``SMALL``, its truth's per-read
    confidence histograms of each called base and its flags."""
    wl, cfg = spec(request.param)
    out = tmp_path_factory.mktemp("estimate")
    gen.generate(cfg, SEED, str(out), workers=2)
    layout = gen.make_layout(cfg, SEED)
    parts = [estimate.read_confidence_hists(gen.batch_of(layout, cfg, SEED, b))
             for b in range(gen.batch_count(cfg))]
    hists = {base: np.concatenate([p[base] for p in parts]) for base in parts[0]}
    return str(out / "reads.bam"), layout, hists, wl["flags"]


def _reference(small_cell, extra):
    _, layout, hists, flags = small_cell
    fl = reference.Flags(flags + extra)
    return fl, estimate.estimate(layout.starts, layout.spans, hists, len(layout.contig),
                                 fl.num_reads, fl.filter_percentile, fl.sampling_interval)


def _program(bam, fl, confidences_only):
    from modkit_tpu_torch import thresholds
    from modkit_tpu_torch.io.bam import BamReader

    return thresholds.sample_reads(BamReader(bam), fl.num_reads, None, None, False,
                                   interval_size=fl.sampling_interval,
                                   confidences_only=confidences_only)


def _grid_hist(conf: np.ndarray) -> np.ndarray:
    hist, off = estimate.grid_hist(conf, chunk=97)
    assert off == 0, "a confidence off the 1/512 grid"
    return hist


@pytest.mark.parametrize("case", sorted(CASES))
def test_estimate_equals_program(small_cell, case):
    from modkit_tpu_torch import thresholds

    bam, layout, hists = small_cell[:3]
    fl, est = _reference(small_cell, CASES[case])
    names = _program(bam, fl, confidences_only=False)
    assert list(names) == [f"read{i}" for i in est["reads"]]
    confs = _program(bam, fl, confidences_only=True)
    index = {run.BASE_INDEX[b]: b for b in hists}
    assert set(confs) == set(index)
    for i, b in index.items():
        assert np.array_equal(_grid_hist(confs[i]), est["pooled"][b])
    got = thresholds.thresholds_from_confidences(confs, fl.filter_percentile)
    assert set(got) == set(est["thresholds"])
    for b, t in est["thresholds"].items():
        assert np.float32(got[b]) == np.float32(t)
    if case == "cell":
        # 10 042 reads asked of a file that holds fewer: every read with a call
        eligible = np.flatnonzero(sum(h.sum(axis=1) for h in hists.values()) > 0)
        assert est["quota"] == len(layout.starts)
        assert sorted(est["reads"].tolist()) == eligible.tolist()
    if case == "taken_twice":
        # later regions' draws were partly spent on reads already taken
        draws = sum(x for _, _, x in estimate.regions(len(layout.contig),
                                                       est["quota"], fl.sampling_interval))
        assert len(est["reads"]) < draws


def test_controls_differ(small_cell):
    """The first reads of the file in place of the schedule's, and the
    nearest-rank percentile in place of the interpolated one, both differ
    from the reference and from the program, in each called base."""
    from modkit_tpu_torch import thresholds

    bam, layout, hists, _ = small_cell
    fl, est = _reference(small_cell, CASES["merged"])
    eligible = sum(h.sum(axis=1) for h in hists.values()) > 0
    first = np.flatnonzero(eligible)[:est["quota"]]
    assert set(first.tolist()) != set(est["reads"].tolist())
    confs = _program(bam, fl, confidences_only=True)
    for b, h in hists.items():
        assert not np.array_equal(h[first].sum(axis=0), est["pooled"][b])
        # a percentile that falls between two distinct sorted confidences
        pooled = est["pooled"][b]
        bins = np.flatnonzero(pooled)
        k = int(np.cumsum(pooled)[bins[len(bins) // 2]]) - 1  # the last index of a bin
        q = float(np.float32((k + 0.5) / (int(pooled.sum()) - 1)))
        interp = estimate.percentile(pooled, q)
        assert gen.threshold_from_hist(pooled, q) != interp
        got = thresholds.thresholds_from_confidences(confs, q)[b]
        assert np.float32(got) == np.float32(interp)


def test_percentile_rounds_as_float32():
    """Above 2**24 confidences the count's own rounding to float32 sets the
    rank, as it does in modkit: n - 1 = 2**24 + 1 reads as 2**24."""
    n = 2**24 + 2
    hist = np.zeros(estimate.BINS, dtype=np.int64)
    hist[400] = 2**23 + 1  # sorted indices 0 .. 2**23
    hist[401] = n - hist[400]
    # exact arithmetic would put the median halfway between the two bins
    assert estimate.percentile(hist, 0.5) == 400 / 512


def test_flags_outside_the_estimate_are_refused():
    for extra in (["--sampling-frac", "0.5"], ["--seed", "3"], ["--no-filtering"],
                  ["--sample-region", "chr1:1-100"], ["--cpg"]):
        with pytest.raises(ValueError):
            reference.Flags(["--interval-size", "100000", *extra])
    fl = reference.Flags(["-n", "60", "-p", "0.25", "--sampling-interval-size", "5000"])
    assert (fl.thresholds, fl.num_reads, fl.filter_percentile, fl.sampling_interval) == \
        ({}, 60, 0.25, 5000)


def test_grid_hist_counts_values_off_the_grid():
    v = np.array([0.0, 1.0, 0.5, 0.5, 1 / 3, 2.0, -1 / 512, np.nan], dtype=np.float32)
    hist, off = estimate.grid_hist(v, chunk=3)
    assert off == 4 and hist.sum() == 4
    assert (hist[0], hist[256], hist[512]) == (1, 2, 1)
