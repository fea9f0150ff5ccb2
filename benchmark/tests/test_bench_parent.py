"""The existing configurations' data and references stay as they were
before call sets became data: the generator's files and the reference's
bedMethyl of each configuration and cell, at ``SMALL`` and two seeds, have
the digests (SHA-256, first 16 hex digits) that ``gen.py`` and
``reference.py`` gave before that change; ``meta.json`` is held by its
keys of then, in their order (``thresholds`` and ``calls_per_base`` came
later). A configuration whose ``model`` is spelled out as call groups
gives the same bytes."""

import hashlib
import json
import os

import pytest

from benchmark import gen, reference, run
from conftest import C_GROUP, CELLS, CPG_GROUP, SMALL, with_groups

SEEDS = (5, 2**33 + 3)
OLD_META = ("reads", "read_bases", "calls", "threshold", "contig")
GEN = {
    ("allc-5mC5hmC-30x", 5): {"reads.bam": "567bda4aa404560e", "reads.bam.bai": "12980966b8155467", "ref.fa": "9367f82984f05518", "meta.json": "100d4af77c56f34a"},  # noqa: E501
    ("allc-5mC5hmC-30x", 8589934595): {"reads.bam": "845ddecc99ccb914", "reads.bam.bai": "b0ac3ccf6079ad64", "ref.fa": "42e16d1a3125e62a", "meta.json": "ad6b61d47d29306a"},  # noqa: E501
    ("cpg-5mCG5hmCG-30x", 5): {"reads.bam": "4cd8331dc387ddac", "reads.bam.bai": "9d85c57d6979d7e3", "ref.fa": "9367f82984f05518", "meta.json": "05a189c9132aa1db"},  # noqa: E501
    ("cpg-5mCG5hmCG-30x", 8589934595): {"reads.bam": "a759454c03537d08", "reads.bam.bai": "8b407cf890f0d99c", "ref.fa": "42e16d1a3125e62a", "meta.json": "a7215fd25f7d2a9a"},  # noqa: E501
}
REF = {
    ("allc-5mC5hmC-30x.pileup", 5): "ed43462fb166d358",
    ("allc-5mC5hmC-30x.pileup", 8589934595): "ddee57983cd4d285",
    ("cpg-5mCG5hmCG-30x.cpg-combined", 5): "4f479100079c2d3f",
    ("cpg-5mCG5hmCG-30x.cpg-combined", 8589934595): "2b4aca6c75c63cd8",
    ("allc-5mC5hmC-30x.traditional", 5): "fa70429c5a214f63",
    ("allc-5mC5hmC-30x.traditional", 8589934595): "b1641c80f7b7e8cc",
    ("allc-5mC5hmC-30x.estimate", 5): "ed43462fb166d358",
    ("allc-5mC5hmC-30x.estimate", 8589934595): "ddee57983cd4d285",
}
# each cell's configuration with its model spelled out as groups
GROUPS = {"allc-5mC5hmC-30x": [C_GROUP], "cpg-5mCG5hmCG-30x": [CPG_GROUP]}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _spec(workload: str, spelled: bool) -> tuple:
    wl, cfg = run.cell(workload, SMALL)
    return with_groups(workload, GROUPS[wl["config"]], SMALL) if spelled else (wl, cfg)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Per (configuration, seed, spelled out): the generator's directory and
    meta."""
    made = {}

    def get(workload, seed, spelled):
        wl, cfg = _spec(workload, spelled)
        key = (wl["config"], seed, spelled)
        if key not in made:
            d = tmp_path_factory.mktemp("parent")
            made[key] = (str(d), gen.generate(cfg, seed, str(d), workers=2))
        return made[key]

    return get


@pytest.mark.parametrize("spelled", [False, True], ids=["model", "groups"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [CELLS[0], CELLS[1]])
def test_generator_files_equal_the_parent(generated, workload, seed, spelled):
    d, meta = generated(workload, seed, spelled)
    config = run.cell(workload)[0]["config"]
    files = {n: _sha(open(os.path.join(d, n), "rb").read())
             for n in ("reads.bam", "reads.bam.bai", "ref.fa")}
    with open(os.path.join(d, "meta.json")) as fh:
        saved = json.load(fh)
    assert list(saved)[:len(OLD_META)] == list(OLD_META) and saved == meta
    files["meta.json"] = _sha(json.dumps({k: saved[k] for k in OLD_META}).encode())
    assert files == GEN[config, seed]
    assert saved["thresholds"] == {"C": saved["threshold"]}
    assert saved["calls_per_base"] == {"C": saved["calls"]}


@pytest.mark.parametrize("spelled", [False, True], ids=["model", "groups"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_the_parent(generated, workload, seed, spelled):
    d, meta = generated(workload, seed, spelled)
    wl, cfg = _spec(workload, spelled)
    flags = run.workload_flags(wl, meta["thresholds"], os.path.join(d, "ref.fa"))
    text, n, thresholds = reference.reference_bedmethyl(cfg, seed, flags, workers=2)
    assert _sha(text) == REF[workload, seed]
    assert n == text.count(b"\n") and set(thresholds) == {"C"}
