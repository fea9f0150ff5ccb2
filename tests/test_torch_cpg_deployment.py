"""The CpG-context deployment against the benchmark's plain reference.

dorado's ``5mCG_5hmCG`` model writes ``C+h?``/``C+m?`` calls at read CpGs
only, and users pile them up with ``--cpg --ref <fasta> --combine-strands``
(the benchmark's configuration ``cpg-5mCG5hmCG-30x`` and its cell
``cpg-5mCG5hmCG-30x.cpg-combined``). Here the benchmark's generator
(``benchmark/gen.py``) makes that configuration at a 150 kb contig, the
port piles it up on the CPU under the cell's own flags, and its bytes must
equal those of the plain NumPy reference (``benchmark/reference.py``).
Two controls show that the comparison would catch a fault: one count of
one row changed, and the reference's call made in fp8 e4m3.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import gen, reference, run  # noqa: E402

WORKLOAD = "cpg-5mCG5hmCG-30x.cpg-combined"
SMALL = {"contig_length": 150_000}
SEEDS = (11, 4_000_000_019)


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """Per seed: (configuration, flags, the port's bytes, the reference's)."""
    made = {}

    def get(seed):
        if seed not in made:
            d = tmp_path_factory.mktemp(f"cpg{seed}")
            wl, cfg = run.cell(WORKLOAD, SMALL)
            meta = gen.generate(cfg, seed, str(d), workers=2)
            flags = [f.format(threshold=repr(meta["threshold"]), ref=str(d / "ref.fa"))
                     for f in wl["flags"]]
            from modkit_tpu_torch.pileup.runner import run_pileup

            out = d / "port.bed"
            run_pileup(run.pileup_config([str(d / "reads.bam"), str(out), *flags,
                                          "--device", "cpu"]))
            ref, n, _ = reference.reference_bedmethyl(cfg, seed, flags, workers=2)
            assert n > 1000 and ref.count(b"\n") == n
            made[seed] = (cfg, flags, out.read_bytes(), ref)
        return made[seed]

    return get


@pytest.mark.parametrize("case,seed", [
    ("port", SEEDS[0]), ("port", SEEDS[1]),
    ("one_count_changed", SEEDS[0]), ("fp8_call", SEEDS[1]),
])
def test_cpg_deployment_matches_the_reference(deployment, case, seed):
    cfg, flags, got, ref = deployment(seed)
    # every row of the cell's route: two codes (h, m) at each reference CpG,
    # strands combined
    assert {line.split(b"\t")[5] for line in ref.splitlines()} == {b"."}
    assert {line.split(b"\t")[3] for line in ref.splitlines()} == {b"h", b"m"}
    if case == "port":
        assert run.rows_differing(got, ref) == 0
        assert got == ref
    elif case == "one_count_changed":
        lines = got.split(b"\n")
        f = lines[10].split(b"\t")
        f[12] = str(int(f[12]) + 1).encode()  # N_canonical
        lines[10] = b"\t".join(f)
        assert run.rows_differing(b"\n".join(lines), ref) == 2
    else:
        low, _, _ = reference.reference_bedmethyl(cfg, seed, flags, "fp8", workers=2)
        assert run.rows_differing(low, ref) > 0
