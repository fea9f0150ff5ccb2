"""The plain reference equals the program's ``--device cpu`` pileup row
for row, for each cell's flags at a small size, and for a call set on two
bases (``conftest.TWO_BASE``); the comparison fails on one changed count
and on each control."""

import json
import os

import pytest

from benchmark import control, gen, reference, run
from conftest import CELLS, SMALL, TWO_BASE, spec


def _cell_inputs(tmp_path, workload, seed):
    wl, cfg = spec(workload)
    meta = gen.generate(cfg, seed, str(tmp_path), workers=2)
    return cfg, run.workload_flags(wl, meta["thresholds"], str(tmp_path / "ref.fa"))


def _port_bytes(tmp_path, flags):
    from modkit_tpu_torch.pileup.runner import run_pileup

    out = tmp_path / "port.bed"
    cfg = run.pileup_config([str(tmp_path / "reads.bam"), str(out), *flags,
                             "--device", "cpu"])
    run_pileup(cfg)
    return out.read_bytes()


@pytest.mark.parametrize("workload", CELLS + tuple(TWO_BASE))
def test_reference_equals_port(tmp_path, workload):
    cfg, flags = _cell_inputs(tmp_path, workload, 4_000_000_019)
    ref, n, _ = reference.reference_bedmethyl(cfg, 4_000_000_019, flags, workers=2)
    got = _port_bytes(tmp_path, flags)
    assert n > 100 and ref.count(b"\n") == n
    assert run.rows_differing(got, ref) == 0
    assert got == ref
    if workload in TWO_BASE:
        # rows of both bases, some of them at one position and strand
        codes = [line.split(b"\t")[3] for line in ref.splitlines()]
        assert set(codes) == {b"a", b"h", b"m"}
        at = {}
        for line in ref.splitlines():
            f = line.split(b"\t")
            at.setdefault((f[1], f[5]), set()).add(f[3])
        assert sum(1 for c in at.values() if c == {b"a", b"h", b"m"}) > 100


@pytest.mark.parametrize("workload", [CELLS[0], "two-base.pileup"])
def test_one_changed_count_fails(tmp_path, workload):
    cfg, flags = _cell_inputs(tmp_path, workload, 3)
    ref, _, _ = reference.reference_bedmethyl(cfg, 3, flags, workers=2)
    lines = ref.split(b"\n")
    i = 10 if workload == CELLS[0] else next(
        k for k, line in enumerate(lines) if line.split(b"\t")[3] == b"a")
    f = lines[i].split(b"\t")
    f[12] = str(int(f[12]) + 1).encode()  # N_canonical
    lines[i] = b"\t".join(f)
    assert run.rows_differing(b"\n".join(lines), ref) == 2


@pytest.mark.parametrize("case", ["C_wrong", "A_wrong", "A_missing", "A_extra"])
def test_threshold_must_match_the_truth(tmp_path, case):
    """Each called base's threshold handed in is the truth's; a base that
    carries calls and has none, or one that carries none, is refused."""
    two = case in ("A_wrong", "A_missing")
    cfg, flags = _cell_inputs(tmp_path, "two-base.pileup" if two else CELLS[0], 3)
    if case == "A_extra":
        flags += ["--filter-threshold", "A:0.5"]
    else:
        base = case[0]
        i = next(k for k, f in enumerate(flags) if f.startswith(base + ":"))
        if case == "A_missing":
            del flags[i - 1:i + 1]
        else:
            flags[i] = base + ":0.5"
    with pytest.raises(ValueError, match="threshold"):
        reference.reference_bedmethyl(cfg, 3, flags, workers=1)


@pytest.mark.parametrize("workload", CELLS + ("two-base.pileup",))
def test_controls(workload):
    out = control.control(workload, 91, SMALL, workers=2, cell_spec=spec(workload))
    # fp8 e4m3 fails every cell; bfloat16 fails the all-context cells,
    # whose C threshold lies on the ML values' 1/256 grid (a probability
    # (q + 0.5) / 256 rounds onto it), and reads exactly as float32 in the
    # CpG cell, whose threshold lies between the grid's halves
    assert out["fp8"]["rows_differing"]["value"] > 0
    bf16 = out["bf16"]["rows_differing"]["value"]
    assert (bf16 > 0) == (not workload.startswith("cpg"))
    json.dumps(out)


def test_fp8_rounding():
    import numpy as np

    x = np.array([0.0, 0.001, 0.5, 0.83984375, 0.9, 0.3], dtype=np.float32)
    np.testing.assert_array_equal(
        reference.to_fp8_e4m3(x), np.array([0, 2**-9, 0.5, 0.8125, 0.875, 0.3125],
                                           dtype=np.float32))
    assert reference.to_bf16(np.float32(1 + 2**-9)) == np.float32(1.0)
    assert reference.to_bf16(np.float32(1 + 3 * 2**-9)) == np.float32(1 + 2**-7)


def test_flags_outside_the_reference_are_refused():
    for flags in (["--filter-threshold", "C:0.8", "--combine-mods"],
                  ["--filter-threshold", "0.8"], ["--filter-threshold", "T:0.8"],
                  ["--filter-threshold", "C:0.8", "--filter-threshold", "C:0.7"]):
        with pytest.raises(ValueError):
            reference.Flags(flags)
    fl = reference.Flags(["--filter-threshold", "A:0.7", "--filter-threshold", "C:0.8"])
    assert fl.thresholds == {"A": 0.7, "C": 0.8}
    assert os.path.basename(run.BENCH) == "benchmark"
