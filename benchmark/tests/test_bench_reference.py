"""The plain reference equals the program's ``--device cpu`` pileup row
for row, for each cell's flags at a small size; the comparison fails on
one changed count and on each control."""

import json
import os

import pytest

from benchmark import control, gen, reference, run
from conftest import CELLS, SMALL


def _cell_inputs(tmp_path, workload, seed):
    wl, cfg = run.cell(workload)
    cfg = {**cfg, "data": {**cfg["data"], **SMALL}}
    meta = gen.generate(cfg, seed, str(tmp_path), workers=2)
    flags = [f.format(threshold=repr(meta["threshold"]), ref=str(tmp_path / "ref.fa"))
             for f in wl["flags"]]
    return cfg, flags


def _port_bytes(tmp_path, flags):
    from modkit_tpu_torch.pileup.runner import run_pileup

    out = tmp_path / "port.bed"
    cfg = run.pileup_config([str(tmp_path / "reads.bam"), str(out), *flags,
                             "--device", "cpu"])
    run_pileup(cfg)
    return out.read_bytes()


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_port(tmp_path, workload):
    cfg, flags = _cell_inputs(tmp_path, workload, 4_000_000_019)
    ref, n, _ = reference.reference_bedmethyl(cfg, 4_000_000_019, flags, workers=2)
    got = _port_bytes(tmp_path, flags)
    assert n > 100 and ref.count(b"\n") == n
    assert run.rows_differing(got, ref) == 0
    assert got == ref


def test_one_changed_count_fails(tmp_path):
    cfg, flags = _cell_inputs(tmp_path, CELLS[0], 3)
    ref, _, _ = reference.reference_bedmethyl(cfg, 3, flags, workers=2)
    lines = ref.split(b"\n")
    f = lines[10].split(b"\t")
    f[12] = str(int(f[12]) + 1).encode()  # N_canonical
    lines[10] = b"\t".join(f)
    assert run.rows_differing(b"\n".join(lines), ref) == 2


def test_threshold_must_match_the_truth(tmp_path):
    cfg, flags = _cell_inputs(tmp_path, CELLS[0], 3)
    i = flags.index("--filter-threshold") + 1
    flags[i] = "C:0.5"
    with pytest.raises(ValueError, match="threshold"):
        reference.reference_bedmethyl(cfg, 3, flags, workers=1)


@pytest.mark.parametrize("workload", CELLS)
def test_controls(workload):
    out = control.control(workload, 91, SMALL, workers=2)
    # fp8 e4m3 fails every cell; bfloat16 fails the all-context cells,
    # whose threshold lies on the ML values' 1/256 grid (a probability
    # (q + 0.5) / 256 rounds onto it), and reads exactly as float32 in the
    # CpG cell, whose threshold lies between the grid's halves
    assert out["fp8"]["rows_differing"]["value"] > 0
    bf16 = out["bf16"]["rows_differing"]["value"]
    assert (bf16 > 0) == workload.startswith("allc")
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
    with pytest.raises(ValueError):
        reference.Flags(["--filter-threshold", "C:0.8", "--combine-mods"])
    assert os.path.basename(run.BENCH) == "benchmark"
