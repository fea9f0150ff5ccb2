"""The controls of the benchmark's comparison: the plain reference put in
the program's place and computed in bfloat16, the precision below the
float32 the call is stated in, and in fp8 e4m3, the step below that. A
sound comparison has to reject at least one.

    python benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

For each seed it makes the cell's truth at the cell's own size, works the
bedMethyl out in float32 (the reference) and in each lower precision
(the controls), and prints one JSON line with the numbers the benchmark
compares for each control: rows that differ and jobs whose bytes differ,
beside their limits. It runs on
the host alone; no card and no program are needed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import gen, reference, run  # noqa: E402

# bfloat16 is the precision below the stated float32; where it reads as
# float32 (8-bit ML values, a threshold between the halves of their grid),
# fp8 e4m3 is the next step down
PRECISIONS = ("bf16", "fp8")


def control(workload: str, seed: int, data_override: dict | None = None,
            workers: int | None = None, cell_spec: tuple | None = None) -> dict:
    """The controls' numbers for one seed; ``cell_spec``, a (workload,
    configuration) pair, stands in for the files that ``workload`` names."""
    wl, config = cell_spec or run.cell(workload, data_override)
    layout = gen.make_layout(config, seed)
    hist: dict = {}
    for b in range(gen.batch_count(config)):
        for base, h in gen.confidence_hist(gen.batch_of(layout, config, seed, b)).items():
            hist[base] = hist.get(base, 0) + h
    pct = float(config["filter_percentile"])
    flags = run.workload_flags(
        wl, {base: gen.threshold_from_hist(h, pct) for base, h in hist.items()}, "ref.fa")
    workers = workers or os.cpu_count() or 1
    ref, n, t = reference.reference_bedmethyl(config, seed, flags, "f32", workers)
    out = {"workload": workload, "seed": seed, "rows": n, "thresholds": t}
    for precision in PRECISIONS:
        low, _, _ = reference.reference_bedmethyl(config, seed, flags, precision, workers)
        out[precision] = {
            "jobs_differing": {"value": int(low != ref), "limit": 0},
            "rows_differing": {"value": run.rows_differing(low, ref), "limit": 0}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    for seed in args.seed:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
