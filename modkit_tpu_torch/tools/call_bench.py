"""Kernel A's f32 entry and kernel B against a build of other CUDA sources.

    python -m modkit_tpu_torch.tools.call_bench --baseline-csrc DIR [--codes M ...]

``DIR`` is the ``modkit_tpu_torch/csrc`` of another checkout (for example
unpacked from ``git archive`` of an earlier commit) whose ``state.cu`` and
``counts.cu`` keep this checkout's C interface. Both builds are loaded in
one process. On the middle 100 kb tile of the bench workload (50 000 reads
x 5 kb at 25x over a 10 Mbp contig, seed 1, as ``chip_smoke.py`` makes it)
and for each class count M, it checks that each build gives the plain
version's result exactly, then times ``threshold_state_f32`` and
``modcall_counts`` (P = 100 000) with CUDA events
(``true_bench.cuda_time_ms``) in the order this, baseline, baseline, this,
so a drift of the card shows as a gap between the two readings of one
build. One line per (kernel, M), then a JSON object of every reading as
the last line. It needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from .. import native
from ..io.bam import BamReader
from ..ops import counts, kernels, state
from ..utils.synth import make_synthetic_modbam
from .true_bench import cuda_time_ms

TILE = 100_000
POSITIONS = 100_000
LIBS = ("state", "counts")


def bench_tile(work: str):
    """The middle 100 kb tile of the bench workload, decoded natively."""
    bam = os.path.join(work, "bench.bam")
    make_synthetic_modbam(bam, n_reads=50_000, read_len=5_000, coverage=25.0,
                          seed=1)
    reader = BamReader(bam)
    start = (reader.header.refs[0].length // 2 // TILE) * TILE
    return native.decode_tile_bgzf(
        reader.bam_raw, reader.fetch_chunk_voffsets(0, start, start + TILE),
        0, start, start + TILE,
    )


def cases(tile, m: int, dev, rng):
    """{kernel: (kernel call, plain call)} at class count ``m`` on the
    tile's events: its own probabilities at its own M, else random ones
    with a fifth of the classes absent."""
    rpos, strand, base, probs = tile.export_events()
    if m != tile.m:
        probs = rng.random((len(base), m), dtype=np.float32) / np.float32(m)
        probs[rng.random((len(base), m)) < 0.2] = -1.0
    tm, tc = state.thresholds_to_tensors(
        rng.random((m, 4), dtype=np.float32) * np.float32(0.5),
        rng.random(4, dtype=np.float32) * np.float32(0.8), m)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    p, b8 = t(probs), t(base.astype(np.uint8))
    ev = [t(rpos % POSITIONS), t(strand), t(base), p]
    return {
        "state_f32": (lambda: state.threshold_state_f32(p, b8, tm, tc),
                      lambda: state.threshold_state_f32_plain(p, b8, tm, tc)),
        "modcall_counts": (
            lambda: counts.modcall_counts(*ev, tm, tc, POSITIONS),
            lambda: counts.modcall_counts_plain(*ev, tm, tc, POSITIONS)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m modkit_tpu_torch.tools.call_bench",
        description="Time kernel A's f32 entry and kernel B against a "
                    "build of other CUDA sources.")
    ap.add_argument("--baseline-csrc", required=True)
    ap.add_argument("--codes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("call_bench times CUDA kernels; no CUDA device")
    dev = torch.device("cuda")
    builds = {
        "this": {n: kernels.open_library(n) for n in LIBS},
        "baseline": {n: kernels.open_library(n, args.baseline_csrc)
                     for n in LIBS},
    }
    with tempfile.TemporaryDirectory() as work:
        tile = bench_tile(work)
    print(f"device {torch.cuda.get_device_name(0)}; bench tile "
          f"N={tile.n_events}; baseline {args.baseline_csrc}", flush=True)
    rng = np.random.default_rng(17)
    readings = []
    for m in args.codes:
        for name, (kern, plain) in cases(tile, m, dev, rng).items():
            want = plain()
            ms = {"this": [], "baseline": []}
            for build in ("this", "baseline", "baseline", "this"):
                # the wrappers launch whatever kernel_lib() returns
                kernels._libs.update(builds[build])
                if not torch.equal(kern(), want):
                    raise SystemExit(f"call_bench: {build} {name} != plain "
                                     f"at M={m}")
                ms[build].append(cuda_time_ms(kern, args.reps)[0])
            kernels._libs.clear()
            row = dict(kernel=name, m=m, n=tile.n_events, **{
                f"{b}_ms": v for b, v in ms.items()})
            readings.append(row)
            this, base = np.mean(ms["this"]), np.mean(ms["baseline"])
            print(f"{name} M={m}: this {ms['this'][0]:.5f}/"
                  f"{ms['this'][1]:.5f} ms, baseline {ms['baseline'][0]:.5f}/"
                  f"{ms['baseline'][1]:.5f} ms, this/baseline "
                  f"{this / base:.3f}; both == plain", flush=True)
    print(json.dumps({"call_bench": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
