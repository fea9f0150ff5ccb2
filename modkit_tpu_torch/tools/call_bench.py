"""Kernel A and kernel B, or the count-kernel lab's bodies, against a
build of other CUDA sources.

    python -m modkit_tpu_torch.tools.call_bench --baseline-csrc DIR [--codes M ...]
    python -m modkit_tpu_torch.tools.call_bench --baseline-csrc DIR --lab

``DIR`` is the ``modkit_tpu_torch/csrc`` of another checkout (for example
unpacked from ``git archive`` of an earlier commit) whose ``state.cu`` and
``counts.cu`` keep this checkout's C interface. Both builds are loaded in
one process. On the middle 100 kb tile of the bench workload (50 000 reads
x 5 kb at 25x over a 10 Mbp contig, seed 1, as ``chip_smoke.py`` makes it)
and for each class count M, it checks that each build gives the plain
version's result exactly, then times with CUDA events
(``true_bench.cuda_time_ms``), in the order this, baseline, baseline, this
(so a drift of the card shows as a gap between the two readings of one
build): kernel A's quals entry (``threshold_state_quals_t``, the one the
pileup launches: the tile's own ``export_quals_t`` planes at its M, random
planes at the other M), the quals entry at a ragged N (N % 4 != 0, so
planes 1.. are not 4-byte aligned), kernel A's f32 entry and
``modcall_counts`` (P = 100 000). One line per (kernel, M), then a JSON
object of every reading as the last line. It needs a CUDA device and
``nvcc``.

With ``--lab`` it does the same for ``lab_counts.cu`` (whose entry points
keep this checkout's C interface) at the lab's full shape
(``tools/kernel_lab.py``: 4 194 304 events over 100 000 positions, M = 2):
each histogram body through its wrapper -- the planes reader
(``run_variant``), the rows reader (``run_bigk_host``), the rep8 reader at
chunk 2048 (``count_call``) and 256 (``run_rep8``) and ``run_group`` --
then each ``run_diag`` mode and both ``run_rep8`` ablations (the diag
bodies), each checked against its plain version and timed in the same
order; then the planes, rep8, group, ``a-only`` and ``onehot-only`` bodies
with every event at one position and strand
(``kernel_lab.one_position_events``: one cell takes whole chunks).
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
from ..ops import lab_counts as lc
from ..utils.synth import make_synthetic_modbam
from . import kernel_lab
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


RAGGED = 7  # the ragged case has N - RAGGED events: N % 16 and N % 4 != 0


def quals_planes(tile, m: int, n: int, rng):
    """(quals_t, present, zero, base) of the quals entry: the tile's own
    planes at its own M and event count, else random ones."""
    if m == tile.m and n == tile.n_events:
        return tile.export_quals_t(n, m)
    present = rng.integers(0, 1 << m, n).astype(np.uint8)
    return (rng.integers(0, 256, (m, n)).astype(np.uint8), present,
            (rng.integers(0, 1 << m, n) & present).astype(np.uint8),
            rng.integers(0, 4, n).astype(np.uint8))


def cases(tile, m: int, dev, rng):
    """{kernel: (kernel call, plain call)} at class count ``m`` on the
    tile's events: its own planes and probabilities at its own M, else
    random ones with a fifth of the classes absent."""
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
    n = tile.n_events
    q = [t(a) for a in quals_planes(tile, m, n, rng)]
    qr = [t(a) for a in quals_planes(tile, m, n - RAGGED, rng)]
    return {
        "state_quals": (
            lambda: state.threshold_state_quals_t(*q, tm, tc),
            lambda: state.threshold_state_quals_t_plain(*q, tm, tc)),
        "state_quals_ragged": (
            lambda: state.threshold_state_quals_t(*qr, tm, tc),
            lambda: state.threshold_state_quals_t_plain(*qr, tm, tc)),
        "state_f32": (lambda: state.threshold_state_f32(p, b8, tm, tc),
                      lambda: state.threshold_state_f32_plain(p, b8, tm, tc)),
        "modcall_counts": (
            lambda: counts.modcall_counts(*ev, tm, tc, POSITIONS),
            lambda: counts.modcall_counts_plain(*ev, tm, tc, POSITIONS)),
    }


def lab_cases(dev):
    """{body: (kernel call, plain call)} at the lab's full shape."""
    events = kernel_lab.lab_events(kernel_lab.EVENTS, kernel_lab.POSITIONS)
    lab = kernel_lab.LabInputs.build(events, kernel_lab.POSITIONS, dev)
    lab256 = kernel_lab.LabInputs.build(events, kernel_lab.POSITIONS, dev,
                                        chunk=256)
    out = {}
    for body, variant, inputs in (("planes", "int8x1", lab),
                                  ("rows", "bigkh-int8", lab),
                                  ("rep8_c256", "rep8-int8-c256", lab256),
                                  ("group", "group-int8", lab)):
        out[body] = kernel_lab.variant_call(variant, inputs)[:2]
    c2g, g = lab.planes[0], lab.n_groups
    out["rep8"] = (lambda: lc.count_call(c2g, *lab.rep8, n_groups=g),
                   lambda: lc.rep8_plain(c2g, *lab.rep8, g, lab.chunk))
    for mode in lc.DIAG_MODES:
        out[f"diag_{mode}"] = kernel_lab.variant_call(mode, lab)[:2]
    for ablation in lc.ABLATIONS:
        out[f"rep8_{ablation}"] = kernel_lab.variant_call(
            "rep8-int8", lab, ablation)[:2]
    one = kernel_lab.LabInputs.build(
        kernel_lab.one_position_events(kernel_lab.EVENTS,
                                       kernel_lab.POSITIONS),
        kernel_lab.POSITIONS, dev)
    for body, variant in (("planes_one_position", "int8x1"),
                          ("rep8_one_position", "rep8-int8"),
                          ("group_one_position", "group-int8"),
                          ("diag_a-only_one_position", "a-only"),
                          ("diag_onehot-only_one_position", "onehot-only")):
        out[body] = kernel_lab.variant_call(variant, one)[:2]
    return out


def time_ab(builds, kern, want, reps: int, what: str) -> dict:
    """{build: [ms, ms]} of ``kern`` in the order this, baseline, baseline,
    this, each build's result checked against ``want`` first."""
    ms = {"this": [], "baseline": []}
    try:
        for build in ("this", "baseline", "baseline", "this"):
            # the wrappers launch whatever kernel_lib() returns
            kernels._libs.update(builds[build])
            if not torch.equal(kern(), want):
                raise SystemExit(f"call_bench: {build} {what} != plain")
            ms[build].append(cuda_time_ms(kern, reps)[0])
    finally:
        kernels._libs.clear()
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m modkit_tpu_torch.tools.call_bench",
        description="Time kernels A and B, or with --lab the lab's "
                    "histogram and diag bodies, against a build of other "
                    "CUDA sources.")
    ap.add_argument("--baseline-csrc", required=True)
    ap.add_argument("--codes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--lab", action="store_true",
                    help="time the lab's bodies (lab_counts.cu)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("call_bench times CUDA kernels; no CUDA device")
    dev = torch.device("cuda")
    libs = ("lab_counts",) if args.lab else LIBS
    builds = {
        "this": {n: kernels.open_library(n) for n in libs},
        "baseline": {n: kernels.open_library(n, args.baseline_csrc)
                     for n in libs},
    }
    if args.lab:
        return main_lab(builds, dev, args)
    with tempfile.TemporaryDirectory() as work:
        tile = bench_tile(work)
    print(f"device {torch.cuda.get_device_name(0)}; bench tile "
          f"N={tile.n_events}; baseline {args.baseline_csrc}", flush=True)
    rng = np.random.default_rng(17)
    readings = []
    for m in args.codes:
        for name, (kern, plain) in cases(tile, m, dev, rng).items():
            ms = time_ab(builds, kern, plain(), args.reps, f"{name} at M={m}")
            n = tile.n_events - (RAGGED if name.endswith("ragged") else 0)
            row = dict(kernel=name, m=m, n=n, **{
                f"{b}_ms": v for b, v in ms.items()})
            readings.append(row)
            this, base = np.mean(ms["this"]), np.mean(ms["baseline"])
            print(f"{name} M={m}: this {ms['this'][0]:.5f}/"
                  f"{ms['this'][1]:.5f} ms, baseline {ms['baseline'][0]:.5f}/"
                  f"{ms['baseline'][1]:.5f} ms, this/baseline "
                  f"{this / base:.3f}; both == plain", flush=True)
    print(json.dumps({"call_bench": readings}))
    return 0


def main_lab(builds, dev, args) -> int:
    print(f"device {torch.cuda.get_device_name(0)}; lab shape "
          f"{kernel_lab.EVENTS} events, P={kernel_lab.POSITIONS}; baseline "
          f"{args.baseline_csrc}", flush=True)
    readings = []
    for name, (kern, plain) in lab_cases(dev).items():
        ms = time_ab(builds, kern, plain(), args.reps, name)
        readings.append(dict(kernel=name, **{f"{b}_ms": v
                                             for b, v in ms.items()}))
        this, base = np.mean(ms["this"]), np.mean(ms["baseline"])
        print(f"lab {name}: this {ms['this'][0]:.5f}/{ms['this'][1]:.5f} ms, "
              f"baseline {ms['baseline'][0]:.5f}/{ms['baseline'][1]:.5f} ms, "
              f"this/baseline {this / base:.3f}; both == plain", flush=True)
    print(json.dumps({"call_bench_lab": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
