"""Kernel A and kernel B, or the count-kernel lab's bodies, against a
build of other CUDA sources.

    python -m modkit_tpu_torch.tools.call_bench --baseline-csrc DIR [--codes M ...]
    python -m modkit_tpu_torch.tools.call_bench --baseline-csrc DIR --lab
    python -m modkit_tpu_torch.tools.call_bench --baseline-csrc DIR --split

``DIR`` is the ``modkit_tpu_torch/csrc`` of another checkout (for example
unpacked from ``git archive`` of an earlier commit) whose ``state.cu`` and
``lab_counts.cu`` keep this checkout's C interface. Its ``counts.cu`` may
keep this checkout's contract (every cell written: the source says
``Writes every cell of counts`` above its entry) or the earlier one, which
the adapter ``EarlierContract`` calls with the output zeroed first, and
likewise ``run_diag``'s ``empty`` body, which then wrote nothing. Both builds are loaded in one process. On the middle
100 kb tile of the bench workload (50 000 reads x 5 kb at 25x over a 10
Mbp contig, seed 1, as ``chip_smoke.py`` makes it) and for each class
count M, it checks that each build gives the plain version's result
exactly, then times with CUDA events
(``true_bench.cuda_time_ms``), in the order this, baseline, baseline, this
(so a drift of the card shows as a gap between the two readings of one
build): kernel A's quals entry (``threshold_state_quals_t``, the one the
pileup launches: the tile's own ``export_quals_t`` planes at its M, random
planes at the other M), the quals entry at a ragged N (N % 4 != 0, so
planes 1.. are not 4-byte aligned; only for M in {1, 2, 4, 8}), kernel
A's f32 entry and ``modcall_counts`` (P = 100 000), at M = 2 also with
every event at one position. One line per (kernel, M), then a JSON object of every reading
as the last line. It needs a CUDA device and ``nvcc``.

With ``--split`` it splits the baseline's kernel B time at M = 2 on the
bench tile, under the earlier contract, with builds made here and not
kept: ``torch.zeros`` of the output alone, the baseline kernel with its
``atomicAdd`` replaced by an empty statement that keeps the flat index
live (the loads, the call and the launch), and the baseline as it is;
beside them this checkout's kernel, and a build of it whose count pass
waits for its zero pass to end before it launches (no programmatic
dependent launch, so no overlap); in the order this, no overlap, as is,
no atomics, zeroing, then the reverse.

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
import ctypes
import functools
import json
import os
import shutil
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

# the baseline kernel B with its count replaced by an empty statement that
# keeps the flat index live (--split)
_ATOMIC = "atomicAdd(&counts[flat], 1)"
_NO_ATOMIC = 'asm volatile("" ::"l"(flat))'
# this checkout's kernel B with its count pass launched behind the zero
# pass's end (--split)
_OVERLAP = "programmaticStreamSerializationAllowed = 1"
_NO_OVERLAP = "programmaticStreamSerializationAllowed = 0"
_CONTRACT = "Writes every cell of counts"


def writes_every_cell(csrc: str) -> bool:
    """Whether ``csrc``'s kernel B (and the lab's ``empty``) keeps this
    checkout's contract: every cell written, no zeroing first."""
    with open(os.path.join(csrc, "counts.cu")) as fh:
        return _CONTRACT in fh.read()


class EarlierContract:
    """Kernel B and ``run_diag``'s ``empty`` of a build under the earlier
    contract: the output zeroed first."""

    def __init__(self, csrc: str, lab: bool):
        self.csrc = csrc
        if lab:
            self.lab = kernels.open_library("lab_counts", csrc)
        else:
            self.counts = self.open_counts(csrc)

    @staticmethod
    def open_counts(csrc: str) -> ctypes.CDLL:
        return kernels.open_library("counts", csrc)

    @staticmethod
    def modcall_counts(lib, rpos, strand, base, probs, tm, tc, p):
        n, m = probs.shape
        out = torch.zeros((p, 2, 1 + 4 * (m + 1)), dtype=torch.int32,
                          device=probs.device)
        rc = lib.mk_modcall_counts(
            rpos.data_ptr(), strand.data_ptr(), base.data_ptr(),
            probs.data_ptr(), n, m, p, tm.data_ptr(), tc.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        kernels.check_launch(lib, rc, "modcall_counts (earlier contract)")
        return out

    def diag_empty(self, c2g, p2, col, valid, n_groups):
        out = torch.zeros((n_groups, lc.P2, lc.LANES), dtype=torch.int32,
                          device=p2.device)
        rc = self.lab.mk_lab_diag(
            0, c2g.data_ptr(), p2.data_ptr(), col.data_ptr(),
            valid.data_ptr(), c2g.numel(), lc.CHUNK, n_groups,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        kernels.check_launch(self.lab, rc, "run_diag empty (earlier)")
        return out


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


def cases(tile, m: int, dev, rng, earlier=None):
    """{kernel: (kernel call, plain call)} at class count ``m`` on the
    tile's events: its own planes and probabilities at its own M, else
    random ones with a fifth of the classes absent. A kernel call is one
    callable for both builds, or {build: callable} where ``earlier`` (an
    ``EarlierContract``) runs the baseline's kernel B."""
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
    out = {}
    if m in state.QUALS_CLASSES:
        q = [t(a) for a in quals_planes(tile, m, n, rng)]
        qr = [t(a) for a in quals_planes(tile, m, n - RAGGED, rng)]
        out["state_quals"] = (
            lambda: state.threshold_state_quals_t(*q, tm, tc),
            lambda: state.threshold_state_quals_t_plain(*q, tm, tc))
        out["state_quals_ragged"] = (
            lambda: state.threshold_state_quals_t(*qr, tm, tc),
            lambda: state.threshold_state_quals_t_plain(*qr, tm, tc))
    out["state_f32"] = (
        lambda: state.threshold_state_f32(p, b8, tm, tc),
        lambda: state.threshold_state_f32_plain(p, b8, tm, tc))
    variants = [("modcall_counts", ev)]
    if m == 2:
        one = list(ev)
        one[0] = torch.full_like(ev[0], POSITIONS // 3)
        variants.append(("modcall_counts_one_position", one))
    for name, e in variants:
        kern = functools.partial(counts.modcall_counts, *e, tm, tc, POSITIONS)
        if earlier is not None:
            kern = {"this": kern, "baseline": functools.partial(
                EarlierContract.modcall_counts, earlier.counts, *e, tm, tc,
                POSITIONS)}
        out[name] = (kern, functools.partial(
            counts.modcall_counts_plain, *e, tm, tc, POSITIONS))
    return out


def lab_cases(dev, earlier=None):
    """{body: (kernel call, plain call)} at the lab's full shape; with
    ``earlier`` the baseline's ``empty`` runs through its adapter."""
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
    if earlier is not None:
        kern, plain = out["diag_empty"]
        out["diag_empty"] = ({"this": kern, "baseline": functools.partial(
            earlier.diag_empty, *lab.planes, lab.n_groups)}, plain)
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


def time_ab(builds, kern, want, reps: int, what: str,
            order=("this", "baseline", "baseline", "this")) -> dict:
    """{build: [ms, ...]} of ``kern`` (one callable, or {build: callable})
    in ``order``, each build's result checked against ``want`` first."""
    ms = {b: [] for b in dict.fromkeys(order)}
    try:
        for build in order:
            # the wrappers launch whatever kernel_lib() returns
            kernels._libs.update(builds[build])
            fn = kern[build] if isinstance(kern, dict) else kern
            if want is not None and not torch.equal(fn(), want):
                raise SystemExit(f"call_bench: {build} {what} != plain")
            ms[build].append(cuda_time_ms(fn, reps)[0])
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
    ap.add_argument("--split", action="store_true",
                    help="split the baseline's kernel B time (earlier "
                         "contract) at M = 2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("call_bench times CUDA kernels; no CUDA device")
    dev = torch.device("cuda")
    if args.split:
        return main_split(dev, args)
    earlier = (None if writes_every_cell(args.baseline_csrc)
               else EarlierContract(args.baseline_csrc, args.lab))
    libs = ("lab_counts",) if args.lab else LIBS
    builds = {
        "this": {n: kernels.open_library(n) for n in libs},
        "baseline": {n: kernels.open_library(n, args.baseline_csrc)
                     for n in libs
                     if earlier is None or n not in ("counts",)},
    }
    if args.lab:
        return main_lab(builds, dev, args, earlier)
    with tempfile.TemporaryDirectory() as work:
        tile = bench_tile(work)
    print(f"device {torch.cuda.get_device_name(0)}; bench tile "
          f"N={tile.n_events}; baseline {args.baseline_csrc}"
          + ("" if earlier is None else " (earlier kernel B contract)"),
          flush=True)
    rng = np.random.default_rng(17)
    readings = []
    for m in args.codes:
        for name, (kern, plain) in cases(tile, m, dev, rng, earlier).items():
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


def main_lab(builds, dev, args, earlier) -> int:
    print(f"device {torch.cuda.get_device_name(0)}; lab shape "
          f"{kernel_lab.EVENTS} events, P={kernel_lab.POSITIONS}; baseline "
          f"{args.baseline_csrc}", flush=True)
    readings = []
    for name, (kern, plain) in lab_cases(dev, earlier).items():
        ms = time_ab(builds, kern, plain(), args.reps, name)
        readings.append(dict(kernel=name, **{f"{b}_ms": v
                                             for b, v in ms.items()}))
        this, base = np.mean(ms["this"]), np.mean(ms["baseline"])
        print(f"lab {name}: this {ms['this'][0]:.5f}/{ms['this'][1]:.5f} ms, "
              f"baseline {ms['baseline'][0]:.5f}/{ms['baseline'][1]:.5f} ms, "
              f"this/baseline {this / base:.3f}; both == plain", flush=True)
    print(json.dumps({"call_bench_lab": readings}))
    return 0


def main_split(dev, args) -> int:
    """The baseline's kernel B time at M = 2 on the bench tile, split by
    builds made here: the zeroing alone, the kernel without its atomics,
    the kernel as it is; this checkout's kernel beside them, with and
    without its overlap of the zeroing."""
    if writes_every_cell(args.baseline_csrc):
        raise SystemExit("call_bench --split: the baseline's kernel B "
                         "already writes every cell")
    order = ("this", "no overlap", "as is", "no atomics", "zeroing")
    with tempfile.TemporaryDirectory() as work:
        # {build: the libraries the wrappers launch}; the earlier contract's
        # builds are called through their adapter
        builds = {b: {} for b in order}
        builds["this"]["counts"] = kernels.open_library("counts")
        builds["no overlap"]["counts"] = kernels.open_library(
            "counts", ablated_csrc(kernels.CSRC,
                                   os.path.join(work, "no_overlap"),
                                   _OVERLAP, _NO_OVERLAP, 1))
        earlier = {
            "as is": EarlierContract.open_counts(args.baseline_csrc),
            "no atomics": EarlierContract.open_counts(ablated_csrc(
                args.baseline_csrc, os.path.join(work, "no_atomics"),
                _ATOMIC, _NO_ATOMIC, 2)),
        }
        tile = bench_tile(work)
    rng = np.random.default_rng(17)
    ev, tm, tc = split_inputs(tile, dev, rng)
    m = ev[3].shape[1]
    km = 1 + 4 * (m + 1)
    want = counts.modcall_counts_plain(*ev, tm, tc, POSITIONS)
    this = functools.partial(counts.modcall_counts, *ev, tm, tc, POSITIONS)
    kern = {
        "this": this,
        "no overlap": this,
        "zeroing": functools.partial(torch.zeros, (POSITIONS, 2, km),
                                     dtype=torch.int32, device=dev),
    }
    for name, lib in earlier.items():
        kern[name] = functools.partial(EarlierContract.modcall_counts, lib,
                                       *ev, tm, tc, POSITIONS)
    try:
        for name in ("this", "no overlap", "as is"):
            kernels._libs.update(builds[name])
            if not torch.equal(kern[name](), want):
                raise SystemExit(f"call_bench --split: {name} != plain")
    finally:
        kernels._libs.clear()
    ms = time_ab(builds, kern, None, args.reps, "kernel B split",
                 order=order + order[::-1])
    mean = {b: float(np.mean(v)) for b, v in ms.items()}
    print(f"device {torch.cuda.get_device_name(0)}; bench tile "
          f"N={tile.n_events}, M={m}, P={POSITIONS}; baseline "
          f"{args.baseline_csrc}", flush=True)
    for b, v in ms.items():
        print(f"split {b}: {v[0]:.5f}/{v[1]:.5f} ms", flush=True)
    print(f"split of the baseline's {mean['as is']:.5f} ms: zeroing "
          f"{mean['zeroing']:.5f}, launch + loads + call "
          f"{mean['no atomics'] - mean['zeroing']:.5f}, atomics "
          f"{mean['as is'] - mean['no atomics']:.5f}; this checkout "
          f"{mean['this']:.5f}, without the overlap "
          f"{mean['no overlap']:.5f}", flush=True)
    print(json.dumps({"call_bench_split": ms}))
    return 0


def ablated_csrc(csrc: str, to: str, old: str, new: str, times: int) -> str:
    """A copy of ``csrc``'s ``counts.cu`` and ``call.cuh`` in ``to`` with
    ``old`` (found ``times`` times) replaced by ``new``."""
    with open(os.path.join(csrc, "counts.cu")) as fh:
        src = fh.read()
    if src.count(old) != times:
        raise SystemExit(f"call_bench --split: {csrc}/counts.cu does not "
                         f"hold {old!r} {times} times")
    os.makedirs(to)
    shutil.copy(os.path.join(csrc, "call.cuh"), to)
    with open(os.path.join(to, "counts.cu"), "w") as fh:
        fh.write(src.replace(old, new))
    return to


def split_inputs(tile, dev, rng):
    """Kernel B's inputs at the tile's own M, as ``cases`` makes them."""
    rpos, strand, base, probs = tile.export_events()
    m = probs.shape[1]
    tm, tc = state.thresholds_to_tensors(
        rng.random((m, 4), dtype=np.float32) * np.float32(0.5),
        rng.random(4, dtype=np.float32) * np.float32(0.8), m)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return [t(rpos % POSITIONS), t(strand), t(base), t(probs)], tm, tc


if __name__ == "__main__":
    raise SystemExit(main())
