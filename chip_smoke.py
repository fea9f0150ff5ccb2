#!/usr/bin/env python3
"""Drive modkit_tpu_torch's pileup on one NVIDIA GPU and check its kernels.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It needs the CUDA toolkit (``nvcc``, found through ``CUDA_HOME``, ``PATH``
or ``/usr/local/cuda``) and ``g++``; it imports neither ``jax`` nor
``modkit_tpu``. Phases, each of which fails the run on any mismatch:

1. the card's name and power limit, the torch and CUDA versions;
2. build the kernels (one ``nvcc`` per ``csrc/*.cu``, started together)
   and the host C++ runtime;
3. the state kernel (``csrc/state.cu``) against its plain PyTorch version,
   exactly, on a real tile of the bench workload and on ragged sizes (one
   with N % 16 != 0 at every M, so planes 1.. start unaligned), for M in
   {1, 2, 4, 8} and both entries, with times and bounds;
4. the count kernel (``csrc/counts.cu``) against its plain version,
   exactly, at the tile's shape with P = 100 000 and M in {2, 4, 8}, with
   ``torch.bincount`` over precomputed keys as the library yardstick; at
   M = 2 also with every event at one position and into an output first
   filled with 0x7f7f7f7f (the kernel writes every cell), each timed;
5. the main path: ``run_pileup`` on ``cuda`` over the bench workload
   (50 000 reads x 5 kb at 25x over a 10 Mbp contig, seed 1: 100 tiles of
   100 kb), with no filtering and with the default threshold estimate, in
   three rounds beside the two host routes (the native threshold pass
   under MODKIT_TPU_OFFLOAD=never, and ``use_device=False``), every run
   byte-equal; the state kernel's launches in each device run must equal
   the tiles with events;
6. the count path: the Python event route (native decoder off) on a
   2 000-read modBAM, byte-equal to the host path, with count-kernel
   launches > 0.
7. one more device run traced with torch.profiler (``MODKIT_TPU_PROFILE``):
   the card's busy share over the traced window and its busiest ops.
8. more than 8 mod codes: the runtime-M kernels of kernel A's f32 entry
   and of kernel B against their plain versions for M in {3, 9, 16}, and a 9-code pileup on ``cuda``
   through the native route (kernel A's f32 entry) and the Python event
   route (kernel B), each byte-equal to the host C++ route;
9. the count-kernel lab (``tools/kernel_lab.py`` of the port, kernels in
   ``csrc/lab_counts.cu``) at its full size (4 194 304 events, P =
   100 000, M = 2) through its entry point, every variant and both rep8
   ablations; then each TPU function's kernel against its plain version
   and the ``torch.bincount`` oracle, exactly, with times and bounds, and
   each diag body (``run_diag``'s four modes, ``run_rep8``'s two
   ablations) against its plain version with its own bound, launches and
   library call (``diag_library``);
   then the lab's events all at one position (one cell takes whole
   chunks) for ``run_variant``, ``run_rep8`` and ``run_group`` (kernel ==
   plain == oracle) and ``run_diag``'s ``a-only`` and ``onehot-only``
   (kernel == plain).

Before phase 3 it prints the card's measured peaks (``tools/true_bench.py``:
HBM read and copy rates, bf16 ``torch.matmul`` rate) beside the data-sheet
rate the bounds use.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the
# tensor cores (dense), the peaks the bounds below are taken against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BENCH_READS, BENCH_READ_LEN, BENCH_COVERAGE = 50_000, 5_000, 25.0
TILE = 100_000
COUNT_POSITIONS = 100_000


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, f32_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def middle_tile(reader):
    """The middle 100 kb tile of the bench contig, decoded natively as the
    main path decodes it (a NativeTile)."""
    from modkit_tpu_torch import native

    start = (reader.header.refs[0].length // 2 // TILE) * TILE
    return native.decode_tile_bgzf(
        reader.bam_raw, reader.fetch_chunk_voffsets(0, start, start + TILE),
        0, start, start + TILE,
    )


def phase_state(tile, dev) -> dict:
    """Kernel A against its plain version; returns its kernels entry."""
    import numpy as np
    import torch

    from modkit_tpu_torch.ops import state
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    rng = np.random.default_rng(7)
    n_main = tile.n_events
    worst = 0
    entry = None
    for m in (1, 2, 4, 8):
        # n_main - 7: N % 16 != 0, so planes 1.. start unaligned at every M
        for n in (n_main, 1, 127, 128 * 1000 + 3, n_main - 7):
            if m == tile.m and n == n_main:
                quals_t, present, zero, base = tile.export_quals_t(n, m)
            else:
                quals_t = rng.integers(0, 256, (m, n)).astype(np.uint8)
                present = rng.integers(0, 1 << m, n).astype(np.uint8)
                zero = (rng.integers(0, 1 << m, n) & present).astype(np.uint8)
                base = rng.integers(0, 4, n).astype(np.uint8)
            thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.8)
            thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
            tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
            cpu = [torch.from_numpy(a) for a in (quals_t, present, zero, base)]
            gpu = [a.to(dev) for a in cpu]
            jbits = np.arange(m, dtype=np.uint8)
            pres = ((present[:, None] >> jbits) & 1).astype(bool)
            zer = ((zero[:, None] >> jbits) & 1).astype(bool)
            p = (quals_t.T.astype(np.float32) + np.float32(0.5)) / np.float32(256)
            probs = np.ascontiguousarray(
                np.where(pres, np.where(zer, np.float32(0), p), np.float32(-1))
            )
            probs_d = torch.from_numpy(probs).to(dev)
            for entry_name, kern, plain in (
                ("quals_t",
                 lambda: state.threshold_state_quals_t(*gpu, tm, tc),
                 lambda: state.threshold_state_quals_t_plain(*gpu, tm, tc)),
                ("f32",
                 lambda: state.threshold_state_f32(probs_d, gpu[3], tm, tc),
                 lambda: state.threshold_state_f32_plain(
                     probs_d, gpu[3], tm, tc)),
            ):
                got = kern()
                want = plain()
                torch.cuda.synchronize()
                err = int((got.int() - want.int()).abs().max().item())
                worst = max(worst, err)
                require(torch.equal(got, want),
                        f"state kernel ({entry_name}) != plain at M={m} N={n}")
                if n != n_main:
                    continue
                ms, call_ms = cuda_time_ms(kern, 200)
                plain_ms, _ = cuda_time_ms(plain, 10)
                if entry_name == "quals_t":
                    nbytes = n * (m + 3) + n
                else:
                    nbytes = n * (4 * m + 1) + n
                # per class: widen, add, scale, select, sum, two compares
                b_ms, b_by = bound(nbytes, 7.0 * m * n)
                log(f"state {entry_name} M={m} N={n}: kernel {ms:.5f} ms "
                    f"(per call {call_ms:.5f} ms), plain {plain_ms:.5f} ms, "
                    f"bound {b_ms:.5f} ms ({b_by}), share {b_ms / ms:.3f}")
                if entry_name == "quals_t" and m == tile.m:
                    entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, n=n, m=m)
    entry["max_abs_err"] = worst
    return entry


def phase_counts(tile, dev) -> dict:
    """Kernel B against its plain version; returns its kernels entry."""
    import numpy as np
    import torch

    from modkit_tpu_torch.ops import counts
    from modkit_tpu_torch.ops.state import thresholds_to_tensors
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    rng = np.random.default_rng(11)
    n = tile.n_events
    rpos, strand, base, _ = tile.export_events()
    rpos = np.ascontiguousarray(rpos % COUNT_POSITIONS, dtype=np.int32)
    worst = 0
    entry = None
    for m in (2, 4, 8):
        if m == tile.m:
            probs = tile.export_events()[3]
        else:
            probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
            probs[rng.random((n, m)) < 0.2] = -1.0
        thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.5)
        thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
        tm, tc = thresholds_to_tensors(thr_mod, thr_can, m)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (rpos, strand, base, probs)]
        kern = lambda: counts.modcall_counts(*args, tm, tc, COUNT_POSITIONS)
        plain = lambda: counts.modcall_counts_plain(
            *args, tm, tc, COUNT_POSITIONS)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        worst = max(worst, err)
        require(torch.equal(got, want), f"count kernel != plain at M={m}")
        require(int(got.sum().item()) == n, "count kernel lost events")
        km = 1 + 4 * (m + 1)
        ms, call_ms = cuda_time_ms(kern, 100)
        plain_ms, _ = cuda_time_ms(plain, 10)
        # the yardstick: one torch.bincount over the precomputed keys
        st = counts.call_states_plain(
            [args[3][:, j] for j in range(m)],
            [args[3][:, j] >= 0 for j in range(m)], args[2], tm, tc,
        ).long()
        b = args[2].long()
        flat = (args[0].long() * 2 + args[1].long()) * km + torch.where(
            st == 0, 0, 1 + b * (m + 1) + (st - 1))
        lib_ms, _ = cuda_time_ms(
            lambda: torch.bincount(flat, minlength=COUNT_POSITIONS * 2 * km),
            100)
        nbytes = n * (12 + 4 * m) + COUNT_POSITIONS * 2 * km * 4
        b_ms, b_by = bound(nbytes, 7.0 * m * n)
        log(f"counts M={m} N={n} P={COUNT_POSITIONS}: kernel {ms:.5f} ms "
            f"(per call {call_ms:.5f} ms), plain {plain_ms:.5f} ms, "
            f"torch.bincount {lib_ms:.5f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}), share {b_ms / ms:.3f}")
        if m == 2:
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, n=n, m=m)
            worst = max(worst, counts_edge_cases(args, tm, tc, ms))
    entry["max_abs_err"] = worst
    return entry


def counts_edge_cases(args, tm, tc, ms_tile: float) -> int:
    """Kernel B at M = 2 with every event at one position (every atomic on
    a few counters) and into an output first filled with 0x7f7f7f7f, twice
    in a row, each against its plain version and timed; returns the
    largest difference."""
    import torch

    from modkit_tpu_torch.ops import counts
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    p = COUNT_POSITIONS
    one = [torch.full_like(args[0], p // 3)] + list(args[1:])
    kern = lambda: counts.modcall_counts(*one, tm, tc, p)
    want = counts.modcall_counts_plain(*one, tm, tc, p)
    worst = 0
    for _ in range(2):
        got = kern()
        torch.cuda.synchronize()
        worst = max(worst, int((got - want).abs().max().item()))
        require(torch.equal(got, want),
                "count kernel != plain with every event at one position")
    ms, _ = cuda_time_ms(kern, 100)
    n = args[0].numel()
    log(f"counts one position M=2 N={n}: {n} events on "
        f"{int((want > 0).sum())} counters, kernel {ms:.5f} ms; == plain")
    want = counts.modcall_counts_plain(*args, tm, tc, p)
    log(f"counts bench tile M=2: largest counter {int(want.max())}, "
        f"{int((want > 0).sum())} counters of {want.numel()} hit")
    out = torch.full_like(want, 0x7F7F7F7F)
    fill = lambda: counts.modcall_counts(*args, tm, tc, p, out=out)
    for _ in range(2):
        out.fill_(0x7F7F7F7F)
        got = fill()
        torch.cuda.synchronize()
        worst = max(worst, int((got - want).abs().max().item()))
        require(got is out and torch.equal(got, want),
                "count kernel left cells of a filled output unwritten")
    ms, _ = cuda_time_ms(fill, 100)
    log(f"counts filled output M=2 N={n}: every cell written, kernel "
        f"{ms:.5f} ms into out= ({ms_tile:.5f} ms into a new tensor); "
        "== plain")
    return worst


def tile_layers(tile, dev, reader) -> None:
    """Per-tile times of the main path's layers on the middle tile: host
    decode, H2D of the compact planes, state kernel, D2H, host histogram,
    row formatting (host clock, median of 5; device parts end in a
    synchronize)."""
    import numpy as np
    import torch

    from modkit_tpu_torch.caller import ThresholdCaller
    from modkit_tpu_torch.modcodes import mod_code_sort_key
    from modkit_tpu_torch import native
    from modkit_tpu_torch.ops.state import (
        threshold_state_quals_t, thresholds_to_tensors,
    )
    from modkit_tpu_torch.pileup.engine import _to_host_async, _upload

    n, m = tile.n_events, tile.m
    tm, tc = thresholds_to_tensors(
        *ThresholdCaller.passthrough().threshold_arrays(tile.vocab), m)
    t = {k: [] for k in ("decode", "export", "h2d", "kernel", "d2h",
                         "histogram", "format")}
    for _ in range(5):
        t0 = time.perf_counter()
        res = middle_tile(reader)
        t1 = time.perf_counter()
        q = res.export_quals_t(n, m)
        t2 = time.perf_counter()
        d = _upload(list(q), dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        st = threshold_state_quals_t(*d, tm, tc)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        host, ev = _to_host_async(st)
        ev.synchronize()
        t5 = time.perf_counter()
        cnt = res.bincount_full(host.numpy(), m)
        t6 = time.perf_counter()
        order = np.asarray(sorted(range(len(res.vocab)),
                                  key=lambda i: mod_code_sort_key(res.vocab[i])),
                           dtype=np.int32)
        native.format_rows(cnt, res.observed_raw(), res.vocab, order, 0,
                           "synth1", False, "\t")
        t7 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("export", t1, t2),
                        ("h2d", t2, t3), ("kernel", t3, t4), ("d2h", t4, t5),
                        ("histogram", t5, t6), ("format", t6, t7)):
            t[k].append((b - a) * 1e3)
    log("tile layers (ms, median of 5, host clock, N=%d M=%d): %s" % (
        n, m, json.dumps({k: round(statistics.median(v), 4)
                          for k, v in t.items()})))


def reset_launches() -> None:
    """Set every kernel's launch count to 0, just before a path runs."""
    from modkit_tpu_torch.ops import counts, lab_counts, state

    state.STATE_KERNEL_LAUNCHES = 0
    state.STATE_F32_KERNEL_LAUNCHES = 0
    counts.COUNT_KERNEL_LAUNCHES = 0
    lab_counts.reset_launches()


def read_launches() -> tuple[int, int, int]:
    """(state quals entry, state f32 entry, count) kernel launches since
    reset_launches()."""
    from modkit_tpu_torch.ops import counts, state

    return (state.STATE_KERNEL_LAUNCHES, state.STATE_F32_KERNEL_LAUNCHES,
            counts.COUNT_KERNEL_LAUNCHES)


def run_path(bam: str, out: str, **kw) -> tuple[float, dict]:
    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup

    t0 = time.perf_counter()
    stats = run_pileup(PileupConfig(in_bam=bam, out=out,
                                    suppress_progress=True, **kw))
    return time.perf_counter() - t0, stats


def tiles_with_rows(path: str) -> int:
    tiles = set()
    with open(path) as fh:
        for line in fh:
            tiles.add(int(line.split("\t", 2)[1]) // TILE)
    return len(tiles)


MAIN_ROUNDS = 3


def phase_main(bam: str, work: str) -> int:
    """The main path on the card against both host routes; returns the
    state kernel's launches of the first no-filtering device run.

    Routes: ``cuda`` (the state kernel, MODKIT_TPU_OFFLOAD=always), ``host
    C++`` (MODKIT_TPU_OFFLOAD=never: the native threshold pass,
    ``threshold_states_cpu``) and ``host numpy`` (``use_device=False``:
    ``modcall_counts_numpy``). Every run must write the bytes of the first
    cuda run. Each mode runs MAIN_ROUNDS rounds of the three routes, the
    order reversed every other round; reads/s are reported per run and as
    the median.
    """
    from modkit_tpu_torch.parallel.devices import (
        host_event_rate, link_bandwidth_bytes_per_s,
    )

    log("offload 'auto' inputs: link %.1f MB/s, host %.1f Mevent/s" % (
        link_bandwidth_bytes_per_s("cuda") / 1e6, host_event_rate() / 1e6))
    routes = {
        "cuda": ("always", dict()),
        "host C++": ("never", dict()),
        "host numpy": ("always", dict(use_device=False)),
    }
    launches = None
    for mode, kw in (("no_filtering", dict(no_filtering=True)),
                     ("estimate", dict())):
        first = None
        times = {r: [] for r in routes}
        for rnd in range(MAIN_ROUNDS):
            order = list(routes) if rnd % 2 == 0 else list(routes)[::-1]
            for route in order:
                offload, extra = routes[route]
                out = os.path.join(
                    work, f"{mode}.{rnd}.{route.replace(' ', '_')}.bed")
                os.environ["MODKIT_TPU_OFFLOAD"] = offload
                reset_launches()
                try:
                    t, stats = run_path(bam, out, device="cuda", **kw, **extra)
                finally:
                    os.environ["MODKIT_TPU_OFFLOAD"] = "always"
                n_launch, n_f32, n_count = read_launches()
                require(n_count == 0 and n_f32 == 0,
                        f"{mode}: {route} ran the f32 state or count kernel")
                times[route].append(t)
                if first is None:
                    first = out
                    n_tiles = tiles_with_rows(out)
                    require(stats["rows"] > 0, f"{mode}: no rows")
                else:
                    require(filecmp.cmp(first, out, shallow=False),
                            f"{mode}: the {route} route wrote other bytes")
                    os.remove(out)
                if route == "cuda":
                    require(n_launch == n_tiles,
                            f"{mode}: {n_launch} state launches for "
                            f"{n_tiles} tiles")
                    if launches is None:
                        launches = n_launch
                else:
                    require(n_launch == 0, f"{mode}: {route} launched")
        log(f"main path {mode}: rows {stats['rows']}, tiles {n_tiles}, "
            f"{n_tiles} state launches per cuda run, byte-equal on all "
            f"{MAIN_ROUNDS * len(routes)} runs; reads/s median (runs): "
            + "; ".join(
                f"{r} {BENCH_READS / statistics.median(ts):.0f} ("
                + ", ".join(f"{BENCH_READS / t:.0f}" for t in ts) + ")"
                for r, ts in times.items()))
    return launches


def phase_profile(bam: str, work: str) -> None:
    """One more no-filtering device run under MODKIT_TPU_PROFILE: the
    torch.profiler trace's device busy share (union of kernel, memcpy and
    memset spans over the traced window) and its busiest device ops."""
    trace_dir = os.path.join(work, "profile")
    os.environ["MODKIT_TPU_PROFILE"] = trace_dir
    try:
        run_path(bam, os.path.join(work, "profiled.bed"), device="cuda",
                 no_filtering=True)
    finally:
        del os.environ["MODKIT_TPU_PROFILE"]
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    spans, by_name = [], {}
    lo, hi = float("inf"), 0.0
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        lo, hi = min(lo, ev["ts"]), max(hi, ev["ts"] + ev["dur"])
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
            key = ev["name"][:60]
            by_name[key] = by_name.get(key, 0.0) + ev["dur"]
    require(bool(spans), "profile: the trace holds no device work")
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(hi - lo, 1.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile: traced window {window / 1e6:.3f} s, device busy "
        f"{busy / 1e3:.3f} ms = {busy / window:.5f} of the window, "
        f"{len(spans)} device spans; top (ms): "
        + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in top))


def phase_count_path(work: str) -> int:
    """The Python event route (native decoder off) on the card against the
    host path; returns the count kernel's launches."""
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam

    bam = os.path.join(work, "small.bam")
    make_synthetic_modbam(bam, n_reads=2000, read_len=BENCH_READ_LEN,
                          coverage=BENCH_COVERAGE, seed=2)
    host_out = os.path.join(work, "small.host.bed")
    run_path(bam, host_out, device="cuda", use_device=False,
             filter_threshold={"default": 0.6})
    os.environ["MODKIT_TPU_DISABLE_NATIVE"] = "1"
    reset_launches()
    try:
        dev_out = os.path.join(work, "small.cuda.bed")
        t_dev, _ = run_path(bam, dev_out, device="cuda",
                            filter_threshold={"default": 0.6})
    finally:
        del os.environ["MODKIT_TPU_DISABLE_NATIVE"]
    n_state, n_f32, n_launch = read_launches()
    require(n_state == 0 and n_f32 == 0, "count path: a state kernel ran")
    require(filecmp.cmp(dev_out, host_out, shallow=False),
            "count path: cuda output differs from the host path")
    require(n_launch > 0, "count path: the count kernel never launched")
    log(f"count path: 2000 reads, {n_launch} count launches, "
        f"{t_dev:.3f} s; byte-equal")
    return n_launch


def phase_peaks() -> None:
    """The card's measured peaks, beside the data-sheet rate of the bounds."""
    from modkit_tpu_torch.tools import true_bench

    pk = true_bench.measure()
    log(f"peaks (tools/true_bench.py, CUDA events): HBM read "
        f"{pk['hbm_read_gbps']:.1f} GB/s, HBM copy (r+w) "
        f"{pk['hbm_copy_gbps']:.1f} GB/s, bf16 torch.matmul "
        f"{pk['matmul_bf16_tflops']:.1f} TFLOP/s; the bounds below use the "
        f"data sheet's {HBM_BYTES_PER_S / 1e9:.0f} GB/s")


MANY_CODES = (3, 9, 16)
NINE = 9


def phase_many_codes(tile, dev, work) -> dict:
    """Kernel A's f32 entry and kernel B for M in MANY_CODES against their
    plain versions at the tile's event count, timed; then a 9-code pileup
    on the card through both device routes (native decoder: kernel A's f32
    entry; Python event route: kernel B), each byte-equal to the host C++
    route. Returns {row name: kernels entry} at M = NINE, with the launches
    of the 9-code run that drives the row's kernel."""
    import numpy as np
    import torch

    from modkit_tpu_torch.ops import counts, state
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms
    from modkit_tpu_torch.utils.synth_codes import make_multicode_modbam

    rng = np.random.default_rng(13)
    n = tile.n_events
    rpos, strand, base, _ = tile.export_events()
    rpos = np.ascontiguousarray(rpos % COUNT_POSITIONS, dtype=np.int32)
    rows = {}
    worst = dict.fromkeys(
        ("threshold_state_f32_any_m", "modcall_counts_any_m"), 0)
    for m in MANY_CODES:
        probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
        probs[rng.random((n, m)) < 0.2] = -1.0
        tm, tc = state.thresholds_to_tensors(
            rng.random((m, 4), dtype=np.float32) * np.float32(0.5),
            rng.random(4, dtype=np.float32) * np.float32(0.8), m)
        p_d = torch.from_numpy(probs).to(dev)
        b8 = torch.from_numpy(base.astype(np.uint8)).to(dev)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (rpos, strand, base)] + [p_d]
        for name, kern, plain, nbytes in (
            ("threshold_state_f32_any_m",
             lambda: state.threshold_state_f32(p_d, b8, tm, tc),
             lambda: state.threshold_state_f32_plain(p_d, b8, tm, tc),
             n * (4 * m + 1) + n),
            ("modcall_counts_any_m",
             lambda: counts.modcall_counts(*args, tm, tc, COUNT_POSITIONS),
             lambda: counts.modcall_counts_plain(*args, tm, tc,
                                                 COUNT_POSITIONS),
             n * (12 + 4 * m) + COUNT_POSITIONS * 2 * (1 + 4 * (m + 1)) * 4),
        ):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max().item())
            worst[name] = max(worst[name], err)
            require(torch.equal(got, want), f"{name} kernel != plain at M={m}")
            ms, _ = cuda_time_ms(kern, 100)
            b_ms, b_by = bound(nbytes, 7.0 * m * n)
            log(f"{name} M={m} N={n}: {ms:.5f} ms, bound {b_ms:.5f} ms "
                f"({b_by}), share {b_ms / ms:.3f}; == plain")
            if m == NINE:
                plain_ms, _ = cuda_time_ms(plain, 10)
                rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None)
        # kernel B's yardstick at M = NINE: torch.bincount over the keys
        if m == NINE:
            st = state.threshold_state_f32_plain(p_d, b8, tm, tc).long()
            b = args[2].long()
            km = 1 + 4 * (m + 1)
            flat = (args[0].long() * 2 + args[1].long()) * km + torch.where(
                st == 0, 0, 1 + b * (m + 1) + (st - 1))
            rows["modcall_counts_any_m"]["library_ms"] = cuda_time_ms(
                lambda: torch.bincount(flat,
                                       minlength=COUNT_POSITIONS * 2 * km),
                100)[0]
    bam = os.path.join(work, "nine.bam")
    make_multicode_modbam(bam, n_reads=2000, read_len=BENCH_READ_LEN, seed=3)
    outs, launches = {}, {}
    for route, offload, native_off in (
            ("cuda native", "always", False),
            ("cuda python", "always", True),
            ("host C++", "never", False)):
        outs[route] = os.path.join(work, f"nine.{route.replace(' ', '_')}.bed")
        os.environ["MODKIT_TPU_OFFLOAD"] = offload
        if native_off:
            os.environ["MODKIT_TPU_DISABLE_NATIVE"] = "1"
        reset_launches()
        try:
            t, stats = run_path(bam, outs[route], device="cuda",
                                no_filtering=True)
        finally:
            os.environ["MODKIT_TPU_OFFLOAD"] = "always"
            os.environ.pop("MODKIT_TPU_DISABLE_NATIVE", None)
        launches[route] = read_launches()
        require(stats["rows"] > 0, f"9 codes, {route}: no rows")
        require(filecmp.cmp(outs[route], outs["cuda native"], shallow=False),
                f"9 codes: the {route} route wrote other bytes")
    require(launches["cuda native"][0] == 0
            and launches["cuda native"][1] > 0
            and launches["cuda native"][2] == 0,
            f"9 codes, native route: launches {launches['cuda native']}")
    require(launches["cuda python"][:2] == (0, 0)
            and launches["cuda python"][2] > 0,
            f"9 codes, python route: launches {launches['cuda python']}")
    require(launches["host C++"] == (0, 0, 0),
            f"9 codes, host route: launches {launches['host C++']}")
    rows["threshold_state_f32_any_m"]["launches"] = launches["cuda native"][1]
    rows["modcall_counts_any_m"]["launches"] = launches["cuda python"][2]
    for name, row in rows.items():
        row["max_abs_err"] = worst[name]
    log(f"9-code pileup: 2000 reads, rows {stats['rows']}; native route "
        f"{launches['cuda native'][1]} f32 state launches, python route "
        f"{launches['cuda python'][2]} count launches (M = 9); both "
        "byte-equal to the host C++ route")
    return rows


# every variant of the lab; the rep8 ablations run after them
LAB_VARIANTS = (
    "bf16x2", "bf16x4", "int8x1", "int8x4", "bigk-bf16", "bigk-int8",
    "group", "group-int8", "group-int8x2", "bigkh", "bigkh-int8",
    "rep8", "rep8-int8", "rep8-int8-c256", "rep8-int8-c1024",
    "empty", "onehot-only", "matmul-only", "a-only",
)
# (wrapper, the variant its row times or None for count_call, input
# bytes per event slot, integer operations per slot, the TPU function)
LAB_ROWS = (
    ("run_variant", "int8x1", 9, 4, "tools/kernel_lab.py:81"),
    ("run_bigk", "bigk-int8", 9, 4, "tools/kernel_lab.py:211"),
    ("run_group", "group-int8", 2, 4, "tools/kernel_lab.py:296"),
    ("run_bigk_host", "bigkh-int8", 2, 4, "tools/kernel_lab.py:344"),
    ("run_rep8", "rep8-int8", 16, 24, "tools/kernel_lab.py:412"),
    ("count_call", None, 16, 24, "modkit_tpu/ops/pallas_counts.py:113"),
)
# the diag bodies, one row each: (mode or ablation, input bytes per chunk
# of 2048 slots, integer operations per chunk, the TPU function). What each
# reads: onehot-only every slot's p2, col and valid (9 B); matmul-only row 0
# of them (128 slots); a-only every p2 and row 0's col and valid; no-dot
# the first 128 slots of the 8 rep8 rows of p2r and colr; no-construct one
# byte of p2r; empty row 0 of p2 and col (its body writes the output's
# zeros).
DIAG_ROWS = (
    ("empty", 128 * 5, 0, "tools/kernel_lab.py:160"),
    ("onehot-only", 2048 * 9, 2048 * 6, "tools/kernel_lab.py:160"),
    ("matmul-only", 128 * 9, 128 * 4, "tools/kernel_lab.py:160"),
    ("a-only", 2048 + 128 * 8, 2048 * 4, "tools/kernel_lab.py:160"),
    ("no-dot", 2 * 8 * 128, 2 * 8 * 128 * 3, "tools/kernel_lab.py:412"),
    ("no-construct", 1, 2, "tools/kernel_lab.py:412"),
)


def phase_lab() -> list:
    """The lab's main path (its entry point over LAB_VARIANTS, then
    rep8-int8 under each ablation switch), then each TPU function's kernel
    against its plain version and the oracles at the lab's shape, timed
    beside its bound and ``torch.bincount`` over precomputed keys; returns
    the rows of the kernels line."""
    import torch

    from modkit_tpu_torch.ops import lab_counts as lc
    from modkit_tpu_torch.tools import kernel_lab
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    reps = os.environ.get("LAB_REPS", "10")
    reset_launches()
    t0 = time.perf_counter()
    require(kernel_lab.main(list(LAB_VARIANTS)) == 0,
            "kernel lab: a variant mismatched or failed")
    for env in ("LAB_NO_DOT", "LAB_NO_CONSTRUCT"):
        os.environ[env] = "1"
        try:
            require(kernel_lab.main(["rep8-int8"]) == 0,
                    f"kernel lab under {env}: mismatch")
        finally:
            del os.environ[env]
    launches = dict(lc.LAUNCHES)
    diag_launches = dict(lc.DIAG_LAUNCHES)
    log(f"kernel lab: {len(LAB_VARIANTS)} variants and 2 ablations in "
        f"{time.perf_counter() - t0:.1f} s (LAB_REPS={reps}); launches "
        + json.dumps(launches) + ", diag bodies " + json.dumps(diag_launches))
    for name, *_ in LAB_ROWS:
        require(launches[name] > 0, f"kernel lab: {name} never launched")
    for mode, *_ in DIAG_ROWS:
        require(diag_launches[mode] > 0, f"kernel lab: {mode} never launched")

    lab = kernel_lab.LabInputs.build(
        kernel_lab.lab_events(kernel_lab.EVENTS, kernel_lab.POSITIONS),
        kernel_lab.POSITIONS, "cuda")
    g, slots = lab.n_groups, lab.n_chunks * lab.chunk
    cells = g * lc.CELLS
    c2g, p2, col, valid = lab.planes
    grp = c2g.long().repeat_interleave(lab.chunk) * lc.CELLS
    keep = valid != 0
    keys = (grp + p2.long() * lc.LANES + col.long())[keep]
    oracle = torch.from_numpy(lab.oracle()).to(lab.dev)
    require(torch.equal(
        torch.bincount(keys, minlength=cells).int().view(g, lc.P2, lc.LANES),
        oracle), "kernel lab: the numpy and torch oracles differ")
    out_bytes = cells * 4
    log(f"kernel lab shape: {lab.n_chunks} chunks, {slots} slots, "
        f"{lab.n_events} events, {g} groups, output {out_bytes} B")
    sms = torch.cuda.get_device_properties(lab.dev).multi_processor_count
    log("lab blocks: " + ", ".join(
        f"{r} reader {lc.BLOCKS_PER_SM[r]} per SM x {sms} SMs, spans of "
        "%d-%d chunks" % lc.hist_spans(r, lab.n_chunks, sms)
        for r in lc.BLOCKS_PER_SM)
        + f"; run_group sub-ranges of {lc.GROUP_SPAN} chunks; "
        f"{lc.BLOCK_SMEM_BYTES} B of shared memory (16-bit counts) per "
        f"block, flushed at least every {lc.PIECE_SLOTS} slots; diag "
        + ", ".join(f"{m} {t} threads x {lc.DIAG_SM_THREADS // t} per SM, "
                    f"runs of <= {lc.DIAG_ALIGN[m]} chunks kept whole"
                    for m, t in lc.DIAG_THREADS.items()))
    rows = []
    for name, variant, slot_bytes, slot_ops, replaces in LAB_ROWS:
        if variant is None:
            kern = lambda: lc.count_call(c2g, *lab.rep8, n_groups=g)
            plain = lambda: lc.rep8_plain(c2g, *lab.rep8, g, lab.chunk)
            histogram = True
        else:
            kern, plain, histogram = kernel_lab.variant_call(variant, lab)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        require(torch.equal(got, want), f"{name} kernel != plain")
        require(not histogram or torch.equal(got, oracle),
                f"{name} kernel != the oracle")
        ms, call_ms = cuda_time_ms(kern, 100)
        plain_ms, _ = cuda_time_ms(plain, 5)
        lib_ms, _ = cuda_time_ms(
            lambda: torch.bincount(keys, minlength=cells), 20)
        index_bytes = 2 * g * 4 if name == "run_group" else lab.n_chunks * 4
        nbytes = slots * slot_bytes + index_bytes + out_bytes
        b_ms, b_by = bound(nbytes, float(slots * slot_ops))
        log(f"lab {name} ({variant or 'count_call'}): kernel {ms:.5f} ms "
            f"(per call {call_ms:.5f} ms), plain {plain_ms:.5f} ms, "
            f"torch.bincount {lib_ms:.5f} ms, {nbytes} B, bound "
            f"{b_ms:.5f} ms ({b_by}), share {b_ms / ms:.3f}, "
            f"{lab.n_events / ms / 1e6:.2f} Geps; == plain"
            + (" == oracle" if histogram else ""))
        rows.append(dict(
            name=name, route="cuda",
            source="modkit_tpu_torch/csrc/lab_counts.cu", replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
    library = diag_library(lab)
    for mode, chunk_bytes, chunk_ops, replaces in DIAG_ROWS:
        ablation = mode in lc.ABLATIONS
        kern, plain, _ = kernel_lab.variant_call(
            "rep8-int8" if ablation else mode, lab, mode if ablation else None)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        require(torch.equal(got, want), f"diag {mode} kernel != plain")
        ms, call_ms = cuda_time_ms(kern, 100)
        plain_ms, _ = cuda_time_ms(plain, 5)
        lib = library[mode]
        require(torch.equal(lib().int().view(g, lc.P2, lc.LANES), want),
                f"diag {mode}: its library call != plain")
        lib_ms, _ = cuda_time_ms(lib, 20)
        nbytes = lab.n_chunks * (chunk_bytes + 4) + out_bytes
        b_ms, b_by = bound(nbytes, float(lab.n_chunks * chunk_ops))
        log(f"lab diag {mode}: {int((want != 0).sum()) / g:.1f} nonzero "
            f"cells per group, kernel {ms:.5f} ms (per call {call_ms:.5f} "
            f"ms), plain {plain_ms:.5f} ms, library {lib_ms:.5f} ms, "
            f"{nbytes} B, bound {b_ms:.5f} ms ({b_by}), share "
            f"{b_ms / ms:.3f}; == plain")
        rows.append(dict(
            name=f"{'run_rep8' if ablation else 'run_diag'}/{mode}",
            route="cuda", source="modkit_tpu_torch/csrc/lab_counts.cu",
            replaces=replaces, launches=diag_launches[mode], max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
    lab_one_position()
    return rows


def diag_library(lab) -> dict:
    """{diag mode or ablation: one PyTorch call that computes its output
    (flat, any integer or float dtype) from precomputed keys}: a
    ``torch.bincount`` (weighted where a slot adds more than one) or, for
    ``empty``, ``torch.zeros``."""
    import torch

    from modkit_tpu_torch.ops import lab_counts as lc

    g, n, chunk = lab.n_groups, lab.n_chunks, lab.chunk
    cells = g * lc.CELLS
    c2g, p2, col, valid = lab.planes
    grp = c2g.long().view(n, 1, 1) * lc.CELLS
    i = p2.long().view(n, lc.CR, lc.LANES)
    j = col.long().view(n, lc.CR, lc.LANES)
    v = valid.view(n, lc.CR, lc.LANES) != 0
    lane = torch.arange(lc.LANES, device=lab.dev).view(1, 1, lc.LANES)
    # the lab's plans hold every group in range
    oki = i < lc.P2
    onehot = torch.cat([(grp + i * lc.LANES + lane)[oki],
                        (grp + j * lc.LANES + lane)[v & (j >= 0)
                                                    & (j < lc.P2)]])
    j0 = j[:, :1].expand(-1, lc.CR, -1)
    ok0 = (v[:, :1].expand(-1, lc.CR, -1) & (j0 >= 0) & (j0 < lc.LANES)
           & oki)
    a_only = (grp + i * lc.LANES + j0)[ok0]
    matmul = (grp + i * lc.LANES + j0)[:, 0][ok0[:, 0]]
    matmul_w = torch.full(matmul.shape, float(lc.CR), device=lab.dev)
    p2r, colr = (x.long().view(n, lc.REP, chunk)[:, :, :lc.LANES]
                 for x in lab.rep8)
    row = torch.arange(lc.REP, device=lab.dev).view(1, lc.REP, 1)
    no_dot = torch.cat([(grp + x * lc.LANES + lane)[
        (x < lc.P2) & (x % lc.REP == row)] for x in (p2r, colr)])
    construct = c2g.long() * lc.CELLS
    construct_w = chunk * p2r[:, 0, 0].float()
    return {
        "empty": lambda: torch.zeros(cells, dtype=torch.int32,
                                     device=lab.dev),
        "onehot-only": lambda: torch.bincount(onehot, minlength=cells),
        "matmul-only": lambda: torch.bincount(matmul, matmul_w,
                                              minlength=cells),
        "a-only": lambda: torch.bincount(a_only, minlength=cells),
        "no-dot": lambda: torch.bincount(no_dot, minlength=cells),
        "no-construct": lambda: torch.bincount(construct, construct_w,
                                               minlength=cells),
    }


def lab_one_position() -> None:
    """The lab's events all at one position and strand, so one cell takes
    every slot of a chunk (the worst case for atomics to one address):
    kernel == plain == oracle for run_variant, run_rep8 and run_group, and
    kernel == plain for run_diag's a-only and onehot-only."""
    import numpy as np
    import torch

    from modkit_tpu_torch.tools import kernel_lab
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    events = kernel_lab.one_position_events(kernel_lab.EVENTS,
                                            kernel_lab.POSITIONS)
    lab = kernel_lab.LabInputs.build(events, kernel_lab.POSITIONS, "cuda")
    oracle = torch.from_numpy(lab.oracle()).to(lab.dev)
    require(int(np.count_nonzero(lab.oracle())) == 1,
            "one-position lab: more than one cell")
    for name, variant in (("run_variant", "int8x1"),
                          ("run_rep8", "rep8-int8"),
                          ("run_group", "group-int8"),
                          ("run_diag", "a-only"),
                          ("run_diag", "onehot-only")):
        kern, plain, histogram = kernel_lab.variant_call(variant, lab)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        require(torch.equal(got, want)
                and (not histogram or torch.equal(got, oracle)),
                f"one-position lab: {name} ({variant}) kernel != plain or "
                "the oracle")
        ms, _ = cuda_time_ms(kern, 20)
        log(f"lab one-position {name} ({variant}): {lab.n_chunks} chunks "
            f"on one position, kernel {ms:.5f} ms; == plain"
            + (" == oracle" if histogram else ""))


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "modkit_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (no "
              "modkit_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    os.environ["MODKIT_TPU_OFFLOAD"] = "always"
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from modkit_tpu_torch import native
    from modkit_tpu_torch.io.bam import BamReader
    from modkit_tpu_torch.ops.kernels import build_kernels
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam

    t0 = time.perf_counter()
    libs = build_kernels()
    log(f"built {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(os.path.basename(p) for p in libs))
    t0 = time.perf_counter()
    require(native.available(), "the host C++ runtime did not build")
    log(f"host runtime ready in {time.perf_counter() - t0:.1f} s")

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE)
    try:
        bam = os.path.join(work, "bench.bam")
        t0 = time.perf_counter()
        make_synthetic_modbam(bam, n_reads=BENCH_READS,
                              read_len=BENCH_READ_LEN,
                              coverage=BENCH_COVERAGE, seed=1)
        log(f"bench workload generated in {time.perf_counter() - t0:.1f} s")
        dev = torch.device("cuda")
        reader = BamReader(bam)
        tile = middle_tile(reader)
        require(tile.n_events > 0, "the bench tile has no events")
        phase_peaks()
        st = phase_state(tile, dev)
        ct = phase_counts(tile, dev)
        tile_layers(tile, dev, reader)
        state_launches = phase_main(bam, work)
        count_launches = phase_count_path(work)
        phase_profile(bam, work)
        many = phase_many_codes(tile, dev, work)
        lab_rows = phase_lab()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        dict(name="threshold_state", route="cuda",
             source="modkit_tpu_torch/csrc/state.cu",
             replaces="modkit_tpu/ops/pallas_state.py:91",
             launches=state_launches, max_abs_err=st["max_abs_err"],
             ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
             bound_by=st["bound_by"], library_ms=None),
        dict(name="modcall_counts", route="cuda",
             source="modkit_tpu_torch/csrc/counts.cu",
             replaces="modkit_tpu/ops/pallas_counts.py:210",
             launches=count_launches, max_abs_err=ct["max_abs_err"],
             ms=ct["ms"], plain_ms=ct["plain_ms"], bound_ms=ct["bound_ms"],
             bound_by=ct["bound_by"], library_ms=ct["library_ms"]),
        dict(name="threshold_state_f32_any_m", route="cuda",
             source="modkit_tpu_torch/csrc/state.cu",
             replaces="modkit_tpu/ops/pileup_counts.py:324",
             **many["threshold_state_f32_any_m"]),
        dict(name="modcall_counts_any_m", route="cuda",
             source="modkit_tpu_torch/csrc/counts.cu",
             replaces="modkit_tpu/ops/pallas_counts.py:210",
             **many["modcall_counts_any_m"]),
        *lab_rows,
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
