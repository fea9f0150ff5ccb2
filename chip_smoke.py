#!/usr/bin/env python3
"""Drive modkit_tpu_torch on one NVIDIA GPU and check its kernels.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It needs the CUDA toolkit (``nvcc``, found through ``CUDA_HOME``, ``PATH``
or ``/usr/local/cuda``) and ``g++``; it imports neither ``jax`` nor
``modkit_tpu``. Phases, each of which fails the run on any mismatch:

1. the card's name and power limit, the torch and CUDA versions;
2. build the kernels (one ``nvcc`` per ``csrc/*.cu``, started together)
   and the host C++ runtime;
3. the state kernel (``csrc/state.cu``) against its plain PyTorch version,
   exactly, on a real tile of the bench workload and on ragged sizes (N %
   16 takes every value, so planes 1.. start unaligned), for M in {1, 2,
   4, 8} and both entries, the f32 entry also on arbitrary f32 rows, with
   times and bounds; and the launch floor (the quals entry at N = 4096,
   M = 1);
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
   (kernel == plain);
10. CRAM input: a 10 000-read modBAM of the bench workload's shape (5 kb
    reads at 25x over a 2 Mbp contig, seed 1: 20 tiles, M = 2) written as
    a CRAM (``utils/synth_cram.py``), its pileup on ``cuda`` (the Python
    event route, kernel B on every tile), with ``use_device=False`` and
    through the native route of the source BAM, with no filtering and
    with the default threshold estimate: every bedMethyl of a mode
    byte-equal, kernel B launched once per tile with events, kernel A
    never on the CRAM;
11. ``run_pileup_counts`` (the full K = 6 + 4(M+1) count of modcall,
    nocall and delete events: kernel A's f32 entry, then a bincount) on
    ``cuda`` against the CPU, exactly, at P = 100 000, M = 2, on the bench
    tile's events with out-of-range ones among them, with one f32 launch;
12. downstream of pileup, through the port's CLI: sample A is phase 10's
    10 000-read modBAM, sample B is ``adjust-mods --convert h m`` of it;
    the pileup of each on ``cuda`` and under MODKIT_TPU_OFFLOAD=never,
    byte-equal, kernel A launched once per tile with events; each
    bedMethyl bgzipped and tabix-indexed; ``dmr pair`` over 500 regions of
    2 kb and per site, ``dmr multi`` over A, B and A, ``bedmethyl
    merge``/``tobigwig``, ``stats`` and ``localize`` on the bedMethyls of
    both routes (four processes side by side: each route's dmr steps and
    its tools), every output byte-equal between them; ``extract calls``
    with the default threshold estimate on phase 6's modBAM and
    ``pileup-hemi --cpg`` on a 2 000-read two-strand modBAM
    (``utils/synth_duplex.py``), each under MODKIT_TPU_OFFLOAD=always (the
    estimate's sort on the card, counted by ``thresholds.CUDA_SORTS``) and
    ``never`` (none), byte-equal;
13. the parallel paths and the last subcommands, on phase 12's sample A:
    ``entropy --cpg`` with the default estimate under
    MODKIT_TPU_OFFLOAD=always and ``never`` (no sort on the card in
    either: entropy estimates on the host), byte-equal; ``motif search
    --skip-search`` and ``motif evaluate`` on A's card and host
    bedMethyls (two processes side by side), byte-equal, and ``motif bed
    CG`` over its FASTA; ``run_sharded_pileup`` on a 4 x 2 grid of
    ``cuda:0`` over phase 11's events in 8 shards, equal to the CPU grid
    with 8 launches of kernel A's f32 entry; the pileup of A with
    ``compute_devices`` giving ``cuda:0`` once and 4 times, byte-equal,
    kernel A once per tile with events; and two processes on the card in
    a gloo group (MODKIT_TPU_COORD on localhost) running the shard-mode
    pileup and entropy of A, each byte-equal to one process's, their
    kernel A launches summing to the tiles with events;
14. the bench modBAM piled up with ``--ignore h`` (kernel A's f32 entry at
    M = 1 on every tile: collapsed probabilities leave the compact
    encoding) and with ``--combine-mods`` (its probabilities stay exact ML
    values: the quals entry at M = 2), with no filtering, on ``cuda``,
    under MODKIT_TPU_OFFLOAD=never and with ``use_device=False``, each mode
    byte-equal with its launches counted; then a 2 000-read modBAM with
    six mod codes (m_pad 8: the quals entry at M = 8) on ``cuda`` and under
    ``never``, byte-equal, one launch per tile with events.

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
# the CRAM phase's depth: the CRAM route is serial, so the bench's reads
# are cut to a fifth (a 2 Mbp contig at the same coverage)
CRAM_READS = 10_000
# phase 12: dmr's regions, and the two-strand modBAM of pileup-hemi, whose
# serial Python loop visits every read of a tile at every CpG of it: 1 kb
# reads and 10 kb tiles keep it near 10 s
DMR_REGIONS, DMR_REGION_LEN = 500, 2_000
HEMI_READS, HEMI_READ_LEN, HEMI_INTERVAL = 2_000, 1_000, 10_000
TILE = 100_000
COUNT_POSITIONS = 100_000
# what a kernels row takes from a phase's measurement
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")


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


# phase 3's event counts besides the bench tile's: N % 16 takes every value
# in 4096..4111, so the quals planes 1.. and the f32 entry's last group
# start at every offset
STATE_RAGGED = (1, 127, 128 * 1000 + 3, *range(4096, 4112))


def arbitrary_rows(rng, n: int, m: int, thr_mod, base):
    """f32 rows off the 1/256 grid: absent (−1), 0 and 1.0 values, values
    equal to their threshold, rows whose sum exceeds 1."""
    import numpy as np

    probs = rng.random((n, m), dtype=np.float32) * np.float32(1.5 / m)
    probs[rng.random((n, m)) < 0.15] = -1.0
    probs[rng.random((n, m)) < 0.05] = 0.0
    probs[rng.random((n, m)) < 0.02] = 1.0
    at_thr = rng.random((n, m)) < 0.1
    col = np.where((base >= 1) & (base <= 3), base, 0)  # the call's column
    return np.ascontiguousarray(
        np.where(at_thr, thr_mod.T[col], probs), dtype=np.float32)


def phase_state(tile, dev) -> dict:
    """Kernel A against its plain version at every M in {1, 2, 4, 8}, on
    the bench tile and on ragged counts, each entry also on arbitrary f32
    rows; times both entries at the tile's count. Returns {(entry, M):
    kernels entry} and, under "floor_ms", the launch floor: the quals entry
    at N = 4096, M = 1, timed the same way."""
    import numpy as np
    import torch

    from modkit_tpu_torch.ops import state
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    rng = np.random.default_rng(7)
    n_main = tile.n_events
    worst = 0

    def check(what: str, got, want) -> None:
        nonlocal worst
        torch.cuda.synchronize()
        worst = max(worst, int((got.int() - want.int()).abs().max().item()))
        require(torch.equal(got, want), f"state kernel ({what}) != plain")

    entries = {}
    for m in (1, 2, 4, 8):
        for n in (n_main, *STATE_RAGGED, n_main - 7):
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
            rows_d = torch.from_numpy(
                arbitrary_rows(rng, n, m, thr_mod, base)).to(dev)
            check(f"f32, arbitrary rows, M={m} N={n}",
                  state.threshold_state_f32(rows_d, gpu[3], tm, tc),
                  state.threshold_state_f32_plain(rows_d, gpu[3], tm, tc))
            for entry_name, kern, plain in (
                ("quals_t",
                 lambda: state.threshold_state_quals_t(*gpu, tm, tc),
                 lambda: state.threshold_state_quals_t_plain(*gpu, tm, tc)),
                ("f32",
                 lambda: state.threshold_state_f32(probs_d, gpu[3], tm, tc),
                 lambda: state.threshold_state_f32_plain(
                     probs_d, gpu[3], tm, tc)),
            ):
                check(f"{entry_name}, M={m} N={n}", kern(), plain())
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
                entries[entry_name, m] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    n=n, m=m)
    for entry in entries.values():
        entry["max_abs_err"] = worst
    log(f"state kernels == plain at M in (1, 2, 4, 8) on N in "
        f"{(n_main, *STATE_RAGGED, n_main - 7)}, f32 also on arbitrary rows")
    # the launch floor: a launch that moves almost nothing, timed back to
    # back as the kernels above
    n, m = 4096, 1
    q = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, (m, n)).astype(np.uint8),
        np.ones(n, dtype=np.uint8), np.zeros(n, dtype=np.uint8),
        rng.integers(0, 4, n).astype(np.uint8))]
    tm, tc = state.thresholds_to_tensors(np.zeros((m, 4)), np.zeros(4), m)
    floor_ms, _ = cuda_time_ms(
        lambda: state.threshold_state_quals_t(*q, tm, tc), 200)
    log(f"state launch floor: quals entry at N={n} M={m}: {floor_ms:.5f} ms")
    entries["floor_ms"] = floor_ms
    return entries


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
    """Set every kernel's launch count, and the count of threshold sorts
    on the card, to 0, just before a path runs."""
    from modkit_tpu_torch import thresholds
    from modkit_tpu_torch.ops import counts, lab_counts, state

    state.STATE_KERNEL_LAUNCHES = 0
    state.STATE_F32_KERNEL_LAUNCHES = 0
    counts.COUNT_KERNEL_LAUNCHES = 0
    lab_counts.reset_launches()
    thresholds.CUDA_SORTS = 0


def read_sorts() -> int:
    """Threshold estimates' ``torch.sort`` calls on a CUDA device since
    reset_launches()."""
    from modkit_tpu_torch import thresholds

    return thresholds.CUDA_SORTS


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


def phase_cram(work: str) -> int:
    """Pileup over a CRAM on the card (the Python event route: kernel B on
    every tile), with ``use_device=False`` and through the native route of
    the BAM it was written from; returns kernel B's launches in the
    no-filtering cuda run."""
    from modkit_tpu_torch.io.cram import CramReader
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam
    from modkit_tpu_torch.utils.synth_cram import write_cram

    t_phase = time.perf_counter()
    bam, fa, cram = (os.path.join(work, f"cram_src.{x}")
                     for x in ("bam", "fa", "cram"))
    make_synthetic_modbam(bam, n_reads=CRAM_READS, read_len=BENCH_READ_LEN,
                          coverage=BENCH_COVERAGE, seed=1, fasta_out=fa)
    t0 = time.perf_counter()
    info = write_cram(bam, fa, cram)
    t1 = time.perf_counter()
    n_decoded = len(CramReader(cram, fa)._decode_all())
    t2 = time.perf_counter()
    require(n_decoded == info["n_records"], "cram: records lost in decode")
    log(f"cram: {info['n_records']} records in {info['n_containers']} "
        f"containers, {os.path.getsize(cram)} B (BAM {os.path.getsize(bam)} "
        f"B), written in {t1 - t0:.1f} s; decoding every container "
        f"(native) to records takes {t2 - t1:.2f} s")
    routes = (("cram cuda", cram, dict(device="cuda")),
              ("cram host", cram, dict(device="cuda", use_device=False)),
              ("bam native cuda", bam, dict(device="cuda")))
    launches = None
    for mode, kw in (("no_filtering", dict(no_filtering=True)),
                     ("estimate", dict())):
        first, rates = None, []
        for route, src, extra in routes:
            out = os.path.join(work, f"cram.{mode}.{route.replace(' ', '_')}"
                               ".bed")
            reset_launches()
            t, stats = run_path(src, out, reference_fasta=fa, **kw, **extra)
            n_state, n_f32, n_count = read_launches()
            rates.append(f"{route} {CRAM_READS / t:.1f}")
            if first is None:
                first = out
                n_tiles = tiles_with_rows(out)
                require(stats["rows"] > 0, f"cram {mode}: no rows")
            else:
                require(filecmp.cmp(first, out, shallow=False),
                        f"cram {mode}: {route} wrote other bytes than "
                        "the cram cuda run")
            if route == "cram cuda":
                require(n_state == 0 and n_f32 == 0,
                        f"cram {mode}: a state kernel ran on the CRAM")
                require(n_count == n_tiles,
                        f"cram {mode}: {n_count} count launches for "
                        f"{n_tiles} tiles with events")
                if launches is None:
                    launches = n_count
            elif route == "cram host":
                require((n_state, n_f32, n_count) == (0, 0, 0),
                        f"cram {mode}: the host route launched")
        log(f"cram {mode}: {CRAM_READS} reads, {n_tiles} tiles, kernel B "
            f"launched {n_tiles} times on cuda, all three routes "
            f"byte-equal; reads/s: " + ", ".join(rates))
    log(f"cram phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def count_events(tile):
    """The bench tile's events for the full count (phases 11 and 13): at
    P = 100 000, M = 2, with random event types and some events at rpos -1
    and P; (rpos, strand, base, ev_type, probs, thr_mod, thr_can)."""
    import numpy as np

    rng = np.random.default_rng(17)
    rpos, strand, base, probs = tile.export_events()
    n, m = len(rpos), probs.shape[1]
    rpos = np.ascontiguousarray(rpos % COUNT_POSITIONS, dtype=np.int32)
    rpos[::101] = -1
    rpos[1::103] = COUNT_POSITIONS
    ev_type = rng.integers(0, 3, n).astype(np.int32)
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.5)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
    return rpos, strand, base, ev_type, probs, thr_mod, thr_can


def phase_pileup_counts(tile, dev) -> int:
    """``run_pileup_counts`` on the card against the CPU, exactly, on
    ``count_events``; its call is kernel A's f32 entry, launched once.
    Returns that launch count."""
    import numpy as np

    from modkit_tpu_torch.ops import counts

    args = (*count_events(tile), COUNT_POSITIONS)
    n, m = args[4].shape
    reset_launches()
    t0 = time.perf_counter()
    got = counts.run_pileup_counts(*args, device=dev)
    t1 = time.perf_counter()
    launches = read_launches()
    require(launches == (0, 1, 0),
            f"run_pileup_counts: launches {launches}, not one f32 launch")
    want = counts.run_pileup_counts(*args, device="cpu")
    t2 = time.perf_counter()
    require(np.array_equal(got, want), "run_pileup_counts: cuda != cpu")
    log(f"run_pileup_counts M={m} N={n} P={COUNT_POSITIONS}: cuda == cpu "
        f"({int(got.sum())} events counted, shape {got.shape}), kernel A's "
        f"f32 entry launched once; host clock cuda {(t1 - t0) * 1e3:.1f} ms "
        f"with copies, cpu {(t2 - t1) * 1e3:.1f} ms")
    return launches[1]


def cli(argv: list) -> float:
    """One call of the port's CLI in this process; returns its seconds."""
    from modkit_tpu_torch.cli import main as port_main

    t0 = time.perf_counter()
    require(port_main(argv) == 0, "modkit_tpu_torch " + " ".join(argv[:2]))
    return time.perf_counter() - t0


def count_lines(path: str) -> int:
    n = 0
    with open(path, "rb") as fh:
        while chunk := fh.read(1 << 24):
            n += chunk.count(b"\n")
    return n


def same_files(a: str, b: str, what: str) -> None:
    """Byte-equal files, or directories of byte-equal files."""
    if os.path.isdir(a):
        names = sorted(os.listdir(a))
        require(names and names == sorted(os.listdir(b)),
                f"{what}: other files")
        pairs = [(os.path.join(a, n), os.path.join(b, n)) for n in names]
    else:
        pairs = [(a, b)]
    for x, y in pairs:
        require(os.path.getsize(x) > 0, f"{what}: {x} is empty")
        require(filecmp.cmp(x, y, shallow=False),
                f"{what}: {os.path.basename(x)} differs between routes")


# the CLI runs of phase 12's bedMethyl steps, one process per route
_STEPS_DRIVER = (
    "import json, sys, time\n"
    "from modkit_tpu_torch.cli import main\n"
    "times = {}\n"
    "for name, argv in json.loads(sys.argv[1]):\n"
    "    t0 = time.perf_counter()\n"
    "    assert main(argv) == 0, name\n"
    "    times[name] = time.perf_counter() - t0\n"
    "print('STEP_TIMES ' + json.dumps(times))\n"
)


def downstream_steps(work: str, route: str, beds: dict, roi: str, sizes: str,
                     fa: str) -> tuple[list, list]:
    """(name, argv, output) of the bedMethyl steps on one route's
    bedMethyls of samples A and B: the dmr steps, and the tools."""
    a, b = beds[("a", route)], beds[("b", route)]
    o = os.path.join(work, f"down.{route}")
    dmr = ["--ref", fa, "--base", "C", "--suppress-progress"]
    dmr_steps = [
        ("dmr pair regions", ["dmr", "pair", "-a", a, "-b", b, "-r", roi,
                              "-o", o + ".pair_roi.bed", *dmr],
         o + ".pair_roi.bed"),
        ("dmr pair sites", ["dmr", "pair", "-a", a, "-b", b, "-o",
                            o + ".pair_sites.bed", *dmr],
         o + ".pair_sites.bed"),
        ("dmr multi", ["dmr", "multi", "-s", a, "a", "-s", b, "b", "-s", a,
                       "c", "-r", roi, "-o", o + ".multi", *dmr],
         o + ".multi"),
    ]
    tool_steps = [
        ("bedmethyl merge", ["bedmethyl", "merge", a, b, "-g", sizes, "-o",
                             o + ".merged.bed"], o + ".merged.bed"),
        ("bedmethyl tobigwig", ["bedmethyl", "tobigwig", a[:-len(".gz")],
                                o + ".bw", "-g", sizes, "-m", "m,h"],
         o + ".bw"),
        ("stats", ["stats", a, "--regions", roi, "-o", o + ".stats.tsv"],
         o + ".stats.tsv"),
        ("localize", ["localize", a, "--regions", roi, "-r", sizes, "-o",
                      o + ".localize.tsv"], o + ".localize.tsv"),
    ]
    return dmr_steps, tool_steps


def run_steps_side_by_side(work: str, steps: dict) -> dict:
    """Run each list of steps in a process of its own, all at once;
    returns {key: {step: seconds}}."""
    procs = {}
    try:
        for key, rsteps in steps.items():
            log_path = os.path.join(work, f"down.{key}.log")
            with open(log_path, "w") as fh:
                procs[key] = (subprocess.Popen(
                    [sys.executable, "-c", _STEPS_DRIVER,
                     json.dumps([(n, argv) for n, argv, _ in rsteps])],
                    cwd=HERE, stdout=fh, stderr=subprocess.STDOUT), log_path)
        times = {}
        for key, (proc, log_path) in procs.items():
            rc = proc.wait(timeout=900)
            text = open(log_path).read()
            require(rc == 0, f"downstream steps {key}: exit {rc}:\n"
                    + text[-4000:])
            line = [x for x in text.splitlines()
                    if x.startswith("STEP_TIMES ")][-1]
            times[key] = json.loads(line.split(" ", 1)[1])
        return times
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_downstream(work: str, a_bam: str, fa: str, small_bam: str,
                     card: str) -> int:
    """Phase 12: the port's tools downstream of pileup, on the card's and
    the host's bedMethyls; returns kernel A's launches over the two cuda
    pileups."""
    import numpy as np

    from modkit_tpu_torch.io.bam import BamReader, build_bai
    from modkit_tpu_torch.io.tabix import bgzip_text, build_tabix
    from modkit_tpu_torch.utils.synth_duplex import make_duplex_modbam

    t_phase = time.perf_counter()
    b_bam = os.path.join(work, "down_b.bam")
    t = cli(["adjust-mods", a_bam, b_bam, "--convert", "h", "m",
             "--suppress-progress"])
    build_bai(b_bam)
    log(f"downstream: sample B = adjust-mods --convert h m of A "
        f"({CRAM_READS} reads) in {t:.2f} s")

    # 1. pileup of A and B on cuda and on the host, indexed
    beds, launches = {}, 0
    for sample, bam in (("a", a_bam), ("b", b_bam)):
        outs, secs = {}, {}
        for route, offload in (("cuda", "always"), ("host", "never")):
            out = os.path.join(work, f"down_{sample}.{route}.bed")
            os.environ["MODKIT_TPU_OFFLOAD"] = offload
            reset_launches()
            try:
                secs[route] = cli(["pileup", bam, out, "--no-filtering",
                                   "--suppress-progress"])
            finally:
                os.environ["MODKIT_TPU_OFFLOAD"] = "always"
            n_state, n_f32, n_count = read_launches()
            outs[route] = out
            if route == "cuda":
                n_tiles = tiles_with_rows(out)
                require(n_state == n_tiles and n_f32 == 0 and n_count == 0,
                        f"downstream pileup {sample}: launches "
                        f"{(n_state, n_f32, n_count)} for {n_tiles} tiles")
                launches += n_state
            else:
                require((n_state, n_f32, n_count) == (0, 0, 0),
                        f"downstream pileup {sample}: the host route "
                        "launched")
        same_files(outs["cuda"], outs["host"], f"downstream pileup {sample}")
        t0 = time.perf_counter()
        for route, out in outs.items():
            bgzip_text(out, out + ".gz")
            build_tabix(out + ".gz")
            beds[(sample, route)] = out + ".gz"
        log(f"downstream pileup {sample}: {count_lines(outs['cuda'])} rows, "
            f"{n_tiles} tiles, kernel A launched {n_tiles} times on cuda; "
            f"cuda {secs['cuda']:.2f} s ({CRAM_READS / secs['cuda']:.1f} "
            f"reads/s), host {secs['host']:.2f} s; byte-equal; bgzip + "
            f"tabix of both {time.perf_counter() - t0:.2f} s")

    # 2-3. dmr and the bedMethyl tools on each route's bedMethyls
    length = BamReader(a_bam).header.refs[0].length
    roi = os.path.join(work, "down_roi.bed")
    with open(roi, "w") as fh:
        for i, start in enumerate(np.linspace(0, length - DMR_REGION_LEN,
                                              DMR_REGIONS, dtype=np.int64)):
            fh.write(f"synth1\t{start}\t{start + DMR_REGION_LEN}\troi{i}\n")
    sizes = os.path.join(work, "down_sizes.tsv")
    with open(sizes, "w") as fh:
        fh.write(f"synth1\t{length}\n")
    # four processes side by side: each route's dmr steps and its tools
    steps = {}
    for route in ("cuda", "host"):
        dmr_steps, tool_steps = downstream_steps(work, route, beds, roi,
                                                 sizes, fa)
        steps[f"{route}.dmr"], steps[f"{route}.tools"] = dmr_steps, tool_steps
    times = {}
    for key, t in run_steps_side_by_side(work, steps).items():
        times.setdefault(key.split(".")[0], {}).update(t)
    for group in ("dmr", "tools"):
        for (name, _, out_c), (_, _, out_h) in zip(steps[f"cuda.{group}"],
                                                   steps[f"host.{group}"]):
            same_files(out_c, out_h, name)
    sites = count_lines(steps["cuda.dmr"][1][2])
    # what each dmr step scores: regions (3 pairs of samples in multi)
    units = {"dmr pair regions": (DMR_REGIONS, "regions"),
             "dmr pair sites": (sites, "sites"),
             "dmr multi": (3 * DMR_REGIONS, "regions")}
    for name in times["cuda"]:
        t = times["cuda"][name]
        rate = (f", {units[name][0] / t:.1f} {units[name][1]}/s"
                if name in units else "")
        log(f"downstream {name}: cuda bedMethyls {t:.2f} s{rate}, host "
            f"bedMethyls {times['host'][name]:.2f} s (4 processes side by "
            "side); byte-equal")
    log(f"downstream dmr pair sites: {sites} sites scored")

    # 4-5. the estimates' forced sort: extract calls and pileup-hemi
    hemi_bam = os.path.join(work, "hemi.bam")
    hemi_fa = os.path.join(work, "hemi.fa")
    make_duplex_modbam(hemi_bam, n_reads=HEMI_READS, read_len=HEMI_READ_LEN,
                       coverage=BENCH_COVERAGE, seed=4, fasta_out=hemi_fa)
    for name, argv, out, n_in, unit in (
            ("extract calls", ["extract", "calls", small_bam, "{out}",
                               "--force", "--suppress-progress"],
             "extract", 2000, "rows"),
            ("pileup-hemi", ["pileup-hemi", hemi_bam, "-o", "{out}", "--cpg",
                             "-r", hemi_fa, "-i", str(HEMI_INTERVAL),
                             "--suppress-progress"],
             "hemi", HEMI_READS, "reads")):
        outs, secs, sorts = {}, {}, {}
        for offload in ("always", "never"):
            outs[offload] = os.path.join(work, f"{out}.{offload}.txt")
            os.environ["MODKIT_TPU_OFFLOAD"] = offload
            reset_launches()
            try:
                secs[offload] = cli([x.format(out=outs[offload])
                                     for x in argv])
            finally:
                os.environ["MODKIT_TPU_OFFLOAD"] = "always"
            sorts[offload] = read_sorts()
        require(sorts["always"] > 0 and sorts["never"] == 0,
                f"{name}: sorts on the card {sorts}")
        same_files(outs["always"], outs["never"], name)
        rows = count_lines(outs["always"])
        require(rows > 1, f"{name}: no rows")
        rate = (rows - 1 if unit == "rows" else n_in) / secs["always"]
        log(f"downstream {name}: {rows} lines, always {secs['always']:.2f} s "
            f"({sorts['always']} sorts on the card, {rate:.0f} {unit}/s), "
            f"never {secs['never']:.2f} s (no sort on the card); byte-equal")
        for path in outs.values():
            os.remove(path)
    log(f"downstream phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


# phase 13: the sharded count's grid on the one card, the devices of the
# 1-vs-N pileup, and the shard runs' processes
MESH_TILES, MESH_READERS = 4, 2
N_DEVICES = 4
SHARD_PROCESSES = 2

# one rank of phase 13's shard runs: the port's CLI, then kernel A's
# launches in this process
_SHARD_RANK = (
    "import json, sys\n"
    "from modkit_tpu_torch.cli import main\n"
    "from modkit_tpu_torch.ops import state\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    assert main(argv) == 0, argv[:2]\n"
    "print('LAUNCHES ' + json.dumps([state.STATE_KERNEL_LAUNCHES,\n"
    "                                state.STATE_F32_KERNEL_LAUNCHES]))\n"
)


def phase_entropy_and_motifs(work: str, a_bam: str, fa: str) -> str:
    """Phase 13, steps 1-2: ``entropy --cpg`` with the default estimate
    under MODKIT_TPU_OFFLOAD=always and never, and the motif commands on
    the card's and the host's bedMethyls of A; returns the entropy
    bedgraph."""
    import contextlib
    import re

    outs, secs, sorts = {}, {}, {}
    for offload in ("always", "never"):
        outs[offload] = os.path.join(work, f"entropy.{offload}.bedgraph")
        os.environ["MODKIT_TPU_OFFLOAD"] = offload
        reset_launches()
        try:
            secs[offload] = cli(["entropy", "-s", a_bam, "--ref", fa,
                                 "--cpg", "-o", outs[offload], "--force",
                                 "--suppress-progress"])
        finally:
            os.environ["MODKIT_TPU_OFFLOAD"] = "always"
        sorts[offload] = read_sorts()
        require(read_launches() == (0, 0, 0), "entropy launched a kernel")
    # modkit_tpu's entropy estimates on the host (np.sort of the sampled
    # confidences, engines/entropy.py), whatever the offload mode
    require(sorts == {"always": 0, "never": 0},
            f"entropy: sorts on the card {sorts}")
    same_files(outs["always"], outs["never"], "entropy")
    rows = count_lines(outs["always"])
    log(f"entropy --cpg: {rows} windows, always {secs['always']:.2f} s "
        f"({rows / secs['always']:.1f} windows/s), never "
        f"{secs['never']:.2f} s ({rows / secs['never']:.1f} windows/s); no "
        "sort on the card in either (the estimate sorts on the host, as "
        "modkit_tpu's does); byte-equal")

    steps = {}
    for route in ("cuda", "host"):
        bed = os.path.join(work, f"down_a.{route}.bed")
        o = os.path.join(work, f"motif.{route}")
        steps[route] = [
            ("motif search --skip-search",
             ["motif", "search", "-i", bed, "-r", fa, "-o", o + ".search",
              "--skip-search", "--suppress-progress"], o + ".search"),
            ("motif evaluate",
             ["motif", "evaluate", "-i", bed, "-r", fa, "--out",
              o + ".evaluate", "--known-motif", "CG", "0", "m",
              "--known-motif", "CG", "0", "h", "--suppress-progress"],
             o + ".evaluate"),
        ]
    times = run_steps_side_by_side(work, steps)
    for (name, _, out_c), (_, _, out_h) in zip(steps["cuda"], steps["host"]):
        same_files(out_c, out_h, name)
        log(f"{name}: cuda bedMethyl {times['cuda'][name]:.2f} s, host "
            f"bedMethyl {times['host'][name]:.2f} s (2 processes side by "
            f"side), {count_lines(out_c) - 1} motifs; byte-equal")
    bed = os.path.join(work, "motif_bed.bed")
    with open(bed, "w") as fh, contextlib.redirect_stdout(fh):
        t = cli(["motif", "bed", fa, "CG", "0"])
    with open(fa) as fh:
        seq = "".join(line.strip() for line in fh if not line.startswith(">"))
    hits = len(re.findall("(?=CG)", seq.upper()))
    require(count_lines(bed) == 2 * hits > 0,
            f"motif bed: {count_lines(bed)} rows for {hits} CpGs")
    log(f"motif bed CG: {2 * hits} rows (both strands of {hits} CpGs) in "
        f"{t:.2f} s")
    return outs["always"]


def phase_sharded(tile, dev) -> dict:
    """Phase 13, step 3: ``run_sharded_pileup`` on a 4 x 2 grid of the one
    card over ``count_events`` split into 8 shards, against the CPU grid,
    exactly; one kernel A f32 launch per shard. Returns the launches."""
    import numpy as np
    import torch

    from modkit_tpu_torch.parallel import sharded_pileup as sp
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    rpos, strand, base, ev_type, probs, thr_mod, thr_can = count_events(tile)
    t, r = MESH_TILES, MESH_READERS
    n, m = probs.shape
    e = -(-n // (t * r))
    pad = t * r * e - n

    def shards(a, fill):
        a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return a.reshape((t, r, e) + a.shape[1:])

    valid = np.arange(t * r * e) < n
    args = (shards(rpos, 0), shards(strand, 0), shards(base, 0),
            shards(ev_type, 0), shards(probs, -1.0),
            valid.reshape(t, r, e), thr_mod, thr_can, COUNT_POSITIONS)
    mesh = sp.make_mesh(t, r, [dev] * (t * r))
    reset_launches()
    t0 = time.perf_counter()
    got = sp.run_sharded_pileup(mesh, *args)
    t1 = time.perf_counter()
    launches = read_launches()
    require(launches == (0, t * r, 0),
            f"sharded pileup: launches {launches}, not {t * r} f32 ones")
    want = sp.run_sharded_pileup(sp.make_mesh(t, r, ["cpu"] * (t * r)),
                                 *args)
    require(np.array_equal(got, want), "sharded pileup: cuda != cpu")
    step = sp.make_sharded_pileup_step(mesh, COUNT_POSITIONS, m)
    placed = [[tuple(torch.from_numpy(np.ascontiguousarray(a[i, j])).to(dev)
                     for a in args[:6]) for j in range(r)] for i in range(t)]
    tm, tc = torch.from_numpy(thr_mod), torch.from_numpy(thr_can)
    ms, call_ms = cuda_time_ms(lambda: step(placed, tm, tc), 20)
    log(f"sharded pileup {t} x {r} grid of {dev} over N={n} events ({e} per "
        f"shard, M={m}, P={COUNT_POSITIONS}): == cpu grid "
        f"({int(got.sum())} events counted, shape {got.shape}); kernel A's "
        f"f32 entry launched {launches[1]} times; the step {ms:.3f} ms "
        f"(CUDA events; per call {call_ms:.3f} ms), with uploads and the "
        f"copy back {(t1 - t0) * 1e3:.1f} ms (host clock)")
    return dict(launches=launches[1], ms=ms, call_ms=call_ms)


def phase_one_vs_n(work: str, a_bam: str, card) -> None:
    """Phase 13, step 4: the pileup of A with ``compute_devices`` giving 1
    and then N_DEVICES entries of ``card`` (``cuda:0``: tiles round-robin
    over them, each on its thread's stream): byte-equal, kernel A once per
    tile with events both times."""
    from modkit_tpu_torch.parallel import devices

    real = devices.compute_devices
    outs, secs = {}, {}
    try:
        for n in (1, N_DEVICES):
            devices.compute_devices = lambda device, n=n: [card] * n
            outs[n] = os.path.join(work, f"devices{n}.bed")
            reset_launches()
            secs[n], _ = run_path(a_bam, outs[n], device=str(card),
                                  no_filtering=True)
            launches = read_launches()
            n_tiles = tiles_with_rows(outs[n])
            require(launches == (n_tiles, 0, 0),
                    f"{n} devices: launches {launches} for {n_tiles} tiles")
    finally:
        devices.compute_devices = real
    same_files(outs[1], outs[N_DEVICES], "1-vs-N pileup")
    log(f"1-vs-N pileup of A: {card} x 1 {secs[1]:.2f} s, x {N_DEVICES} "
        f"{secs[N_DEVICES]:.2f} s, kernel A launched {n_tiles} times each "
        f"({n_tiles} tiles); byte-equal")


def phase_shard_processes(work: str, a_bam: str, fa: str, single_bed: str,
                          single_entropy: str, dev) -> list:
    """Phase 13, step 5: SHARD_PROCESSES processes on the one card in a
    gloo group (MODKIT_TPU_COORD on localhost): the shard-mode pileup and
    entropy of A, each byte-equal to the single process's; kernel A's
    launches over the ranks sum to the tiles with events. Returns each
    rank's launches."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    bed = os.path.join(work, "shards.bed")
    ent = os.path.join(work, "shards.bedgraph")
    argv = [["pileup", a_bam, bed, "--no-filtering", "--suppress-progress",
             "--device", dev.type],
            ["entropy", "-s", a_bam, "--ref", fa, "--cpg", "-o", ent,
             "--force", "--suppress-progress"]]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(SHARD_PROCESSES):
            log_path = os.path.join(work, f"shard{rank}.log")
            env = dict(os.environ, MODKIT_TPU_COORD=f"127.0.0.1:{port}",
                       MODKIT_TPU_NPROC=str(SHARD_PROCESSES),
                       MODKIT_TPU_PROC_ID=str(rank))
            with open(log_path, "w") as fh:
                procs.append((subprocess.Popen(
                    [sys.executable, "-c", _SHARD_RANK, json.dumps(argv)],
                    cwd=HERE, env=env, stdout=fh, stderr=subprocess.STDOUT),
                    log_path))
        launches = []
        for rank, (proc, log_path) in enumerate(procs):
            rc = proc.wait(timeout=600)
            text = open(log_path).read()
            require(rc == 0, f"shard rank {rank}: exit {rc}:\n" + text[-4000:])
            line = [x for x in text.splitlines()
                    if x.startswith("LAUNCHES ")][-1]
            launches.append(json.loads(line.split(" ", 1)[1]))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    same_files(single_bed, bed, "shard-mode pileup")
    same_files(single_entropy, ent, "shard-mode entropy")
    n_tiles = tiles_with_rows(bed)
    require(sum(q for q, _ in launches) == n_tiles
            and all(q > 0 and f == 0 for q, f in launches),
            f"shard runs: launches {launches} for {n_tiles} tiles")
    log(f"shard runs: {SHARD_PROCESSES} processes on the one card (gloo), "
        f"pileup + entropy of A in {secs:.1f} s; kernel A launches per rank "
        f"{[q for q, _ in launches]} (sum {n_tiles} = tiles); pileup and "
        "entropy byte-equal to one process")
    return launches


# phase 14: the bench modBAM's pileups that leave the compact encoding or
# keep it, and the six-code modBAM (m_pad 8: the quals entry at M = 8)
SIX_READS = 2000


def phase_collapse_and_six_codes(bam: str, work: str) -> dict:
    """Pileups of the bench modBAM with ``--ignore h`` (the f32 entry at M
    = 1: collapsed probabilities are not exact ML values) and with
    ``--combine-mods`` (its probabilities stay exact ML values, so the
    quals entry at M = 2), with no filtering on ``cuda``, under
    MODKIT_TPU_OFFLOAD=never and with ``use_device=False``, byte-equal per
    mode; then a six-code modBAM on ``cuda`` and under ``never``,
    byte-equal. Returns {"f32_m1": launches of the ``--ignore h`` cuda run,
    "quals_m8": launches of the six-code cuda run}."""
    from modkit_tpu_torch.collapse import CollapseMethod
    from modkit_tpu_torch.utils.synth_codes import (
        NINE_CODES, make_multicode_modbam,
    )

    routes = (("cuda", "always", dict()),
              ("host C++", "never", dict()),
              ("host numpy", "always", dict(use_device=False)))
    # mode: (pileup options, index in read_launches() of the entry it runs)
    modes = {
        "ignore h": (dict(collapse=[CollapseMethod("dist", ("h",))]), 1),
        "combine-mods": (dict(combine_mods=True), 0),
    }

    def run(path: str, out: str, offload: str, **kw) -> tuple:
        os.environ["MODKIT_TPU_OFFLOAD"] = offload
        reset_launches()
        try:
            t, stats = run_path(path, out, device="cuda", no_filtering=True,
                                **kw)
        finally:
            os.environ["MODKIT_TPU_OFFLOAD"] = "always"
        require(stats["rows"] > 0, f"{out}: no rows")
        return t, read_launches()

    launches = {}
    for mode, (kw, entry) in modes.items():
        first, secs = None, {}
        for route, offload, extra in routes:
            out = os.path.join(work, f"{mode.replace(' ', '_')}."
                                     f"{route.replace(' ', '_')}.bed")
            secs[route], got = run(bam, out, offload, **kw, **extra)
            if first is None:
                first = out
                n_tiles = tiles_with_rows(out)
                want = [0, 0, 0]
                want[entry] = n_tiles
                require(list(got) == want,
                        f"{mode}: cuda launches {got}, want {want}")
                launches[mode] = got[entry]
            else:
                require(got == (0, 0, 0), f"{mode}: {route} launched {got}")
                require(filecmp.cmp(first, out, shallow=False),
                        f"{mode}: the {route} route wrote other bytes")
        log(f"{mode}: {n_tiles} tiles, {launches[mode]} "
            f"{'f32' if entry else 'quals'} state launches on cuda, "
            "byte-equal on the three routes; reads/s "
            + ", ".join(f"{r} {BENCH_READS / t:.0f}" for r, t in secs.items()))
    six = os.path.join(work, "six.bam")
    make_multicode_modbam(six, n_reads=SIX_READS, read_len=BENCH_READ_LEN,
                          seed=5, codes=NINE_CODES[:6])
    outs, secs = {}, {}
    for route, offload, _ in routes[:2]:
        outs[route] = os.path.join(work, f"six.{route.replace(' ', '_')}.bed")
        secs[route], got = run(six, outs[route], offload)
        if route == "cuda":
            n_tiles = tiles_with_rows(outs[route])
            require(got == (n_tiles, 0, 0),
                    f"six codes: cuda launches {got}, want ({n_tiles}, 0, 0)")
            launches["six codes"] = got[0]
        else:
            require(got == (0, 0, 0), f"six codes: {route} launched {got}")
    require(filecmp.cmp(outs["cuda"], outs["host C++"], shallow=False),
            "six codes: the host C++ route wrote other bytes")
    log(f"six codes ({SIX_READS} reads, m_pad 8): {n_tiles} tiles, "
        f"{launches['six codes']} quals state launches at M = 8 on cuda, "
        "byte-equal to host C++; s "
        + ", ".join(f"{r} {t:.3f}" for r, t in secs.items()))
    return dict(f32_m1=launches["ignore h"], quals_m8=launches["six codes"])


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
        cram_launches = phase_cram(work)
        counts_f32_launches = phase_pileup_counts(tile, dev)
        a_bam = os.path.join(work, "cram_src.bam")
        a_fa = os.path.join(work, "cram_src.fa")
        down_launches = phase_downstream(
            work, a_bam, a_fa, os.path.join(work, "small.bam"), card)
        t_phase = time.perf_counter()
        entropy_out = phase_entropy_and_motifs(work, a_bam, a_fa)
        sharded = phase_sharded(tile, dev)
        phase_one_vs_n(work, a_bam, torch.device("cuda", 0))
        phase_shard_processes(work, a_bam, a_fa,
                              os.path.join(work, "down_a.cuda.bed"),
                              entropy_out, dev)
        log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s on "
            f"{card}")
        t_phase = time.perf_counter()
        collapse = phase_collapse_and_six_codes(bam, work)
        log(f"collapse and six-code phase: "
            f"{time.perf_counter() - t_phase:.1f} s on {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        dict(name="threshold_state", route="cuda",
             source="modkit_tpu_torch/csrc/state.cu",
             replaces="modkit_tpu/ops/pallas_state.py:91",
             launches=state_launches, library_ms=None,
             **{k: st["quals_t", tile.m][k] for k in KERNEL_KEYS}),
        dict(name="threshold_state_m8", route="cuda",
             source="modkit_tpu_torch/csrc/state.cu",
             replaces="modkit_tpu/ops/pallas_state.py:91",
             launches=collapse["quals_m8"], library_ms=None,
             **{k: st["quals_t", 8][k] for k in KERNEL_KEYS}),
        dict(name="threshold_state_f32", route="cuda",
             source="modkit_tpu_torch/csrc/state.cu",
             replaces="modkit_tpu/ops/pileup_counts.py:324",
             launches=counts_f32_launches + sharded["launches"],
             library_ms=None,
             **{k: st["f32", tile.m][k] for k in KERNEL_KEYS}),
        dict(name="threshold_state_f32_m1", route="cuda",
             source="modkit_tpu_torch/csrc/state.cu",
             replaces="modkit_tpu/ops/pileup_counts.py:324",
             launches=collapse["f32_m1"], library_ms=None,
             **{k: st["f32", 1][k] for k in KERNEL_KEYS}),
        dict(name="modcall_counts", route="cuda",
             source="modkit_tpu_torch/csrc/counts.cu",
             replaces="modkit_tpu/ops/pallas_counts.py:210",
             launches=count_launches + cram_launches,
             max_abs_err=ct["max_abs_err"],
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
    log(f"kernel A launches: main path {state_launches}, downstream "
        f"pileups {down_launches}, six codes (M = 8) "
        f"{collapse['quals_m8']}; f32 entry: run_pileup_counts "
        f"{counts_f32_launches}, sharded pileup {sharded['launches']}, "
        f"--ignore h (M = 1) {collapse['f32_m1']}; launch floor "
        f"{st['floor_ms']:.5f} ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
