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
   4, 8} and both entries, the f32 entry also on arbitrary f32 rows and on
   views its rows kernel cannot load as they are (``probs`` at a 4-byte
   offset at every M, ``base`` at an odd one at M = 1: one aligned copy
   counted per such view), with times (warm, and L2-cold over copies of
   the inputs that hold four times the L2 together), bytes and bounds;
   and the launch floor (the quals entry at N = 4096, M = 1);
4. the count kernel (``csrc/counts.cu``) against its plain version,
   exactly, at the tile's shape with P = 100 000 and M in {2, 4, 8}, with
   ``torch.bincount`` over precomputed keys as the library yardstick; at
   M = 2 also with every event at one position and into an output first
   filled with 0x7f7f7f7f (the kernel writes every cell), each timed;
5. the main path: ``run_pileup`` on ``cuda`` over the bench workload
   (50 000 reads x 5 kb at 25x over a 10 Mbp contig, seed 1: 100 tiles of
   100 kb), with no filtering and with the default threshold estimate (its
   sort on the host), in three rounds beside the same run on ``cpu`` (the
   kernels' plain versions), every run byte-equal; the state kernel's
   launches in each device run must equal the tiles with events, with no
   aligned copy of a view; then the pinned blocks PyTorch's caching host
   allocator holds;
6. the count path: the Python event route (native decoder off) on a
   2 000-read modBAM, byte-equal to the native route on ``cpu``, with
   count-kernel launches > 0.
7. one more device run traced with ``MODKIT_TPU_PROFILE`` (the card's
   activity and the program's spans on one clock): the card's busy share
   over the traced window and its busiest ops, each span in ms per tile
   summed over the threads, and the spans under the longest idle gaps.
8. more than 8 mod codes: the runtime-M kernels of kernel A's f32 entry
   and of kernel B against their plain versions for M in {3, 9, 16}, and a 9-code pileup on ``cuda``
   through the native route (kernel A's f32 entry) and the Python event
   route (kernel B), each byte-equal to the run on ``cpu``;
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
    event route, kernel B on every tile), on ``cpu`` and through the
    native route of the source BAM, with no filtering and
    with the default threshold estimate: every bedMethyl of a mode
    byte-equal, kernel B launched once per tile with events, kernel A
    never on the CRAM;
11. ``run_pileup_counts`` (the full K = 6 + 4(M+1) count of modcall,
    nocall and delete events: kernel A's f32 entry, then a bincount) on
    ``cuda`` against the CPU, exactly, at P = 100 000, M = 2, on the bench
    tile's events with out-of-range ones among them, with one f32 launch;
12. downstream of pileup, through the port's CLI: sample A is phase 10's
    10 000-read modBAM, sample B is ``adjust-mods --convert h m`` of it;
    the pileup of each on ``cuda`` and on ``cpu``, byte-equal, kernel A
    launched once per tile with events; each
    bedMethyl bgzipped and tabix-indexed; ``dmr pair`` over 500 regions of
    2 kb and per site, ``dmr multi`` over A, B and A, ``bedmethyl
    merge``/``tobigwig``, ``stats`` and ``localize`` on the bedMethyls of
    both routes (four processes side by side: each route's dmr steps and
    its tools), every output byte-equal between them; ``extract calls``
    with the default threshold estimate on phase 6's modBAM and
    ``pileup-hemi --cpg`` on a 2 000-read two-strand modBAM
    (``utils/synth_duplex.py``), each estimate sorted on the host;
13. the parallel paths and the last subcommands, on phase 12's sample A:
    ``entropy --cpg`` with the default estimate (sorted on the host);
    ``motif search --skip-search`` and ``motif evaluate`` on A's cuda and
    cpu bedMethyls (two processes side by side), byte-equal, and ``motif
    bed CG`` over its FASTA; ``run_sharded_pileup`` on a 4 x 2 grid of
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
    values: the quals entry at M = 2), and a 2 000-read modBAM with six
    mod codes (m_pad 8: the quals entry at M = 8), with no filtering, on
    ``cuda`` and on ``cpu``, each byte-equal, one launch per tile with
    events on ``cuda`` (no aligned copy in any of these runs);
15. the all-C++ CPU baseline (``cpu_baseline.run_pileup_cpu``) over the
    bench modBAM, with no filtering and with the estimate, byte-equal to
    phase 5's cuda bedMethyls; then the measuring tools, each in its own
    process: ``tools/bench.py`` at 5 000 reads (entropy, extract and dmr
    at 1 000, one rep; its kernel rooflines at full size, warm and
    L2-cold), every ``*_identical``/``*_equal*`` field of its JSON true
    and kernel A launched on its timed runs, then ``tools/
    scale_bench.py`` at 20 000 reads on ``cuda`` and with ``--device
    cpu`` and ``tools/multichip_model.py`` at 5 000 side by side, each
    exiting 0 with its JSON (the multichip pileups over 1, 2, 4 and 8
    listed devices byte-equal; each scale run's host memory printed: RSS
    after each stage, the phases' peaks of RSS and of the BAM's mapped
    pages, the pinned blocks; on ``cuda`` the journal pileup may leave at
    most 256 MB more RSS than the default one, and the peak may exceed
    the ``--device cpu`` run's by at most 512 MB), and no tool writing the
    repository's ``BENCH_SCALE_r05.json`` or ``MULTICHIP_MODEL.json``.

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
# phase 3's L2-cold timing: at about 0.04 ms of host time a call, 256
# calls enqueue well inside the 25 ms sleep cuda_time_ms queues first
COLD_CALLS = 256


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


def misaligned_views(rng, n: int, dev, check) -> None:
    """Kernel A's f32 entry on views its rows kernel cannot load as they
    are: ``probs`` one row element past an aligned allocation at M in {1,
    2, 4, 8}, and at M = 1 ``base`` one byte past one, each equal to the
    plain version with one aligned copy per such view counted."""
    import numpy as np
    import torch

    from modkit_tpu_torch.ops import state

    def odd(a):
        t = torch.from_numpy(a).to(dev)
        buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=dev)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    for m in (1, 2, 4, 8):
        base = rng.integers(0, 4, n).astype(np.uint8)
        thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.8)
        thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
        tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
        rows = arbitrary_rows(rng, n, m, thr_mod, base)
        aligned = [torch.from_numpy(a).to(dev) for a in (rows, base)]
        cases = [("probs", odd(rows), aligned[1], 1)]
        if m == 1:
            cases += [("base", aligned[0], odd(base), 1),
                      ("probs and base", odd(rows), odd(base), 2)]
        for what, probs, b, copies in cases:
            before = state.STATE_F32_COPIES
            check(f"f32, misaligned {what}, M={m} N={n}",
                  state.threshold_state_f32(probs, b, tm, tc),
                  state.threshold_state_f32_plain(probs, b, tm, tc))
            got = state.STATE_F32_COPIES - before
            require(got == copies, f"f32 misaligned {what} at M={m}: "
                                   f"{got} copies, want {copies}")
    log(f"state f32 on misaligned views (probs at M in (1, 2, 4, 8), base "
        f"at M = 1, N={n}): == plain, one aligned copy per such view")


def phase_state(tile, dev) -> dict:
    """Kernel A against its plain version at every M in {1, 2, 4, 8}, on
    the bench tile and on ragged counts, each entry also on arbitrary f32
    rows; times both entries at the tile's count. Returns {(entry, M):
    kernels entry} and, under "floor_ms", the launch floor: the quals entry
    at N = 4096, M = 1, timed the same way."""
    import numpy as np
    import torch

    from modkit_tpu_torch.ops import state
    from modkit_tpu_torch.tools.bench import _clones, _n_copies, _timed_copies
    from modkit_tpu_torch.tools.true_bench import cuda_time_ms

    rng = np.random.default_rng(7)
    n_main = tile.n_events
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
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
            for entry_name, kern, plain, inputs in (
                ("quals_t",
                 lambda: state.threshold_state_quals_t(*gpu, tm, tc),
                 lambda: state.threshold_state_quals_t_plain(*gpu, tm, tc),
                 gpu),
                ("f32",
                 lambda: state.threshold_state_f32(probs_d, gpu[3], tm, tc),
                 lambda: state.threshold_state_f32_plain(
                     probs_d, gpu[3], tm, tc),
                 (probs_d, gpu[3])),
            ):
                check(f"{entry_name}, M={m} N={n}", kern(), plain())
                if n != n_main:
                    continue
                ms, call_ms = cuda_time_ms(kern, 200)
                plain_ms, _ = cuda_time_ms(plain, 10)
                if entry_name == "quals_t":
                    nbytes = n * (m + 3) + n
                    launch = state.threshold_state_quals_t
                else:
                    nbytes = n * (4 * m + 1) + n
                    launch = state.threshold_state_f32
                # L2-cold: each call reads the next of copies that hold
                # four times the L2 together (warm back-to-back launches
                # find the tile's inputs in L2); COLD_CALLS calls in all,
                # so their enqueueing stays inside cuda_time_ms's sleep
                # kernel and the card runs them back to back
                copies = _clones(inputs, _n_copies(nbytes, l2))
                _, cold_ms = _timed_copies(
                    lambda *x: launch(*x, tm, tc), copies,
                    max(2, COLD_CALLS // len(copies)))
                del copies
                # per class: widen, add, scale, select, sum, two compares
                b_ms, b_by = bound(nbytes, 7.0 * m * n)
                log(f"state {entry_name} M={m} N={n}: kernel {ms:.5f} ms "
                    f"(per call {call_ms:.5f} ms), L2-cold {cold_ms:.5f} ms, "
                    f"plain {plain_ms:.5f} ms, {nbytes} bytes, bound "
                    f"{b_ms:.5f} ms ({b_by}), share {b_ms / ms:.3f}, cold "
                    f"{b_ms / cold_ms:.3f}")
                entries[entry_name, m] = dict(
                    ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, n=n, m=m)
    misaligned_views(rng, n_main, dev, check)
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


def reset_launches() -> None:
    """Set every kernel's launch count and the f32 entry's count of aligned
    copies to 0, just before a path runs."""
    from modkit_tpu_torch.ops import counts, lab_counts, state

    state.STATE_KERNEL_LAUNCHES = 0
    state.STATE_F32_KERNEL_LAUNCHES = 0
    state.STATE_F32_COPIES = 0
    counts.COUNT_KERNEL_LAUNCHES = 0
    lab_counts.reset_launches()


def read_copies() -> int:
    """Aligned copies kernel A's f32 entry made of misaligned views since
    reset_launches()."""
    from modkit_tpu_torch.ops import state

    return state.STATE_F32_COPIES


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
    """The main path on the card against the CPU; returns the state
    kernel's launches of the first no-filtering device run.

    Routes: ``cuda`` (the state kernel) and ``cpu`` (the same run on the
    CPU device: the kernels' plain PyTorch versions). Every run must write
    the bytes of the first cuda run. Each mode runs MAIN_ROUNDS rounds of
    the two routes, the order reversed every other round; reads/s are
    reported per run and as the median.
    """
    routes = ("cuda", "cpu")
    launches = None
    for mode, kw in (("no_filtering", dict(no_filtering=True)),
                     ("estimate", dict())):
        first = None
        times = {r: [] for r in routes}
        for rnd in range(MAIN_ROUNDS):
            order = routes if rnd % 2 == 0 else routes[::-1]
            for route in order:
                out = os.path.join(work, f"{mode}.{rnd}.{route}.bed")
                reset_launches()
                t, stats = run_path(bam, out, device=route, **kw)
                n_launch, n_f32, n_count = read_launches()
                require(n_count == 0 and n_f32 == 0,
                        f"{mode}: {route} ran the f32 state or count kernel")
                require(read_copies() == 0,
                        f"{mode}: {route} copied {read_copies()} views")
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
            f"{n_tiles} state launches and no aligned copy per cuda run, "
            f"byte-equal on all "
            f"{MAIN_ROUNDS * len(routes)} runs; reads/s median (runs): "
            + "; ".join(
                f"{r} {BENCH_READS / statistics.median(ts):.0f} ("
                + ", ".join(f"{BENCH_READS / t:.0f}" for t in ts) + ")"
                for r, ts in times.items()))
    log("pinned host memory after the main path's runs (PyTorch's caching "
        "host allocator): " + json.dumps(pinned_stats()))
    return launches


def pinned_stats() -> dict:
    """The block and byte counts of ``torch.cuda.host_memory_stats()``."""
    import torch

    stats = torch.cuda.host_memory_stats()
    return {k: stats[k] for k in (
        "num_host_alloc", "num_host_free", "allocations.current",
        "allocations.peak", "allocated_bytes.current",
        "allocated_bytes.peak", "active_requests.current")
        if k in stats}


def phase_profile(bam: str, work: str) -> None:
    """One more no-filtering device run under MODKIT_TPU_PROFILE (4 tile
    workers, as users run it): from its trace.json the card's busy share
    (union of kernel, memcpy and memset spans over the traced window) and
    its busiest device ops; the program's spans in ms per tile, summed
    over the threads; and the spans under the longest device-idle gaps."""
    trace_dir = os.path.join(work, "profile")
    os.environ["MODKIT_TPU_PROFILE"] = trace_dir
    try:
        run_path(bam, os.path.join(work, "profiled.bed"), device="cuda",
                 no_filtering=True)
    finally:
        del os.environ["MODKIT_TPU_PROFILE"]
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    spans, ours, by_name = [], [], {}
    lo, hi = float("inf"), 0.0
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        lo, hi = min(lo, ev["ts"]), max(hi, ev["ts"] + ev["dur"])
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
            key = ev["name"][:60]
            by_name[key] = by_name.get(key, 0.0) + ev["dur"]
        elif ev.get("cat") == "modkit_tpu_torch":
            ours.append(ev)
    require(bool(spans), "profile: the trace holds no device work")
    tiles = sum(1 for ev in ours if ev["name"] == "tile")
    require(tiles > 0, "profile: the trace holds no tile spans")
    busy, end, gaps = 0.0, lo, []
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    gaps.append((end, hi))
    window = max(hi - lo, 1.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile: traced window {window / 1e6:.3f} s, device busy "
        f"{busy / 1e3:.3f} ms = {busy / window:.5f} of the window, "
        f"{len(spans)} device spans; top (ms): "
        + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in top))
    per_span = {}
    for ev in ours:
        per_span[ev["name"]] = per_span.get(ev["name"], 0.0) + ev["dur"]
    log(f"profile: spans over {tiles} tiles (ms a tile, summed over the "
        "threads): " + ", ".join(
            f"{k} {v / 1e3 / tiles:.3f}"
            for k, v in sorted(per_span.items(), key=lambda kv: -kv[1])))
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:5]:
        mid = (a + b) / 2
        under = sorted({f"{ev['name']}@{ev.get('args', {}).get('tile', '-')}"
                        for ev in ours if ev["name"] != "tile"
                        and ev["ts"] <= mid <= ev["ts"] + ev["dur"]})
        log(f"profile: device idle {(b - a) / 1e3:.3f} ms under "
            + (" ".join(under) or "no span"))


def phase_count_path(work: str) -> int:
    """The Python event route (native decoder off) on the card against the
    native route on the CPU; returns the count kernel's launches."""
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam

    bam = os.path.join(work, "small.bam")
    make_synthetic_modbam(bam, n_reads=2000, read_len=BENCH_READ_LEN,
                          coverage=BENCH_COVERAGE, seed=2)
    cpu_out = os.path.join(work, "small.cpu.bed")
    run_path(bam, cpu_out, device="cpu", filter_threshold={"default": 0.6})
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
    require(filecmp.cmp(dev_out, cpu_out, shallow=False),
            "count path: cuda output differs from the cpu run")
    require(n_launch > 0, "count path: the count kernel never launched")
    log(f"count path: 2000 reads, {n_launch} count launches, "
        f"{t_dev:.3f} s; byte-equal")
    return n_launch


def phase_cram(work: str) -> int:
    """Pileup over a CRAM on the card (the Python event route: kernel B on
    every tile), on the CPU and through the native route of the BAM it was
    written from; returns kernel B's launches in the no-filtering cuda
    run."""
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
              ("cram cpu", cram, dict(device="cpu")),
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
            elif route == "cram cpu":
                require((n_state, n_f32, n_count) == (0, 0, 0),
                        f"cram {mode}: the cpu route launched")
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
    the CPU's bedMethyls; returns kernel A's launches over the two cuda
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

    # 1. pileup of A and B on cuda and on the CPU, indexed
    beds, launches = {}, 0
    for sample, bam in (("a", a_bam), ("b", b_bam)):
        outs, secs = {}, {}
        for route in ("cuda", "cpu"):
            out = os.path.join(work, f"down_{sample}.{route}.bed")
            reset_launches()
            secs[route] = cli(["pileup", bam, out, "--no-filtering",
                               "--suppress-progress", "--device", route])
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
                        f"downstream pileup {sample}: the cpu route "
                        "launched")
        same_files(outs["cuda"], outs["cpu"], f"downstream pileup {sample}")
        t0 = time.perf_counter()
        for route, out in outs.items():
            bgzip_text(out, out + ".gz")
            build_tabix(out + ".gz")
            beds[(sample, route)] = out + ".gz"
        log(f"downstream pileup {sample}: {count_lines(outs['cuda'])} rows, "
            f"{n_tiles} tiles, kernel A launched {n_tiles} times on cuda; "
            f"cuda {secs['cuda']:.2f} s ({CRAM_READS / secs['cuda']:.1f} "
            f"reads/s), cpu {secs['cpu']:.2f} s; byte-equal; bgzip + "
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
    for route in ("cuda", "cpu"):
        dmr_steps, tool_steps = downstream_steps(work, route, beds, roi,
                                                 sizes, fa)
        steps[f"{route}.dmr"], steps[f"{route}.tools"] = dmr_steps, tool_steps
    times = {}
    for key, t in run_steps_side_by_side(work, steps).items():
        times.setdefault(key.split(".")[0], {}).update(t)
    for group in ("dmr", "tools"):
        for (name, _, out_c), (_, _, out_h) in zip(steps[f"cuda.{group}"],
                                                   steps[f"cpu.{group}"]):
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
        log(f"downstream {name}: cuda bedMethyls {t:.2f} s{rate}, cpu "
            f"bedMethyls {times['cpu'][name]:.2f} s (4 processes side by "
            "side); byte-equal")
    log(f"downstream dmr pair sites: {sites} sites scored")

    # 4-5. extract calls and pileup-hemi, each with the default estimate
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
        path = os.path.join(work, f"{out}.txt")
        reset_launches()
        secs = cli([x.format(out=path) for x in argv])
        rows = count_lines(path)
        require(rows > 1, f"{name}: no rows")
        rate = (rows - 1 if unit == "rows" else n_in) / secs
        log(f"downstream {name}: {rows} lines in {secs:.2f} s ({rate:.0f} "
            f"{unit}/s)")
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
    (sorted on the host, as modkit_tpu's), and the motif commands on the
    card's and the CPU's bedMethyls of A; returns the entropy bedgraph."""
    import contextlib
    import re

    ent_out = os.path.join(work, "entropy.bedgraph")
    reset_launches()
    secs = cli(["entropy", "-s", a_bam, "--ref", fa, "--cpg", "-o", ent_out,
                "--force", "--suppress-progress"])
    require(read_launches() == (0, 0, 0), "entropy launched a kernel")
    rows = count_lines(ent_out)
    require(rows > 0, "entropy: no windows")
    log(f"entropy --cpg: {rows} windows in {secs:.2f} s "
        f"({rows / secs:.1f} windows/s)")

    steps = {}
    for route in ("cuda", "cpu"):
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
    for (name, _, out_c), (_, _, out_h) in zip(steps["cuda"], steps["cpu"]):
        same_files(out_c, out_h, name)
        log(f"{name}: cuda bedMethyl {times['cuda'][name]:.2f} s, cpu "
            f"bedMethyl {times['cpu'][name]:.2f} s (2 processes side by "
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
    return ent_out


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
    quals entry at M = 2), with no filtering on ``cuda`` and on ``cpu``,
    byte-equal per mode; then a six-code modBAM on ``cuda`` and on
    ``cpu``, byte-equal. Returns {"f32_m1": launches of the ``--ignore h``
    cuda run, "quals_m8": launches of the six-code cuda run}."""
    from modkit_tpu_torch.collapse import CollapseMethod
    from modkit_tpu_torch.utils.synth_codes import (
        NINE_CODES, make_multicode_modbam,
    )

    routes = ("cuda", "cpu")
    six = os.path.join(work, "six.bam")
    make_multicode_modbam(six, n_reads=SIX_READS, read_len=BENCH_READ_LEN,
                          seed=5, codes=NINE_CODES[:6])
    # mode: (modBAM, pileup options, index in read_launches() of the entry
    # its cuda run launches)
    modes = {
        "ignore h": (bam, dict(collapse=[CollapseMethod("dist", ("h",))]),
                     1),
        "combine-mods": (bam, dict(combine_mods=True), 0),
        "six codes": (six, dict(), 0),
    }
    launches = {}
    for mode, (path, kw, entry) in modes.items():
        outs, secs = {}, {}
        for route in routes:
            outs[route] = os.path.join(
                work, f"{mode.replace(' ', '_')}.{route}.bed")
            reset_launches()
            secs[route], stats = run_path(path, outs[route], device=route,
                                          no_filtering=True, **kw)
            got = read_launches()
            require(stats["rows"] > 0, f"{mode}, {route}: no rows")
            require(read_copies() == 0,
                    f"{mode}, {route}: {read_copies()} aligned copies")
            if route == "cuda":
                n_tiles = tiles_with_rows(outs[route])
                want = [0, 0, 0]
                want[entry] = n_tiles
                require(list(got) == want,
                        f"{mode}: cuda launches {got}, want {want}")
                launches[mode] = got[entry]
            else:
                require(got == (0, 0, 0), f"{mode}: {route} launched {got}")
        require(filecmp.cmp(outs["cuda"], outs["cpu"], shallow=False),
                f"{mode}: the cpu route wrote other bytes")
        n_reads = SIX_READS if path == six else BENCH_READS
        log(f"{mode} ({n_reads} reads): {n_tiles} tiles, {launches[mode]} "
            f"{'f32' if entry else 'quals'} state launches on cuda, "
            "byte-equal on cuda and cpu; reads/s "
            + ", ".join(f"{r} {n_reads / t:.0f}" for r, t in secs.items()))
    return dict(f32_m1=launches["ignore h"], quals_m8=launches["six codes"])


# phase 15: the measuring tools at a cut size, each in its own process (the
# bench's kernel rooflines stay at their full size), with their time limits
TOOLS = {
    "bench": (dict(MODKIT_BENCH_READS="5000",
                   MODKIT_BENCH_ENTROPY_READS="1000",
                   MODKIT_BENCH_REPS="1"), 400),
    "scale_bench": (dict(SCALE_READS="20000"), 300),
    "multichip_model": (dict(MC_READS="5000"), 300),
}
# phase 15: the most the card's route may hold over a pileup's bytes
# already held (RSS after the journal pileup less RSS after the default
# one, over the same tiles), and over the cpu run's peak (the CUDA
# context, a few hundred MB)
REPEAT_PASS_MB = 256
OVER_CPU_RUN_MB = 512
# the TPU-era files the original tools overwrite; the port's never do
TPU_RESULT_FILES = ("BENCH_SCALE_r05.json", "MULTICHIP_MODEL.json")


def phase_cpu_baseline(bam: str, work: str) -> None:
    """Phase 15, step 1: ``cpu_baseline.run_pileup_cpu`` over the bench
    modBAM (its estimate sorting on the host), byte-equal to phase 5's
    first cuda bedMethyl of each mode, no kernel launched."""
    from modkit_tpu_torch.cpu_baseline import run_pileup_cpu

    secs = {}
    for mode, kw in (("no_filtering", {}),
                     ("estimate", dict(no_filtering=False))):
        out = os.path.join(work, f"cpu_baseline.{mode}.bed")
        reset_launches()
        t0 = time.perf_counter()
        run_pileup_cpu(bam, out, **kw)
        secs[mode] = time.perf_counter() - t0
        require(read_launches() == (0, 0, 0),
                f"CPU baseline {mode} launched a kernel")
        same_files(os.path.join(work, f"{mode}.0.cuda.bed"), out,
                   f"CPU baseline {mode}")
    log("CPU baseline (all C++, every core): byte-equal to the cuda route; "
        + ", ".join(f"{mode} {BENCH_READS / t:.0f} reads/s ({t:.2f} s)"
                    for mode, t in secs.items()))


def flags_true(obj, path: str = "") -> list:
    """The paths of every ``*_identical`` or ``*_equal*`` field of a JSON
    object that is not true."""
    bad = []
    if isinstance(obj, dict):
        for key, val in obj.items():
            if (key.endswith("_identical") or "_equal" in key) and \
                    val is not True:
                bad.append(path + key)
            bad += flags_true(val, f"{path}{key}.")
    return bad


def start_tool(name: str, work: str, *args: str):
    """``python -m modkit_tpu_torch.tools.<name> [args]`` with its TOOLS
    knobs, stdout and stderr to files of ``work``; returns (process,
    stdout path, stderr path, limit s)."""
    knobs, limit = TOOLS[name]
    env = dict(os.environ, TMPDIR=work, **knobs)
    tag = "_".join((name, *args)).replace("-", "")
    out, err = (os.path.join(work, f"{tag}.{x}") for x in ("out", "err"))
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"modkit_tpu_torch.tools.{name}", *args],
            cwd=HERE, env=env, stdout=fo, stderr=fe)
    return proc, out, err, limit


def finish_tool(name: str, started) -> dict:
    """Wait for a start_tool process; require exit 0 and parse the JSON
    line it printed last."""
    proc, out, err, limit = started
    try:
        rc = proc.wait(timeout=limit)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(err) as fh:
        tail = fh.read()[-4000:]
    require(rc == 0, f"tools.{name}: exit {rc}:\n{tail}")
    with open(out) as fh:
        lines = fh.read().strip().splitlines()
    require(bool(lines), f"tools.{name}: no output:\n{tail}")
    return json.loads(lines[-1])


def phase_tools(work: str) -> None:
    """Phase 15, step 2: the bench tool at its cut size (every identical
    and equal field true, kernel A launched on its timed runs, the
    rooflines at full size), then the scale and multichip tools side by
    side (exit 0 with their JSON, every multichip output byte-equal); no
    tool writes the repository's TPU-era result files."""
    before = {}
    for name in TPU_RESULT_FILES:
        with open(os.path.join(HERE, name), "rb") as fh:
            before[name] = fh.read()
    t0 = time.perf_counter()
    got = finish_tool("bench", start_tool("bench", work))
    t_bench = time.perf_counter() - t0
    extra = got["extra"]
    require(not flags_true(got), f"bench: not true: {flags_true(got)}")
    require(extra["state_launches"] > 0,
            "bench: kernel A not launched on its timed runs")
    roof = extra["kernel_roofline"]
    require(roof is not None, "bench: no kernel rooflines on the card")
    st, ct = roof["threshold_state"], roof["pileup_count_kernel"]
    log(f"bench tool ({TOOLS['bench'][0]}): {t_bench:.1f} s; pileup "
        f"{got['value']:.1f} reads/s ({extra['state_launches']} kernel A "
        f"launches), link {extra['link_bandwidth_MBps']:.1f} MB/s, CPU "
        "baseline "
        f"{extra['cpu_baseline_reads_per_s']:.1f}; rooflines (events/s "
        f"warm / L2-cold, % of {roof['hbm_read_GBps']:.1f} GB/s): state "
        f"{st['events_per_s']:.4g} / {st['cold_events_per_s']:.4g} "
        f"({st['pct_of_hbm_read_bound']:.1f} / "
        f"{st['cold_pct_of_hbm_read_bound']:.1f}), matmul "
        f"{ct['matmul_events_per_s']:.4g} / "
        f"{ct['matmul_cold_events_per_s']:.4g}, pipeline "
        f"{ct['pipeline_events_per_s']:.4g} / "
        f"{ct['pipeline_cold_events_per_s']:.4g}; over the HBM rate: "
        f"{roof['over_hbm_bound'] or 'none'}")
    t0 = time.perf_counter()
    started = {
        "scale_bench": start_tool("scale_bench", work),
        "scale_bench cpu": start_tool("scale_bench", work, "--device", "cpu"),
        "multichip_model": start_tool("multichip_model", work),
    }
    results = {name: finish_tool(name.split()[0], s)
               for name, s in started.items()}
    mc = results["multichip_model"]
    for name in ("scale_bench", "scale_bench cpu"):
        scale = results[name]
        require(scale["config"]["n_reads"] == int(
            TOOLS["scale_bench"][0]["SCALE_READS"])
            and scale["reads_per_s"] > 0, f"{name}: {scale}")
        log(f"{name} host memory (MB): peak {scale['peak_rss_mb']:.1f}; "
            "RSS after each stage " + json.dumps(scale["rss_mb"])
            + "; peaks of the phases (RSS, the BAM's mapped pages) "
            + json.dumps(scale["phase_peak_mb"])
            + "; pinned " + json.dumps(scale["pinned_host_memory"]))
    scale, host = results["scale_bench"], results["scale_bench cpu"]
    again = scale["rss_mb"]["journal"] - scale["rss_mb"]["default"]
    require(again <= REPEAT_PASS_MB,
            f"scale_bench: the journal pileup left {again:.1f} MB more RSS "
            f"than the default one (at most {REPEAT_PASS_MB})")
    over = scale["peak_rss_mb"] - host["peak_rss_mb"]
    require(over <= OVER_CPU_RUN_MB,
            f"scale_bench: the cuda route's peak RSS is {over:.1f} MB over "
            f"the cpu run's (at most {OVER_CPU_RUN_MB})")
    require(mc["outputs_identical"] is True
            and set(mc["virtual_mesh_wall_s"]) == {"1", "2", "4", "8"},
            f"multichip_model: {mc}")
    for name in TPU_RESULT_FILES:
        with open(os.path.join(HERE, name), "rb") as fh:
            require(fh.read() == before[name], f"a tool wrote {name}")
    log(f"scale (cuda and cpu) and multichip tools side by side: "
        f"{time.perf_counter() - t0:.1f} s; scale {scale['config']} "
        f"{scale['reads_per_s']:.1f} reads/s (cpu "
        f"{host['reads_per_s']:.1f}), journal overhead "
        f"{scale['journal_overhead_pct']:.1f}%, peak RSS "
        f"{scale['peak_rss_mb']:.1f} MB (cpu {host['peak_rss_mb']:.1f}), "
        f"the journal pass {again:.1f} MB over the default one; multichip "
        "feed "
        + json.dumps(mc["host_feed_curve"]) + ", wall s over N devices "
        + json.dumps(mc["virtual_mesh_wall_s"]) + " (" +
        json.dumps(mc["virtual_mesh_devices"]["8"]) + "), byte-equal; "
        f"{', '.join(TPU_RESULT_FILES)} untouched")


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
    entry; Python event route: kernel B), each byte-equal to the same
    route's run on ``cpu``. Returns {row name: kernels entry} at M = NINE,
    with the launches of the 9-code run that drives the row's kernel."""
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
    for route, device, native_off in (
            ("cuda native", "cuda", False),
            ("cuda python", "cuda", True),
            ("cpu", "cpu", False)):
        outs[route] = os.path.join(work, f"nine.{route.replace(' ', '_')}.bed")
        if native_off:
            os.environ["MODKIT_TPU_DISABLE_NATIVE"] = "1"
        reset_launches()
        try:
            t, stats = run_path(bam, outs[route], device=device,
                                no_filtering=True)
        finally:
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
    require(launches["cpu"] == (0, 0, 0),
            f"9 codes, cpu route: launches {launches['cpu']}")
    rows["threshold_state_f32_any_m"]["launches"] = launches["cuda native"][1]
    rows["modcall_counts_any_m"]["launches"] = launches["cuda python"][2]
    for name, row in rows.items():
        row["max_abs_err"] = worst[name]
    log(f"9-code pileup: 2000 reads, rows {stats['rows']}; native route "
        f"{launches['cuda native'][1]} f32 state launches, python route "
        f"{launches['cuda python'][2]} count launches (M = 9); both "
        "byte-equal to the cpu route")
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
        t_phase = time.perf_counter()
        phase_cpu_baseline(bam, work)
        phase_tools(work)
        log(f"CPU baseline and tools phase: "
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
