"""Fused threshold call + per-position count (kernel B, ``csrc/counts.cu``).

Replaces the Pallas kernel ``modkit_tpu/ops/pallas_counts.py``
``modcall_counts_pallas`` (with ``_count_call``/``_count_kernel`` and the
host planner ``prepare_events``) and ``dispatch_modcall_counts`` of
``modkit_tpu/ops/pileup_counts.py``: the count path of the Python event
route, taken when the native tile decoder is off.

Output per (position, strand): ``Km = 1 + 4 * (M + 1)`` int32 counters,

    0                  n_filtered
    1 + b*(M+1) + 0    n_canonical for base b
    1 + b*(M+1) + 1+j  n_mod for base b, mod code j

An event counts at the flat index ``(rpos * 2 + strand) * Km + counter``
of the [P, 2, Km] tensor; one outside [0, P * 2 * Km) is dropped.

On this card the count is bound by bytes: each event reads 12 + 4M bytes
and the [P, 2, Km] tensor is written once. The TPU kernel sorted events by
position on the host and counted them as one-hot int8 matmuls because the
TPU has no scatter; Hopper has integer atomics, and the events arrive read
by read, so the kernel is a scatter histogram: each event's call (the
shared ``call.cuh`` function of kernel A, unrolled for M in {1, 2, 4, 8},
a loop for any other M up to ``state.MAX_CLASSES``), then one
``atomicAdd`` into its counter, exact in any order. The kernel writes
every cell itself: a zero pass stores the output's zeros while the count
pass, launched behind it as a programmatic dependent launch, loads its
events and computes their calls, so the wrapper allocates with
``torch.empty`` and zeroes nothing.

The wrapper runs the plain PyTorch version (the same call, then
``torch.bincount``) for tensors on the CPU and launches the kernel for
tensors on a CUDA device; anything else raises.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .state import call_states_plain, validate_cuda_launch

# launches of the CUDA count kernel in this process
COUNT_KERNEL_LAUNCHES = 0
_count_lock = threading.Lock()


def _count_launch() -> None:
    global COUNT_KERNEL_LAUNCHES
    with _count_lock:
        COUNT_KERNEL_LAUNCHES += 1


def round_up_codes(m: int) -> int:
    for b in (1, 2, 4, 8):
        if m <= b:
            return b
    return m


def counts_layout(num_codes: int) -> dict:
    """Index helpers for the counter axis of the full count tensor
    ``K = 6 + 4 * (M + 1)`` (deletes, filtered, nocall per base, then the
    per-base canonical/mod body)."""
    m = num_codes
    return dict(
        K=6 + 4 * (m + 1),
        DELETE=0,
        FILTERED=1,
        NOCALL=lambda b: 2 + b,
        CANONICAL=lambda b: 6 + b * (m + 1),
        MOD=lambda b, j: 6 + b * (m + 1) + 1 + j,
    )


def modcall_counts_plain(rpos, strand, base, probs, thr_mod, thr_can,
                         num_positions: int):
    """Plain version of modcall_counts: the call over the f32 rows, then a
    ``torch.bincount`` of the flat counter index."""
    km = 1 + 4 * (probs.shape[1] + 1)
    flat = flat_indices(rpos, strand, base, probs, thr_mod, thr_can)
    counts = torch.bincount(flat, minlength=num_positions * 2 * km)
    return counts.to(torch.int32).reshape(num_positions, 2, km)


def flat_indices(rpos, strand, base, probs, thr_mod, thr_can):
    """int64 [N] flat counter index of each event: the call, then
    ``(rpos * 2 + strand) * Km + counter``."""
    m = probs.shape[1]
    km = 1 + 4 * (m + 1)
    p_cols = [probs[:, j] for j in range(m)]
    state = call_states_plain(
        p_cols, [p >= 0 for p in p_cols], base, thr_mod, thr_can
    ).to(torch.int64)
    b = base.to(torch.int64)
    counter = torch.where(state == 0, 0, 1 + b * (m + 1) + (state - 1))
    return (rpos.to(torch.int64) * 2 + strand.to(torch.int64)) * km + counter


def _check_out(out, shape, dev):
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=dev)
    if (out.dtype != torch.int32 or tuple(out.shape) != shape
            or out.device != dev or not out.is_contiguous()):
        raise ValueError(
            f"modcall_counts: out must be a contiguous int32 {shape} tensor "
            f"on {dev}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def modcall_counts(rpos, strand, base, probs, thr_mod, thr_can,
                   num_positions: int, out=None):
    """int32 [num_positions, 2, Km] counts of the events ``rpos``/``strand``/
    ``base`` (int32 [N]) with f32 ``probs`` [N, M] (−1 = absent class).
    With ``out`` (a contiguous int32 tensor of that shape on the inputs'
    device) the counts are written there, every cell, and ``out`` is
    returned."""
    n, m = probs.shape
    shape = (num_positions, 2, 1 + 4 * (m + 1))
    if probs.device.type == "cpu":
        got = modcall_counts_plain(
            rpos, strand, base, probs, thr_mod, thr_can, num_positions
        )
        if out is None:
            return got
        return _check_out(out, shape, probs.device).copy_(got)
    dev = validate_cuda_launch(
        "modcall_counts",
        {"rpos": (rpos, torch.int32), "strand": (strand, torch.int32),
         "base": (base, torch.int32), "probs": (probs, torch.float32)},
        m, thr_mod, thr_can,
    )
    if rpos.shape != (n,) or strand.shape != (n,) or base.shape != (n,):
        raise ValueError("modcall_counts: event arrays must be [N]")
    counts = _check_out(out, shape, dev)
    if num_positions == 0:
        return counts
    from .kernels import check_aligned, check_launch, kernel_lib

    check_aligned("modcall_counts", {"out": counts})
    lib = kernel_lib("counts")
    tm = thr_mod.contiguous()
    tc = thr_can.contiguous()
    with torch.cuda.device(dev):
        rc = lib.mk_modcall_counts(
            rpos.data_ptr(), strand.data_ptr(), base.data_ptr(),
            probs.data_ptr(), n, m, num_positions, tm.data_ptr(),
            tc.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "modcall_counts")
    _count_launch()
    return counts


def modcall_counts_numpy(
    rpos, strand, base_idx, probs, thr_mod, thr_can, p, m
) -> np.ndarray:
    """Pure-numpy oracle of the count (tests / host fallback)."""
    km = 1 + 4 * (m + 1)
    if len(rpos) == 0:
        return np.zeros((p, 2, km), dtype=np.int32)
    present = probs >= 0
    thr_e = thr_mod.T[base_idx]
    pass_mod = present & (probs >= thr_e)
    canon_p = np.float32(1.0) - np.where(present, probs, 0).sum(
        axis=1, dtype=np.float32
    )
    pass_can = canon_p >= thr_can[base_idx]
    mod_p = np.where(pass_mod, probs, -np.inf)
    rev_arg = (m - 1) - np.argmax(mod_p[:, ::-1], axis=1)
    best_p = np.take_along_axis(mod_p, rev_arg[:, None], axis=1)[:, 0]
    any_mod = pass_mod.any(axis=1)
    choose_can = pass_can & ((~any_mod) | (canon_p >= best_p))
    state = np.where(choose_can, 1, np.where(any_mod, 2 + rev_arg, 0))
    counter = np.where(state == 0, 0, 1 + base_idx * (m + 1) + (state - 1))
    flat = (rpos.astype(np.int64) * 2 + strand) * km + counter
    counts = np.bincount(flat, minlength=p * 2 * km).astype(np.int32)
    return counts.reshape(p, 2, km)
