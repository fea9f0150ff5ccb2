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

On this card the count is bound by bytes: each event reads 12 + 4M bytes
and the [P, 2, Km] tensor is written once. The TPU kernel sorted events by
position and counted them as one-hot int8 matmuls because the TPU has no
scatter; Hopper has integer atomics, so the kernel is one thread per event
that computes the call (the shared ``call.cuh`` function of kernel A) and
``atomicAdd``s one into its counter. M in {1, 2, 4, 8} is unrolled; any
other M up to ``state.MAX_CLASSES`` runs a runtime-M kernel. Integer
atomics make the result exact in any order, so no sort and no host
planning are needed.

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
    n, m = probs.shape
    km = 1 + 4 * (m + 1)
    p_cols = [probs[:, j] for j in range(m)]
    state = call_states_plain(
        p_cols, [p >= 0 for p in p_cols], base, thr_mod, thr_can
    ).to(torch.int64)
    b = base.to(torch.int64)
    counter = torch.where(state == 0, 0, 1 + b * (m + 1) + (state - 1))
    flat = (rpos.to(torch.int64) * 2 + strand.to(torch.int64)) * km + counter
    counts = torch.bincount(flat, minlength=num_positions * 2 * km)
    return counts.to(torch.int32).reshape(num_positions, 2, km)


def modcall_counts(rpos, strand, base, probs, thr_mod, thr_can,
                   num_positions: int):
    """int32 [num_positions, 2, Km] counts of the events ``rpos``/``strand``/
    ``base`` (int32 [N]) with f32 ``probs`` [N, M] (−1 = absent class)."""
    if probs.device.type == "cpu":
        return modcall_counts_plain(
            rpos, strand, base, probs, thr_mod, thr_can, num_positions
        )
    n, m = probs.shape
    dev = validate_cuda_launch(
        "modcall_counts",
        {"rpos": (rpos, torch.int32), "strand": (strand, torch.int32),
         "base": (base, torch.int32), "probs": (probs, torch.float32)},
        m, thr_mod, thr_can,
    )
    if rpos.shape != (n,) or strand.shape != (n,) or base.shape != (n,):
        raise ValueError("modcall_counts: event arrays must be [N]")
    km = 1 + 4 * (m + 1)
    counts = torch.zeros(
        (num_positions, 2, km), dtype=torch.int32, device=dev
    )
    if n == 0 or num_positions == 0:
        return counts
    from .kernels import check_launch, kernel_lib

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
