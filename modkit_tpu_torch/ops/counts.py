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

Also here: ``pileup_count_kernel`` and ``run_pileup_counts``, the port of
the XLA-jitted functions of the same names in
``modkit_tpu/ops/pileup_counts.py``: the call and count of all three event
types (modcall, nocall, delete) into the full ``K = 6 + 4 * (M + 1)``
layout. Their call is kernel A's f32 entry (``state.threshold_state_f32``,
the port of the XLA ``threshold_states`` they call), which launches its
CUDA kernel on a CUDA tensor; their count, an XLA scatter-add with no
Pallas kernel under it, is a ``torch.bincount`` on the inputs' device.
``pileup_count_kernel`` is the per-device body of the sharded pileup
(``parallel/sharded_pileup.py``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .state import (
    F32_ALIGN, call_states_plain, threshold_state_f32, validate_cuda_launch,
)

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


_POS_BUCKETS = (32, 256, 2048, 16_384, 100_000, 1_000_000)


def round_up_positions(n: int) -> int:
    for b in _POS_BUCKETS:
        if n <= b:
            return b
    return ((n + _POS_BUCKETS[-1] - 1) // _POS_BUCKETS[-1]) * _POS_BUCKETS[-1]


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
    ``torch.bincount`` of the flat counter indices that lie in the output
    (the kernel drops the others)."""
    km = 1 + 4 * (probs.shape[1] + 1)
    size = num_positions * 2 * km
    flat = flat_indices(rpos, strand, base, probs, thr_mod, thr_can)
    counts = torch.bincount(flat[(flat >= 0) & (flat < size)], minlength=size)
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


# ---- the full count layout: modcall, nocall and delete events ----

def pileup_count_kernel(rpos, strand, base_idx, ev_type, probs, valid,
                        thr_mod, thr_can, *, num_positions: int,
                        num_codes: int):
    """Fused threshold call + count of one tile into int32
    [num_positions, 2, K], K = 6 + 4 * (num_codes + 1) (``counts_layout``),
    on the inputs' device.

    ``rpos``, ``strand``, ``base_idx``, ``ev_type`` (0 modcall, 1 nocall,
    2 delete) are integer [N], ``probs`` contiguous f32 [N, M] (−1 =
    absent class; on CUDA a view at an offset that is not 16-byte aligned
    is copied first), ``valid`` bool [N]; ``thr_mod`` f32 [M, 4] and
    ``thr_can`` f32 [4] are CPU tensors (kernel A takes them by value).
    The call is ``threshold_state_f32``: kernel A's f32 entry on a CUDA
    device, its plain version on the CPU. A modcall event counts at its
    call's counter (filtered, canonical or mod j of its base), a nocall at
    ``2 + base``, a delete at 0, all at the flat index
    ``(rpos * 2 + strand) * K + counter``.

    Out-of-range indices follow the JAX reference's ``.at[flat].add``: the
    index is computed in int32 (so it wraps as XLA's does), a negative one
    counts at ``flat + P * 2 * K`` when that lies in the output (JAX's
    negative indexing), and anything still outside ``[0, P * 2 * K)`` is
    dropped. So an event at rpos −1 lands in the last position's row,
    and one at rpos P or beyond is dropped."""
    m = num_codes
    k = 6 + 4 * (m + 1)
    size = num_positions * 2 * k
    b = base_idx.to(torch.int64)
    # the kernel's u8 base: 1..3 pick their threshold column, any other
    # value the first, as in the reference's call
    base_u8 = torch.where((b >= 1) & (b <= 3), b, 0).to(torch.uint8)
    if probs.device.type == "cuda" and probs.data_ptr() % F32_ALIGN:
        # kernel A's f32 entry reads rows in 16-byte loads and refuses a
        # view at another offset: such a caller's rows get an aligned copy
        # here (a new allocation is 16-byte aligned)
        probs = probs.clone()
    state = threshold_state_f32(probs, base_u8, thr_mod, thr_can).to(
        torch.int64)
    mod_counter = torch.where(state == 0, 1, 6 + b * (m + 1) + (state - 1))
    ev = ev_type.to(torch.int64)
    counter = torch.where(ev == 0, mod_counter,
                          torch.where(ev == 1, 2 + b, 0))
    flat = (rpos.to(torch.int64) * 2 + strand.to(torch.int64)) * k + counter
    flat = (flat + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 arithmetic
    flat = torch.where(flat < 0, flat + size, flat)
    keep = valid.to(torch.bool) & (flat >= 0) & (flat < size)
    counts = torch.bincount(flat[keep], minlength=size)
    return counts.to(torch.int32).reshape(num_positions, 2, k)


def run_pileup_counts(
    rpos: np.ndarray,
    strand: np.ndarray,
    base_idx: np.ndarray,
    ev_type: np.ndarray,
    probs: np.ndarray,
    thr_mod: np.ndarray,
    thr_can: np.ndarray,
    num_positions: int,
    device="cuda",
) -> np.ndarray:
    """Host wrapper of ``pileup_count_kernel`` on ``device`` (``"cuda"`` by
    default; ``"cpu"`` asks for the CPU): numpy counts
    [num_positions, 2, K(m_pad)], m_pad = round_up_codes(m). As in the JAX
    reference, the codes pad to m_pad (absent classes, zero thresholds)
    and the positions to ``round_up_positions``, so out-of-range events
    land where its padded call puts them. The events go to ``device``; the
    thresholds stay on the host, as kernel A takes them."""
    from ..parallel.devices import resolve_device

    dev = resolve_device(device)
    n, m = probs.shape
    m_pad = round_up_codes(max(m, 1))
    k = 6 + 4 * (m_pad + 1)
    if n == 0:
        return np.zeros((num_positions, 2, k), dtype=np.int32)
    p_pad = round_up_positions(num_positions)
    probs_p = np.pad(probs, ((0, 0), (0, m_pad - m)), constant_values=-1.0)
    thr_mod_p = np.pad(thr_mod[:m], ((0, m_pad - m), (0, 0)))

    def host(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))

    def t(a, dtype):
        return host(a, dtype).to(dev)

    out = pileup_count_kernel(
        t(rpos, np.int32), t(strand, np.int32), t(base_idx, np.int32),
        t(ev_type, np.int32), t(probs_p, np.float32),
        torch.ones(n, dtype=torch.bool, device=dev),
        host(thr_mod_p, np.float32), host(thr_can, np.float32),
        num_positions=p_pad, num_codes=m_pad,
    )
    return out[:num_positions].cpu().numpy()
