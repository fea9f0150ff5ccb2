"""Per-event threshold-call state (kernel A, ``csrc/state.cu``).

Replaces the Pallas kernel ``modkit_tpu/ops/pallas_state.py``
``threshold_state_pallas`` and the XLA state functions of
``modkit_tpu/ops/pileup_counts.py`` (``threshold_states``,
``threshold_state_from_quals``, ``threshold_state_f32``). The state of an
event is 0 = filtered, 1 = canonical, 2 + j = mod class j, with the call
semantics of MultipleThresholdModCaller::call kept bit-identical (see
``csrc/call.cuh``).

On this card the call is bound by bytes: per event it reads M + 3 bytes
(class-major u8 quality planes plus present/zero bitmasks and the base) or
4M + 1 (f32 probabilities plus the base) and writes one byte, with a dozen
f32 operations per class. The kernels read each input once and take the
thresholds as a by-value argument, so they move the least bytes the call
needs. The quals entry (the pileup's main path) takes M in
``QUALS_CLASSES`` (its present/zero masks are one byte), the class loop
unrolled in registers. For M in ``QUALS_GROUPED_CLASSES`` each thread
takes ``QUALS_GROUP`` consecutive events in 4-byte loads and one 4-byte
store, over one wave of blocks; a plane that is not 4-byte aligned
(N % 4 != 0) takes two loads and a funnel shift, and the last N % 4
events run one per thread. At M = 8 one thread takes one event: no other
body beat it there on the H100 (``tools/call_bench.py``, ``PERF.md``).
The f32 entry unrolls ``F32_CLASSES``: one event per thread with its row
in 16-byte loads (8-byte at M = 2), ``F32_GROUP`` events per thread at
M = 1, over one wave; any other M up to ``MAX_CLASSES`` (the state 2 + j
is one byte) runs a runtime-M kernel, a loop over the classes.

Each wrapper runs the plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; anything else raises. The
thresholds travel by value, so the kernel takes them as CPU tensors. The
quals entry refuses an input whose base pointer is not ``QUALS_GROUP``-byte
aligned. The f32 entry takes any view: at M in ``F32_CLASSES`` the rows
kernel reads ``probs`` in ``F32_ALIGN``-byte loads, and at M = 1 ``base`` in
``F32_GROUP``-byte loads, so the wrapper gives a view at another offset an
aligned copy (a new allocation) and counts it in ``STATE_F32_COPIES``.
``engine._upload`` gives every array a 16-byte-aligned slot, so the
engine's route copies nothing.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# launches of the CUDA state kernels in this process: the quals entry's
# and the f32 entry's
STATE_KERNEL_LAUNCHES = 0
STATE_F32_KERNEL_LAUNCHES = 0
# aligned copies the f32 entry made of misaligned views in this process
STATE_F32_COPIES = 0
_count_lock = threading.Lock()

# class counts of the quals entry; the f32 and count entries take any M up
# to MAX_CLASSES (their C entries unroll these counts and loop for others)
QUALS_CLASSES = (1, 2, 4, 8)
MAX_CLASSES = 253
# csrc/state.cu's quals entry: the class counts of its grouped kernel,
# that kernel's events per thread (kGroup, one 4-byte load of each input)
# and threads per block (kQualsThreads)
QUALS_GROUPED_CLASSES = (1, 2, 4)
QUALS_GROUP = 4
QUALS_THREADS = 128
# csrc/state.cu's f32 entry: the class counts of its rows kernel, that
# kernel's events per thread at M = 1 (kF32Group), threads per block
# (kF32Threads) and the alignment of its 16-byte row loads
F32_CLASSES = (1, 2, 4, 8)
F32_GROUP = 4
F32_THREADS = 256
F32_ALIGN = 16


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t``, or a copy of it at a new (aligned) allocation when its base
    pointer is not ``align``-byte aligned; counts the copy."""
    global STATE_F32_COPIES
    if t.data_ptr() % align == 0:
        return t
    with _count_lock:
        STATE_F32_COPIES += 1
    return t.clone()


def _count_launch(f32: bool) -> None:
    global STATE_KERNEL_LAUNCHES, STATE_F32_KERNEL_LAUNCHES
    with _count_lock:
        if f32:
            STATE_F32_KERNEL_LAUNCHES += 1
        else:
            STATE_KERNEL_LAUNCHES += 1


def thresholds_to_tensors(thr_mod, thr_can, m_pad: int, device="cpu"):
    """(thr_mod f32 [m_pad, 4], thr_can f32 [4]) on ``device`` from the
    numpy arrays of ``ThresholdCaller.threshold_arrays``; rows past the
    vocabulary are zero, as modkit_tpu's engine pads them."""
    thr_mod = np.asarray(thr_mod, dtype=np.float32)
    m = thr_mod.shape[0]
    if m > m_pad:
        raise ValueError(f"{m} threshold rows do not fit m_pad={m_pad}")
    tm = np.pad(thr_mod, ((0, m_pad - m), (0, 0))).astype(np.float32)
    tc = np.asarray(thr_can, dtype=np.float32).reshape(4)
    return (
        torch.from_numpy(np.ascontiguousarray(tm)).to(device),
        torch.from_numpy(np.ascontiguousarray(tc)).to(device),
    )


# ---- plain PyTorch versions ----

def call_states_plain(p_cols, present_cols, base, thr_mod, thr_can):
    """The call over per-class columns: ``p_cols[j]`` f32 [N] and
    ``present_cols[j]`` bool [N]. A sequential class loop of elementwise
    ops that mirrors pallas_state.py _state_kernel step by step, so every
    f32 rounding matches. Returns u8 [N]."""
    dev = base.device
    n = base.shape[0]
    tm = thr_mod.to(device=dev, dtype=torch.float32)
    tc = thr_can.to(device=dev, dtype=torch.float32)
    b = base.to(torch.int64)
    # base 1..3 select their threshold column, anything else the first
    b = torch.where((b >= 1) & (b <= 3), b, 0)
    prob_sum = torch.zeros(n, dtype=torch.float32, device=dev)
    best_p = torch.full((n,), -torch.inf, dtype=torch.float32, device=dev)
    best_j = torch.zeros(n, dtype=torch.int32, device=dev)
    any_mod = torch.zeros(n, dtype=torch.bool, device=dev)
    for j, (pj, present_j) in enumerate(zip(p_cols, present_cols)):
        prob_sum = prob_sum + torch.where(present_j, pj, 0.0)
        pass_j = present_j & (pj >= tm[j][b])
        mp = torch.where(pass_j, pj, -torch.inf)
        take = mp >= best_p  # the later class wins a tie
        best_p = torch.where(take, mp, best_p)
        best_j = torch.where(take, j, best_j)
        any_mod = any_mod | pass_j
    canon_p = 1.0 - prob_sum
    choose_can = (canon_p >= tc[b]) & ((~any_mod) | (canon_p >= best_p))
    state = torch.where(
        choose_can, 1, torch.where(any_mod, 2 + best_j, 0)
    )
    return state.to(torch.uint8)


def threshold_state_quals_t_plain(quals_t, present, zero, base, thr_mod,
                                  thr_can):
    """Plain version of threshold_state_quals_t: p = (q + 0.5) * 2^-8, or
    0.0 where the zero bit is set."""
    pres = present.to(torch.int32)
    zer = zero.to(torch.int32)
    p_cols, present_cols = [], []
    for j in range(quals_t.shape[0]):
        p = (quals_t[j].to(torch.float32) + 0.5) * 0.00390625
        p_cols.append(torch.where(((zer >> j) & 1) == 1, 0.0, p))
        present_cols.append(((pres >> j) & 1) == 1)
    return call_states_plain(p_cols, present_cols, base, thr_mod, thr_can)


def threshold_state_f32_plain(probs, base, thr_mod, thr_can):
    """Plain version of threshold_state_f32 (−1 marks an absent class)."""
    p_cols = [probs[:, j] for j in range(probs.shape[1])]
    return call_states_plain(
        p_cols, [p >= 0 for p in p_cols], base, thr_mod, thr_can
    )


# ---- wrappers ----

def validate_cuda_launch(what: str, named: dict, m: int, thr_mod, thr_can):
    """Class count, device, dtype, shape and contiguity checks of a CUDA
    launch; returns the device."""
    if not 1 <= m <= MAX_CLASSES:
        raise ValueError(
            f"{what}: the CUDA kernel takes 1 <= M <= {MAX_CLASSES}, got {m}"
        )
    dev = None
    for name, (t, dtype) in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{what}: inputs span {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for name, t, shape in (("thr_mod", thr_mod, (m, 4)),
                           ("thr_can", thr_can, (4,))):
        if t.device.type != "cpu":
            raise ValueError(
                f"{what}: {name} travels by value and must be a CPU tensor"
            )
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: {name} must be float32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    return dev


def threshold_state_quals_t(quals_t, present, zero, base, thr_mod, thr_can):
    """u8 [N] states from class-major u8 planes ``quals_t`` [M, N] and the
    u8 [N] ``present``/``zero`` bitmasks and ``base`` (ACGT = 0..3)."""
    if quals_t.device.type == "cpu":
        return threshold_state_quals_t_plain(
            quals_t, present, zero, base, thr_mod, thr_can
        )
    m, n = quals_t.shape
    if m not in QUALS_CLASSES:
        raise ValueError(
            "threshold_state_quals_t: the CUDA kernel takes M in "
            f"{QUALS_CLASSES}, got {m}"
        )
    dev = validate_cuda_launch(
        "threshold_state_quals_t",
        {"quals_t": (quals_t, torch.uint8), "present": (present, torch.uint8),
         "zero": (zero, torch.uint8), "base": (base, torch.uint8)},
        m, thr_mod, thr_can,
    )
    if present.shape != (n,) or zero.shape != (n,) or base.shape != (n,):
        raise ValueError("threshold_state_quals_t: event arrays must be [N]")
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    from .kernels import check_aligned, check_launch, kernel_lib

    check_aligned("threshold_state_quals_t", {
        "quals_t": quals_t, "present": present, "zero": zero, "base": base},
        align=QUALS_GROUP)

    lib = kernel_lib("state")
    tm = thr_mod.contiguous()
    tc = thr_can.contiguous()
    with torch.cuda.device(dev):
        rc = lib.mk_state_quals_t(
            quals_t.data_ptr(), present.data_ptr(), zero.data_ptr(),
            base.data_ptr(), n, m, tm.data_ptr(), tc.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "threshold_state_quals_t")
    _count_launch(f32=False)
    return out


def threshold_state_f32(probs, base, thr_mod, thr_can):
    """u8 [N] states from events-major f32 ``probs`` [N, M] (−1 = absent)
    and u8 [N] ``base``, contiguous views at any offset (on CUDA one the
    rows kernel cannot load is copied first, see ``_aligned``)."""
    if probs.device.type == "cpu":
        return threshold_state_f32_plain(probs, base, thr_mod, thr_can)
    n, m = probs.shape
    dev = validate_cuda_launch(
        "threshold_state_f32",
        {"probs": (probs, torch.float32), "base": (base, torch.uint8)},
        m, thr_mod, thr_can,
    )
    if base.shape != (n,):
        raise ValueError("threshold_state_f32: base must be [N]")
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    from .kernels import check_launch, kernel_lib

    # the rows kernel's 16-byte row loads, and at M = 1 its 4-byte loads of
    # F32_GROUP bases
    if m in F32_CLASSES:
        probs = _aligned(probs, F32_ALIGN)
    if m == 1:
        base = _aligned(base, F32_GROUP)
    lib = kernel_lib("state")
    tm = thr_mod.contiguous()
    tc = thr_can.contiguous()
    with torch.cuda.device(dev):
        rc = lib.mk_state_f32(
            probs.data_ptr(), base.data_ptr(), n, m, tm.data_ptr(),
            tc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(lib, rc, "threshold_state_f32")
    _count_launch(f32=True)
    return out
