"""Device peaks measured on the card, and the CUDA-event timer the port's
measurements share.

Port of ``tools/true_bench.py``. It reports what one CUDA device really
delivers, to set kernel times beside:

- HBM read GB/s: ``x.sum()`` over a 2 GiB f32 tensor (one read pass);
- HBM copy GB/s: ``y.copy_(x)`` (one read and one write pass);
- bf16 TFLOP/s of a large ``torch.matmul`` (8192 x 8192 x 8192).

These are PyTorch library calls, measured: peaks to compare the kernels'
times with, not kernels of the port. Each is timed with CUDA events around
back-to-back calls (``cuda_time_ms``). The original forced every timing by
fetching a scalar and subtracted the fetch round trip, because its TPU
backend returned from ``block_until_ready`` before the work ran; CUDA
events time the device itself, so that subtraction has no counterpart.

    python -m modkit_tpu_torch.tools.true_bench

Without a CUDA device it raises: a peak is never measured on the CPU.
"""

from __future__ import annotations

import time

import torch


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, call ms) of ``fn()``, each the mean over ``reps`` calls.

    Device: CUDA events around ``reps`` calls queued behind a ~25 ms sleep
    kernel, so the card runs them back to back whatever the host's cost of
    enqueueing (a function that synchronises inside waits for the sleep,
    and its host gaps then count). Call: the host clock around ``reps``
    calls and a final synchronize, the cost a caller pays per call.
    Inputs stay warm in L2 where they fit, as right after an upload.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    device_ms = start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return device_ms, (time.perf_counter() - t0) * 1e3 / reps


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("true_bench measures a CUDA device; none is "
                           "available")
    return torch.device("cuda")


def hbm_read_gbps(gib: float = 2.0, reps: int = 10) -> float:
    """Streaming-read rate: ``x.sum()`` reads x once and writes 4 bytes."""
    x = torch.ones(int(gib * (1 << 30)) // 4, dtype=torch.float32,
                   device=_require_cuda())
    ms, _ = cuda_time_ms(lambda: x.sum(), reps)
    return x.nbytes / (ms * 1e-3) / 1e9


def hbm_copy_gbps(gib: float = 2.0, reps: int = 10) -> float:
    """Read + write rate: ``y.copy_(x)`` moves 2 * x.nbytes."""
    x = torch.ones(int(gib * (1 << 30)) // 4, dtype=torch.float32,
                   device=_require_cuda())
    y = torch.empty_like(x)
    ms, _ = cuda_time_ms(lambda: y.copy_(x), reps)
    return 2 * x.nbytes / (ms * 1e-3) / 1e9


def matmul_bf16_tflops(k: int = 8192, reps: int = 10) -> float:
    """bf16 rate of one ``torch.matmul`` of two k x k matrices."""
    dev = _require_cuda()
    a = torch.ones((k, k), dtype=torch.bfloat16, device=dev)
    b = torch.full((k, k), 0.5, dtype=torch.bfloat16, device=dev)
    ms, _ = cuda_time_ms(lambda: torch.matmul(a, b), reps)
    return 2 * k**3 / (ms * 1e-3) / 1e12


def measure() -> dict:
    """The three peaks of this process's CUDA device."""
    out = dict(hbm_read_gbps=hbm_read_gbps(), hbm_copy_gbps=hbm_copy_gbps(),
               matmul_bf16_tflops=matmul_bf16_tflops())
    torch.cuda.empty_cache()
    return out


def main() -> int:
    peaks = measure()
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"HBM read: {peaks['hbm_read_gbps']:.1f} GB/s")
    print(f"HBM copy (r+w): {peaks['hbm_copy_gbps']:.1f} GB/s")
    print(f"bf16 matmul: {peaks['matmul_bf16_tflops']:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
