"""Device selection and the adaptive offload policy for the port's engines.

Single host: genome tiles dispatch round-robin across the local CUDA
devices (the tiles axis of SURVEY §2.5 — the reference's rayon interval
fan-out, pileup/mod.rs:684, mapped onto cards instead of threads). The run's
device is chosen once at the entry point (``resolve_device``) and passed
down; nothing here holds a current device.

Multi-host: ``maybe_init_distributed`` joins a gloo ``torch.distributed``
process group from MODKIT_TPU_COORD/NPROC/PROC_ID; each process then owns
tiles (or window batches, regions, byte ranges) round-robin, writes a
shard with tile sentinels (``shard_path``), and after ``sync_processes``
rank 0 interleaves the shards back (``merge_shards``).
"""

from __future__ import annotations

import os
import threading

import torch


def resolve_device(device) -> torch.device:
    """The run's device from the caller's choice (``"cuda"``, ``"cuda:N"``,
    ``"cpu"`` or a ``torch.device``). A CUDA choice without a CUDA device
    raises: the port never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def compute_devices(device) -> list[torch.device]:
    """Local devices used for round-robin tile dispatch: every CUDA device
    for ``"cuda"`` (``MODKIT_TPU_DEVICES=N`` caps the count), the named one
    for ``"cuda:N"``, and ``[cpu]`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    if dev.index is not None:
        return [dev]
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    cap = os.environ.get("MODKIT_TPU_DEVICES")
    if cap:
        devs = devs[: max(1, int(cap))]
    return devs


_bw_cache: dict = {}
_bw_lock = threading.Lock()


def link_bandwidth_bytes_per_s(device) -> float:
    """Measured host->device bandwidth of ``device`` (one 4 MiB copy from
    pinned memory timed with CUDA events, cached per device). A CPU device
    has no link: infinite.

    Drives the adaptive offload policy: the state call moves ~m_pad+3 B per
    event up and 1 B back, so the offload pays only when the link moves
    bytes faster than the host's C++ path consumes events.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return float("inf")
    key = str(dev)
    with _bw_lock:
        if key not in _bw_cache:
            buf = torch.zeros(1 << 22, dtype=torch.uint8, pin_memory=True)
            with torch.cuda.device(dev):
                buf[: 1 << 14].to(dev, non_blocking=True)  # warm the path
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                buf.to(dev, non_blocking=True)
                stop.record()
                stop.synchronize()
            dt = start.elapsed_time(stop) / 1e3
            _bw_cache[key] = float(buf.numel()) / max(dt, 1e-9)
        return _bw_cache[key]


# fallback host throughput guess (events/s) when the native library (and
# hence the measured probe) is unavailable; override with
# MODKIT_TPU_HOST_EVENT_RATE
_HOST_EVENT_RATE_FALLBACK = 30e6
_host_rate_cache: float | None = None
_policy_logged = False


def host_event_rate() -> float:
    """Host threshold+count throughput (events/s), self-calibrated: one
    ~1 Mevent synthetic probe through the exact native hot loops
    (mk_bench_event_rate), cached for the process. Env override
    MODKIT_TPU_HOST_EVENT_RATE wins; falls back to a conservative guess
    when the native library is unavailable."""
    global _host_rate_cache
    override = os.environ.get("MODKIT_TPU_HOST_EVENT_RATE")
    if override:
        return float(override)
    if _host_rate_cache is None:
        from .. import native

        measured = native.bench_event_rate()
        _host_rate_cache = (
            measured if measured else _HOST_EVENT_RATE_FALLBACK
        )
    return _host_rate_cache


def offload_events_to_device(
    n_events: int, bytes_per_event: float, device
) -> bool:
    """Adaptive offload policy for transfer-bound event batches.

    MODKIT_TPU_OFFLOAD=always|never|auto (default auto): in auto mode the
    device wins when its transfer time beats 2x the host counting time
    (the 2x credits the host cores the offload frees for BAM decode).
    """
    global _policy_logged
    mode = os.environ.get("MODKIT_TPU_OFFLOAD", "auto")
    if mode == "always":
        return True
    if mode == "never":
        return False
    host_rate = host_event_rate()
    bw = link_bandwidth_bytes_per_s(device)
    t_dev = n_events * (bytes_per_event + 1.0) / bw
    t_host = n_events / host_rate
    offload = t_dev < 2.0 * t_host
    if not _policy_logged:
        _policy_logged = True
        from ..logging import get_logger

        get_logger().info(
            "offload policy: link %.1f MB/s, host %.1f Mevent/s -> "
            "counting on %s",
            bw / 1e6, host_rate / 1e6,
            "device" if offload else "host",
        )
    return offload


def maybe_init_distributed() -> bool:
    """Join the run's ``torch.distributed`` process group from
    MODKIT_TPU_COORD (``host:port`` of rank 0's store) / MODKIT_TPU_NPROC /
    MODKIT_TPU_PROC_ID; no-op and False when MODKIT_TPU_COORD is unset.

    The group is gloo on any device: only a barrier crosses processes
    (``sync_processes``), no tensor collective, and gloo lets several
    processes share one card, where NCCL refuses two ranks on one GPU.
    MODKIT_TPU_INIT_TIMEOUT (seconds) bounds the rendezvous only; the
    barrier keeps the default timeout, so a rank that finishes its shard
    early waits for the others. A repeat call is tolerated, but any other
    init failure (bad coordinator, port clash, rank mismatch) is FATAL —
    silently degrading to single-process would produce a partial-genome
    shard named like the final output."""
    coord = os.environ.get("MODKIT_TPU_COORD")
    if not coord:
        return False
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return True
    try:
        host, port = coord.rsplit(":", 1)
        world_size = int(os.environ["MODKIT_TPU_NPROC"])
        rank = int(os.environ["MODKIT_TPU_PROC_ID"])
        timeout = os.environ.get("MODKIT_TPU_INIT_TIMEOUT")
        kwargs = {}
        if timeout:
            kwargs["timeout"] = datetime.timedelta(seconds=int(timeout))
        store = dist.TCPStore(host, int(port), world_size,
                              is_master=rank == 0, **kwargs)
        dist.init_process_group("gloo", store=store, world_size=world_size,
                                rank=rank)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed init failed (coordinator={coord}): {e}"
        ) from e
    return True


def process_info() -> tuple[int, int]:
    """(process_index, process_count): (0, 1) for a single-process run (no
    MODKIT_TPU_COORD); the rank and world size of the initialized
    ``torch.distributed`` process group otherwise."""
    if not os.environ.get("MODKIT_TPU_COORD"):
        return 0, 1
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "MODKIT_TPU_COORD is set but no torch.distributed process group "
            "is initialized"
        )
    return dist.get_rank(), dist.get_world_size()


def sync_processes(tag: str) -> None:
    """Barrier across the run's processes (the counterpart of
    ``multihost_utils.sync_global_devices``); ``tag`` names the sync point
    in the error. Raises when no process group is initialized."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            f"sync_processes({tag!r}): no torch.distributed process group "
            "is initialized"
        )
    dist.barrier()


def shard_path(out: str, process_index: int) -> str:
    return f"{out}.shard{process_index:04d}"


_TILE_SENTINEL = b"\x00TILE\x00"


def _iter_tile_blocks(path: str, chunk_size: int = 1 << 20):
    """Yield every tile block of a shard file in order, INCLUDING empty
    blocks (a tile that emitted zero rows still wrote its sentinel, and the
    round-robin zip in merge_shards relies on block index k == k-th owned
    tile). Streams the file in chunks so WGS-scale shards never load whole
    into memory."""
    buf = bytearray()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(chunk_size)
            if not chunk:
                break
            buf += chunk
            while True:
                i = buf.find(_TILE_SENTINEL)
                if i < 0:
                    break
                yield bytes(buf[:i])
                del buf[: i + len(_TILE_SENTINEL)]
    # anything after the final sentinel is unterminated trailing data
    # (shouldn't occur — every tile ends with a sentinel); emit it rather
    # than drop rows silently
    if buf:
        yield bytes(buf)


def merge_shards(out: str, n_processes: int, remove: bool = True) -> None:
    """Interleave per-process shards back into one genome-ordered ``out``.

    In multi-host mode tiles are assigned round-robin (global tile k goes
    to process k % P) and each process writes its tiles in order, ending
    every tile block — including empty ones — with a sentinel. Re-merging
    is therefore a round-robin zip of whole tile blocks, no sort needed.
    Empty blocks are consumed (to keep the zip aligned) but write nothing.
    """
    iters = [
        _iter_tile_blocks(shard_path(out, i)) for i in range(n_processes)
    ]
    _done = object()
    with open(out, "wb") as o:
        exhausted = [False] * n_processes
        while not all(exhausted):
            for i, it in enumerate(iters):
                block = next(it, _done)
                if block is _done:
                    exhausted[i] = True
                elif block:
                    o.write(block)
    if remove:
        for i in range(n_processes):
            os.remove(shard_path(out, i))
