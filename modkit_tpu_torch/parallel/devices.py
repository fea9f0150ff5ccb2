"""Device selection and the parallel paths of the port's engines.

The device rule: the run's device does every tile's call and count, on
``cuda`` through the kernels and on ``cpu`` through their plain PyTorch
versions; no setting moves that work elsewhere.

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
