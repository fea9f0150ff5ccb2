"""Host feed and device-count curves of modkit_tpu_torch's pileup.

Port of ``tools/multichip_model.py``. Usage:

    python -m modkit_tpu_torch.tools.multichip_model [--device cuda|cpu]
        [--out PATH]

``cuda`` is the default; without a CUDA device a run that did not ask for
the CPU raises. Over ``MC_READS`` (20 000) reads of 5 kb at 25x, seed 4:

1. HOST FEED CURVE: ``native.decode_tile_bgzf`` over each 100 kb tile's
   BGZF chunks (tile fetch + native decode, as ``TileProcessor.launch_tile``
   runs them, no counting) at 1 and 2 workers, each with
   ``cores // workers`` decode threads. Pileup is parallel over tiles
   with no exchange between devices, so how many devices one host's feed
   keeps busy sets the scaling.
2. DEVICE-COUNT CURVE: the pileup (no filtering: kernel A on every tile on
   ``cuda``) with ``parallel/devices.compute_devices`` giving
   N in {1, 2, 4, 8} devices; tiles round-robin over them. The original
   made N virtual XLA host devices; here the N entries are the cards
   ``cuda:0 .. cuda:N-1`` where there are that many and ``cuda:0`` again
   where not (one card listed N times: each entry gets its own stream), or
   the CPU N times under ``--device cpu``. Each N takes the best of two
   runs; every output must be byte-equal to N = 1's.

The JSON object (the original's keys, plus the device lists, the card and
``outputs_identical``) goes to ``--out``, stdout by default, as one line;
unlike the original it writes no file of the repository. The work
directory lies under ``TMPDIR`` and is removed at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

DEVICE_COUNTS = (1, 2, 4, 8)


def feed_curve(bam: str, n_reads: int) -> dict:
    """Tile feed rate (BGZF fetch + native decode, no counting) at 1 and 2
    workers; per-worker native threads = cores // workers."""
    from .. import native
    from ..io.bam import BamReader
    from ..pileup.engine import PileupOptions

    length = BamReader(bam).header.refs[0].length
    tiles = [(0, s, min(s + 100_000, length))
             for s in range(0, length, 100_000)]
    cores = os.cpu_count() or 1
    max_depth = PileupOptions().max_depth
    out = {}
    for workers in (1, 2):
        threads = max(1, cores // workers)
        readers = [BamReader(bam) for _ in range(workers)]

        def launch(args):
            w, (tid, s, e) = args
            reader = readers[w]
            chunks = reader.fetch_chunk_voffsets(tid, s, e)
            tile = native.decode_tile_bgzf(reader.bam_raw, chunks, tid, s, e,
                                           max_depth=max_depth,
                                           n_threads=threads)
            native.release_pages(reader.bam_raw, chunks)
            return tile

        jobs = [(i % workers, t) for i, t in enumerate(tiles)]
        t0 = time.perf_counter()
        if workers == 1:
            for job in jobs:
                launch(job)
        else:
            with ThreadPoolExecutor(workers) as pool:
                list(pool.map(launch, jobs))
        dt = time.perf_counter() - t0
        out[workers] = dict(wall_s=dt, reads_per_s=n_reads / dt,
                            decode_threads=threads)
    return out


def device_lists(dev) -> dict:
    """N -> the N devices of the curve: real cards where there are N, else
    ``cuda:0`` (or the CPU) listed again."""
    import torch

    if dev.type == "cpu":
        return {n: [dev] * n for n in DEVICE_COUNTS}
    count = torch.cuda.device_count()
    return {n: [torch.device("cuda", i % count) for i in range(n)]
            for n in DEVICE_COUNTS}


def device_count_curve(bam: str, tmp: str, dev) -> tuple[dict, dict]:
    """({N: best wall s}, {N: device names}) of the pileup over N listed
    devices; raises if any output differs from N = 1's."""
    from ..parallel import devices
    from ..pileup.runner import PileupConfig, run_pileup

    lists = device_lists(dev)
    real = devices.compute_devices
    walls, outs = {}, {}
    try:
        for n, devs in lists.items():
            devices.compute_devices = lambda device, devs=devs: list(devs)
            outs[n] = os.path.join(tmp, f"devices_{n}.bed")
            for _ in range(2):
                t0 = time.perf_counter()
                run_pileup(PileupConfig(
                    in_bam=bam, out=outs[n], no_filtering=True,
                    suppress_progress=True, device=dev.type))
                dt = time.perf_counter() - t0
                walls[n] = min(walls.get(n, dt), dt)
            print(f"[multichip] {n} devices: {walls[n]:.2f}s",
                  file=sys.stderr)
    finally:
        devices.compute_devices = real
    with open(outs[1], "rb") as fh:
        first = fh.read()
    for n, path in outs.items():
        with open(path, "rb") as fh:
            if fh.read() != first:
                raise RuntimeError(
                    f"multichip_model: the pileup over {n} devices wrote "
                    "other bytes than over one")
    return walls, {n: [str(d) for d in devs] for n, devs in lists.items()}


def run(device: str = "cuda") -> dict:
    from ..parallel.devices import resolve_device
    from ..utils.synth import make_synthetic_modbam
    from .bench import card_line

    dev = resolve_device(device)
    n_reads = int(os.environ.get("MC_READS", "20000"))
    tmp = tempfile.mkdtemp(prefix="modkit_multichip_")
    try:
        bam = os.path.join(tmp, "mc_synth.bam")
        make_synthetic_modbam(bam, n_reads=n_reads, read_len=5000,
                              coverage=25.0, seed=4)
        feed = feed_curve(bam, n_reads)
        walls, lists = device_count_curve(bam, tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(
        host_feed_curve=feed,
        virtual_mesh_wall_s=walls,
        virtual_mesh_devices=lists,
        outputs_identical=True,
        device=str(dev),
        card=card_line() if dev.type == "cuda" else None,
        note=("feed = tile fetch+decode only (the per-host serial "
              "resource); devices listed more than once share one card (or "
              "the host), so deltas vs n=1 isolate the dispatch and merge "
              "overhead per added device"),
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m modkit_tpu_torch.tools.multichip_model",
        description="Host feed curve and pileup wall time over 1-8 devices "
                    "as JSON.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the run (default: cuda)")
    p.add_argument("--out", default=None,
                   help="file to write the JSON to (default: stdout)")
    return p


def main(argv=None) -> int:
    from .scale_bench import write_result

    args = build_parser().parse_args(argv)
    write_result(run(args.device), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
