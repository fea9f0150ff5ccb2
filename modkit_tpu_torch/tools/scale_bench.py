"""WGS-scale run of modkit_tpu_torch: 30x coverage over a >= 100 Mbp contig
(>= 1000 genome tiles) through the DEFAULT estimate+filter pileup.

Port of ``tools/scale_bench.py``. Usage:

    python -m modkit_tpu_torch.tools.scale_bench [--device cuda|cpu]
        [--out PATH]

``cuda`` is the default; without a CUDA device a run that did not ask for
the CPU raises. ``SCALE_READS`` (600 000) reads of ``SCALE_READ_LEN``
(5 000) bases at ``SCALE_COVERAGE`` (30x), seed 2, are piled up with the
default threshold estimate, then again with a per-tile ``journal``. It
records the wall time, reads/s, positions/s, the journal's overhead, the
process's peak RSS and the synthesis time as one JSON object, written to
``--out`` (stdout by default, as one line); unlike the original it writes
no file of the repository. The work directory lies under ``TMPDIR`` and is
removed at the end.

Where the process holds host memory, beyond the original's keys:
``rss_mb`` is its current RSS (``VmRSS`` of ``/proc/self/status``) after
the imports, after the device's first use (on ``cuda`` the CUDA
context), after loading the kernels of kernel A's and kernel B's routes,
after the synthesis and after each pileup; ``phase_peak_mb`` holds, for
the synthesis and each pileup, the highest ``VmRSS`` (``rss``, sampled
every 10 ms and at the phase's start and end) and the highest resident
size of the process's maps of the BAM (``bam``, summed over
``/proc/self/smaps`` every 0.5 s and at the start and end; ``None`` where
smaps gives no sizes); ``peak_rss_mb`` is the highest ``VmRSS`` sampled,
or ``VmHWM`` where the kernel reports a higher one (``ru_maxrss`` would
carry a parent's peak into a process started from a large one); and
``pinned_host_memory`` is ``torch.cuda.host_memory_stats()`` at the end
on ``cuda`` (the pinned blocks PyTorch's caching host allocator holds,
and its counts of blocks made and returned), ``None`` on the CPU. To
read the two routes side by side, run the tool once with ``--device
cpu`` and once without on one machine: both synthesize the same modBAM,
so their readings differ only by the route.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time


def status_mb(key: str) -> float | None:
    """A ``kB`` field of ``/proc/self/status`` in MB; None where the kernel
    reports no such field."""
    with open("/proc/self/status") as fh:
        for line in fh:
            name, _, val = line.partition(":")
            if name == key:
                return int(val.split()[0]) / 1024
    return None


def mapped_mb(path: str) -> float | None:
    """The resident MB of this process's maps of ``path`` (the ``Rss`` of
    its ``/proc/self/smaps`` entries); None where smaps gives no ``Rss``."""
    suffix = " " + os.path.realpath(path)
    total, inside, sized = 0, False, False
    with open("/proc/self/smaps") as fh:
        for line in fh:
            head = line.split(None, 1)[0] if line.strip() else ""
            if "-" in head and not head.endswith(":"):  # a map's first line
                inside = line.rstrip("\n").endswith(suffix)
            elif head == "Rss:":
                sized = True
                if inside:
                    total += int(line.split()[1])
    return total / 1024 if sized else None


class PhasePeaks:
    """Per phase, the highest ``VmRSS`` (``rss``) and the highest resident
    size of the maps of ``bam`` (``bam``), sampled by a thread every
    ``period`` seconds and every ``bam_every`` periods respectively, and
    both when a phase starts and ends. ``phase(name)`` ends the current
    phase and starts ``name`` (None: none); ``stop()`` ends the thread."""

    def __init__(self, bam: str, period: float = 0.01, bam_every: int = 50):
        self.peaks: dict = {}
        self._bam = bam
        self._name = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._sample, args=(period, bam_every), daemon=True)
        self._thread.start()

    def _record(self, with_bam: bool) -> None:
        if self._name is None:
            return
        peak = self.peaks[self._name]
        peak["rss"] = max(peak["rss"], status_mb("VmRSS"))
        if with_bam and os.path.exists(self._bam):
            got = mapped_mb(self._bam)
            peak["bam"] = None if got is None else max(peak["bam"] or 0, got)

    def _sample(self, period: float, bam_every: int) -> None:
        tick = 0
        while not self._done.wait(period):
            tick += 1
            with self._lock:
                self._record(tick % bam_every == 0)

    def phase(self, name) -> None:
        with self._lock:
            self._record(True)
            self._name = name
            if name is not None:
                self.peaks[name] = {"rss": 0.0, "bam": 0.0}
                self._record(True)

    def stop(self) -> dict:
        self._done.set()
        self._thread.join()
        return self.peaks


def pinned_host_memory() -> dict:
    """``torch.cuda.host_memory_stats()`` without its timing counters."""
    import torch

    return {k: v for k, v in torch.cuda.host_memory_stats().items()
            if not k.startswith(("host_alloc_time", "host_free_time"))}


def run(device: str = "cuda") -> dict:
    import torch

    from ..parallel.devices import resolve_device
    from ..pileup.runner import PileupConfig, run_pileup
    from ..utils.synth import make_synthetic_modbam
    from .bench import card_line

    rss = {}

    def reading(stage: str) -> None:
        rss[stage] = status_mb("VmRSS")

    reading("imports")
    dev = resolve_device(device)
    torch.zeros(1, device=dev).sum().item()
    reading("device")
    if dev.type == "cuda":
        from ..ops.kernels import kernel_lib

        kernel_lib("state")
        kernel_lib("counts")
    reading("kernels")
    n_reads = int(os.environ.get("SCALE_READS", "600000"))
    read_len = int(os.environ.get("SCALE_READ_LEN", "5000"))
    coverage = float(os.environ.get("SCALE_COVERAGE", "30"))

    tmp = tempfile.mkdtemp(prefix="modkit_scale_")
    bam = os.path.join(tmp, "scale.bam")
    peaks = PhasePeaks(bam)
    try:
        t0 = time.perf_counter()
        peaks.phase("synthesis")
        stats = make_synthetic_modbam(
            bam, n_reads=n_reads, read_len=read_len, coverage=coverage,
            seed=2)
        peaks.phase(None)
        gen_s = time.perf_counter() - t0
        reading("synthesis")
        contig_len = stats["contig_len"]
        n_tiles = -(-contig_len // 100_000)
        print(f"[scale] generated {n_reads} reads, contig {contig_len} bp, "
              f"{n_tiles} tiles in {gen_s:.0f}s", file=sys.stderr)

        def pileup(tag, **kw):
            peaks.phase(tag)
            t0 = time.perf_counter()
            res = run_pileup(PileupConfig(
                in_bam=bam, out=os.path.join(tmp, f"{tag}.bed"),
                suppress_progress=True, device=str(dev),
                **kw))
            dt = time.perf_counter() - t0
            peaks.phase(None)
            reading(tag)
            if res["rows"] <= 0:
                raise RuntimeError(f"scale_bench: {tag} wrote no rows")
            print(f"[scale] {tag}: {dt:.1f}s ({res['rows']} rows)",
                  file=sys.stderr)
            return dt

        wall_default = pileup("default")
        wall_journal = pileup(
            "journal", journal=os.path.join(tmp, "journal.jsonl"))
    finally:
        phase_peak_mb = peaks.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    # Linux updates VmHWM lazily (pages dropped by madvise can leave it
    # under a sampled VmRSS); some kernels report none
    peak_rss_mb = max([status_mb("VmHWM") or 0.0, *rss.values()]
                      + [p["rss"] for p in phase_peak_mb.values()])
    return {
        "config": {
            "n_reads": n_reads,
            "read_len": read_len,
            "coverage": coverage,
            "contig_len": contig_len,
            "n_tiles": int(n_tiles),
        },
        "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
        "default_estimate_filter_wall_s": wall_default,
        "reads_per_s": n_reads / wall_default,
        "positions_per_s": contig_len / wall_default,
        "journal_wall_s": wall_journal,
        "journal_overhead_pct":
            100.0 * (wall_journal - wall_default) / wall_default,
        "peak_rss_mb": peak_rss_mb,
        "synth_gen_s": gen_s,
        "rss_mb": rss,
        "phase_peak_mb": phase_peak_mb,
        "pinned_host_memory":
            pinned_host_memory() if dev.type == "cuda" else None,
    }


def write_result(result: dict, out: str | None) -> None:
    """One JSON line on stdout, or ``result`` written to the file ``out``."""
    if out is None:
        print(json.dumps(result), flush=True)
        return
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m modkit_tpu_torch.tools.scale_bench",
        description="WGS-scale default pileup: wall time, journal overhead "
                    "and host memory as JSON.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the run (default: cuda)")
    p.add_argument("--out", default=None,
                   help="file to write the JSON to (default: stdout)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    write_result(run(args.device), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
