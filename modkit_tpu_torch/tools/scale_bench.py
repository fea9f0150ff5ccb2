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
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time


def run(device: str = "cuda") -> dict:
    from ..parallel.devices import resolve_device
    from ..pileup.runner import PileupConfig, run_pileup
    from ..utils.synth import make_synthetic_modbam
    from .bench import card_line

    dev = resolve_device(device)
    n_reads = int(os.environ.get("SCALE_READS", "600000"))
    read_len = int(os.environ.get("SCALE_READ_LEN", "5000"))
    coverage = float(os.environ.get("SCALE_COVERAGE", "30"))

    tmp = tempfile.mkdtemp(prefix="modkit_scale_")
    try:
        bam = os.path.join(tmp, "scale.bam")
        t0 = time.perf_counter()
        stats = make_synthetic_modbam(
            bam, n_reads=n_reads, read_len=read_len, coverage=coverage,
            seed=2)
        gen_s = time.perf_counter() - t0
        contig_len = stats["contig_len"]
        n_tiles = -(-contig_len // 100_000)
        print(f"[scale] generated {n_reads} reads, contig {contig_len} bp, "
              f"{n_tiles} tiles in {gen_s:.0f}s", file=sys.stderr)

        def pileup(tag, **kw):
            t0 = time.perf_counter()
            res = run_pileup(PileupConfig(
                in_bam=bam, out=os.path.join(tmp, f"{tag}.bed"),
                use_device=True, suppress_progress=True, device=str(dev),
                **kw))
            dt = time.perf_counter() - t0
            if res["rows"] <= 0:
                raise RuntimeError(f"scale_bench: {tag} wrote no rows")
            print(f"[scale] {tag}: {dt:.1f}s ({res['rows']} rows)",
                  file=sys.stderr)
            return dt

        wall_default = pileup("default")
        wall_journal = pileup(
            "journal", journal=os.path.join(tmp, "journal.jsonl"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
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
                    "and peak RSS as JSON.")
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
