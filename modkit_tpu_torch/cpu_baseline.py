"""Pure-CPU reference-architecture pileup engine.

The pinned reference binary cannot be built or fetched in this environment
(Rust toolchain absent, zero network egress — see BASELINE.md), so this
module is the measured CPU baseline the TPU engine is compared against: a
multithreaded tile fan-out (the reference's rayon pool over intervals,
pileup/mod.rs:684-716) with every hot stage in C++ — BAM record decode +
MM/ML parse, threshold calling (mk_threshold_states), count histogramming
(mk_bincount_states) and bedMethyl row formatting (mk_format_rows) — and
ordered row emission (the reference's bounded-channel writer,
pileup/subcommand.rs:680). No JAX/device involvement anywhere.

Output is byte-identical to the production engine's no-focus path
(tests/test_cpu_baseline.py).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import native
from .caller import ThresholdCaller
from .io.bam import BamReader
from .modcodes import mod_code_sort_key


def _assemble_counts(res, modc: np.ndarray, p: int, m: int) -> np.ndarray:
    """Merge mod-call counts with nocall/delete histograms into the full
    [p, 2, 6 + 4*(m+1)] tensor (engine.TileProcessor.assemble_counts)."""
    k = 6 + 4 * (m + 1)
    counts = np.zeros((p, 2, k), dtype=np.int32)
    counts[:, :, 1] = modc[:, :, 0]
    counts[:, :, 6:] = modc[:, :, 1:]
    nc = res.nc_counts
    if nc is not None:
        counts[:, :, 2:6] = nc
    dl = res.del_counts
    if dl is not None:
        counts[:, :, 0] = dl
    return counts


def run_pileup_cpu(
    in_bam: str,
    out: str,
    threads: int | None = None,
    interval_size: int = 100_000,
    no_filtering: bool = True,
    filter_threshold: dict | None = None,
    max_depth: int = 8000,
    decode_threads: int = 1,
) -> dict:
    """CPU-only pileup: bedMethyl equal to run_pileup(no-focus path).

    ``threads`` tiles process concurrently (default = cpu count), each tile
    decoding with ``decode_threads`` internal C++ threads — tile-level
    parallelism mirrors the reference's default work split.
    """
    if not native.available():
        raise RuntimeError("native library unavailable")
    if threads is None:
        threads = os.cpu_count() or 4
    if no_filtering:
        caller = ThresholdCaller.passthrough()
    elif filter_threshold is not None:
        ft = dict(filter_threshold)
        caller = ThresholdCaller(ft, {}, ft.pop("default", 0.0))
    else:
        # default reference behavior: estimate the pass threshold from a
        # 10042-read sample, then filter (pileup/subcommand.rs:615-638);
        # the estimation pipeline is all-CPU (native sampling + host
        # percentile), so the baseline pays the same phase the reference
        # binary would
        from .thresholds import estimate_thresholds

        per_base = estimate_thresholds(BamReader(in_bam))
        caller = ThresholdCaller(per_base, {}, 0.0)

    main_reader = BamReader(in_bam)
    header = main_reader.header
    tiles = [
        (tid, s, min(s + interval_size, ref.length))
        for tid, ref in enumerate(header.refs)
        for s in range(0, ref.length, interval_size)
    ]

    tls = threading.local()

    def process_tile(tile):
        tid, start, end = tile
        reader = getattr(tls, "reader", None)
        if reader is None:
            reader = tls.reader = BamReader(in_bam)
        chunks = reader.fetch_chunks_raw(tid, start, end)
        res = native.decode_tile(
            chunks, tid, start, end, max_depth=max_depth,
            n_threads=decode_threads,
        )
        p = end - start
        if res is None or (res.n_used + res.n_skipped == 0 and res.n_events == 0):
            return b"", 0, 0, 0
        m = res.m
        vocab = res.vocab
        thr_mod, thr_can = caller.threshold_arrays(vocab or ["m"])
        if res.n_events:
            states = res.threshold_states_cpu(
                thr_mod.astype(np.float32), thr_can.astype(np.float32)
            )
            modc = res.bincount_states(states, m)
        else:
            modc = np.zeros((p, 2, 1 + 4 * (m + 1)), dtype=np.int32)
        counts = _assemble_counts(res, modc, p, m)
        order = np.asarray(
            sorted(
                range(len(vocab)), key=lambda i: mod_code_sort_key(vocab[i])
            ),
            dtype=np.int32,
        )
        text, n_rows = native.format_rows(
            counts, res.observed_raw(), vocab, order, start,
            header.tid2name(tid), False, "\t",
        )
        return text, n_rows, res.n_used, res.n_skipped

    n_rows = n_used = n_skipped = 0
    with ThreadPoolExecutor(max_workers=threads) as ex, open(out, "wb") as fh:
        for text, rows, used, skipped in ex.map(process_tile, tiles):
            fh.write(text)
            n_rows += rows
            n_used += used
            n_skipped += skipped
    return dict(rows=n_rows, reads_used=n_used, reads_skipped=n_skipped)
