"""Top-level pileup orchestration (reference pileup/subcommand.rs:382 run).

Feeds genome tiles in (tid, start) order through the TileProcessor and
writes bedMethyl rows in order. Threshold estimation (unless --no-filtering
or a fixed --filter-threshold) samples reads and sorts their confidences
on the host (thresholds.py estimate_thresholds).

The port of modkit_tpu/pileup/runner.py. The run's device comes from
``PileupConfig.device`` (default ``"cuda"``); without a CUDA device a run
that did not ask for the CPU raises. CRAM input (``--ref`` names its
FASTA) runs serially on the Python event route, whose count is kernel B on
a CUDA device. A multi-host run (MODKIT_TPU_COORD) joins a gloo process
group and writes its shard of the tiles; rank 0 merges the shards.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from .. import tracing
from ..caller import ThresholdCaller
from ..io.bam import BamReader
from ..writers import (
    BedGraphWriter, BedMethylWriter, PartitioningBedMethylWriter,
    format_float,
)
from .engine import (
    ColumnarRows, FormattedRows, PileupOptions, TileProcessor,
)


@dataclass
class PileupConfig:
    in_bam: str
    out: str  # path, or "-"/"stdout"
    interval_size: int = 100_000
    no_filtering: bool = False
    filter_threshold: dict | None = None  # {"default": f, "A": f, ...}
    mod_thresholds: dict | None = None  # {code: f}
    filter_percentile: float = 0.1
    sample_frac: float | None = None
    num_reads: int | None = 10042
    seed: int | None = None
    include_unmapped: bool = False
    region: str | None = None
    # sampling-only region for threshold estimation; falls back to
    # ``region`` (pileup/subcommand.rs:193 sample_region)
    sample_region: str | None = None
    combine_mods: bool = False
    collapse: list = field(default_factory=list)
    edge_filter: object = None
    force_allow: bool = False
    max_depth: int = 8000
    threads: int = 4  # host launch workers (reference -t default)
    # tiles in flight; default 1.5x threads like the reference
    # (command_utils.rs:279 calculate_chunk_size)
    chunk_size: int | None = None
    mixed_delimiters: bool = False
    with_header: bool = False
    bedgraph: bool = False
    prefix: str | None = None
    # SAM tags partitioning output into per-key files (--partition-tag);
    # when set, `out` is a directory (writers.rs:1005)
    partition_tags: list | None = None
    sampling_interval_size: int = 1_000_000
    suppress_progress: bool = False
    # motif / reference options
    reference_fasta: str | None = None
    motifs: list = field(default_factory=list)  # raw ["CG", "0", ...]
    cpg: bool = False
    combine_strands: bool = False
    preset: str | None = None  # "traditional"
    include_bed: str | None = None  # --include-positions
    with_motif_labels_threshold: int = 2
    # per-tile completion journal: completed tiles are recorded as JSON
    # lines; re-running with the same journal resumes after the last
    # completed tile (this system's answer to the reference's
    # "--region sharding for resumability" guidance,
    # book/src/perf_considerations.md:3-9 / SURVEY Section 5)
    journal: str | None = None
    # the run's device: "cuda" (every local card, round-robin over tiles),
    # "cuda:N", or "cpu" (the kernels' plain PyTorch versions)
    device: str = "cuda"


def parse_region(region: str, header) -> tuple[int, int, int]:
    """'chrom' or 'chrom:start-end' -> (tid, start, end).

    The reference parses start/end as 0-based half-open (util.rs:475
    parse_raw_with_start_and_end takes the numbers verbatim, requiring
    end > start) — NOT the samtools 1-based convention.
    """
    if ":" in region:
        chrom, rng = region.rsplit(":", 1)
        a, b = rng.replace(",", "").split("-")
        start, end = int(a), int(b)
        if end <= start:
            raise ValueError(f"invalid region {region!r}: end <= start")
    else:
        chrom, start, end = region, 0, None
    tid = header.name_to_tid.get(chrom)
    if tid is None:
        raise ValueError(f"contig {chrom} not found in header")
    if end is None:
        end = header.refs[tid].length
    return tid, start, end


def resolve_preset(cfg: PileupConfig) -> PileupConfig:
    """Apply the 'traditional' preset: CpG motif, --combine-strands, and
    ReDistribute-collapse of 5hmC (pileup/subcommand.rs:484-523)."""
    if cfg.preset is None:
        return cfg
    if cfg.preset != "traditional":
        raise ValueError(f"unknown preset {cfg.preset!r}")
    if cfg.motifs:
        raise ValueError("cannot use presets and motifs together")
    from ..collapse import CollapseMethod
    from ..modcodes import HYDROXY_METHYL_CYTOSINE

    cfg.cpg = True
    cfg.combine_strands = True
    cfg.collapse = [
        CollapseMethod("dist", (HYDROXY_METHYL_CYTOSINE,))
    ]
    return cfg


def run_pileup(cfg: PileupConfig) -> dict:
    """Pile up ``cfg.in_bam`` into ``cfg.out``. Under
    ``MODKIT_TPU_PROFILE=<dir>`` a device run also writes
    ``<dir>/trace.json``: the card's activity and the run's spans and
    counters on one clock (``tracing.profiled``)."""
    profile_dir = os.environ.get("MODKIT_TPU_PROFILE")
    if not profile_dir:
        return _run_pileup(cfg)
    from ..logging import get_logger
    from ..parallel.devices import resolve_device

    with tracing.profiled(profile_dir, resolve_device(cfg.device)):
        out = _run_pileup(cfg)
    get_logger().info(
        "wrote the device trace and the run's spans to %s",
        os.path.join(profile_dir, "trace.json"),
    )
    return out


def _run_pileup(cfg: PileupConfig) -> dict:
    from ..logging import ProgressTicker, get_logger
    from ..motifs import (
        parse_motifs, scan_focus_positions, scan_focus_positions_combine,
    )
    from ..position_filter import StrandedPositionFilter

    from ..parallel.devices import (
        maybe_init_distributed, process_info, resolve_device, shard_path,
    )

    log = get_logger()
    device = resolve_device(cfg.device)
    cfg = resolve_preset(cfg)
    from ..io.cram import open_alignment_reader

    reader = open_alignment_reader(cfg.in_bam, cfg.reference_fasta)
    is_cram_input = not isinstance(reader, BamReader)
    header = reader.header

    if cfg.combine_strands and not (cfg.cpg or cfg.motifs):
        raise ValueError(
            "need to specify either --motif or --cpg to combine strands"
        )

    motifs = (
        parse_motifs(cfg.motifs, cfg.cpg) if (cfg.motifs or cfg.cpg) else None
    )
    if motifs is not None:
        if cfg.reference_fasta is None:
            raise ValueError(
                "reference fasta is required for using --motif or --cpg"
            )
        if cfg.combine_strands and any(not m.is_palindrome for m in motifs):
            raise ValueError(
                "cannot combine strands with a motif that is not a palindrome"
            )
    fasta = None
    if motifs is not None:
        from ..io.fasta import FastaReader

        fasta = FastaReader(cfg.reference_fasta)

    position_filter = None
    if cfg.include_bed is not None:
        chrom_to_tid = dict(header.name_to_tid)
        position_filter = StrandedPositionFilter.from_bed_file(
            cfg.include_bed, chrom_to_tid
        )

    caller = resolve_caller(cfg, reader, position_filter)

    if cfg.partition_tags:
        for t in cfg.partition_tags:
            if len(t) != 2:
                raise ValueError(
                    f"partition tag {t!r} is not a 2-character SAM tag"
                )

    opts = PileupOptions(
        combine_mods=cfg.combine_mods,
        collapse=list(cfg.collapse),
        edge_filter=cfg.edge_filter,
        force_allow=cfg.force_allow,
        max_depth=cfg.max_depth,
        combine_strands=cfg.combine_strands,
        partition_tags=list(cfg.partition_tags) if cfg.partition_tags else None,
        device=device,
    )
    proc = TileProcessor(caller, opts)

    motif_labels = [m.label() for m in motifs] if motifs else []
    completed_tiles: dict = {}
    journal_fh = None
    multi_file_out = bool(cfg.bedgraph or cfg.partition_tags)
    resume_sizes: dict = {}
    if cfg.journal is not None:
        import json as _json

        if cfg.out in ("-", "stdout"):
            raise ValueError(
                "--journal requires a file or directory output path"
            )
        if os.path.exists(cfg.journal):
            last_rec = None
            for line in open(cfg.journal):
                if line.strip():
                    rec = _json.loads(line)
                    completed_tiles[(rec["tid"], rec["start"])] = rec
                    last_rec = rec
            if multi_file_out and last_rec is not None:
                # multi-file outputs (bedgraph / partition-tag dirs): the
                # last journal line's {filename: size} map is cumulative
                # over every file written so far. Truncate each to its
                # recorded size; a file present on disk but absent from
                # the record was created mid-tile after the last completed
                # tile — reset it to empty so its rows re-emit.
                sizes = last_rec["out_sizes"]
                resume_sizes.update(sizes)
                known = set(sizes)
                for fname, size in sizes.items():
                    fp = os.path.join(cfg.out, fname)
                    if os.path.exists(fp):
                        with open(fp, "r+") as fh:
                            fh.truncate(size)
                if os.path.isdir(cfg.out):
                    suffix = ".bedgraph" if cfg.bedgraph else ".bed"
                    for fname in os.listdir(cfg.out):
                        if fname.endswith(suffix) and fname not in known:
                            with open(
                                os.path.join(cfg.out, fname), "r+"
                            ) as fh:
                                fh.truncate(0)
        journal_fh = open(cfg.journal, "a")

    # multi-host: after the process group's init each process owns tiles
    # where tile_index % process_count == process_index, writes a
    # genome-ordered shard, and process 0 merges after a cross-host barrier
    # (built-in replacement for the reference's manual --region sharding,
    # book/src/perf_considerations.md:3-9)
    shard_mode = False
    out_path = cfg.out
    maybe_init_distributed()
    pidx, pcount = process_info()
    if pcount > 1:
        if (
            cfg.bedgraph
            or cfg.partition_tags
            or cfg.journal
            or cfg.out in ("-", "stdout")
        ):
            raise ValueError(
                "multi-host pileup requires a plain bedMethyl output "
                "path (no bedgraph/partition/journal)"
            )
        shard_mode = True
        out_path = shard_path(cfg.out, pidx)

    if cfg.bedgraph:
        writer = BedGraphWriter(
            cfg.out, cfg.prefix, partitioned=bool(cfg.partition_tags),
            append=bool(completed_tiles),
        )
    elif cfg.partition_tags:
        writer = PartitioningBedMethylWriter(
            cfg.out, cfg.prefix, cfg.mixed_delimiters,
            append=bool(completed_tiles),
        )
    elif cfg.out in ("-", "stdout"):
        writer = BedMethylWriter(sys.stdout, cfg.mixed_delimiters, cfg.with_header)
    elif completed_tiles:
        # resume: truncate any partially-written tail past the last
        # completed tile's recorded output size, then append
        good_size = max(r["out_size"] for r in completed_tiles.values())
        with open(cfg.out, "r+") as fh:
            fh.truncate(good_size)
        out_fh = open(cfg.out, "a")
        writer = BedMethylWriter(out_fh, cfg.mixed_delimiters, False)
    else:
        # in shard mode only rank 0 writes the header (it lands inside
        # rank 0's first tile block, i.e. at the top of the merged file);
        # ranks >=1 emitting headers would embed them mid-file after merge
        writer = BedMethylWriter(
            out_path,
            cfg.mixed_delimiters,
            cfg.with_header and (not shard_mode or pidx == 0),
        )

    if cfg.region is not None:
        tid, rstart, rend = parse_region(cfg.region, header)
        spans = [(tid, rstart, rend)]
    else:
        spans = [
            (tid, 0, header.refs[tid].length)
            for tid in range(len(header.refs))
        ]
    if position_filter is not None:
        spans = position_filter.optimize_spans(spans)

    # a tile's focus is scanned here, on the main thread, before the tile
    # is submitted: its span and counters carry the index that the tile
    # loop below gives the tile
    scans_focus = motifs is not None or position_filter is not None

    def iter_tiles():
        tile_idx = 0
        for tid, rstart, rend in spans:
            chrom = header.tid2name(tid)
            start = rstart
            while start < rend:
                end = min(start + cfg.interval_size, rend)
                focus = None
                scan_start = time.perf_counter_ns()
                if motifs is not None:
                    if cfg.combine_strands:
                        focus, end = scan_focus_positions_combine(
                            motifs, fasta, chrom, tid, rend, start, end,
                            position_filter,
                        )
                        if end <= start:
                            end = min(start + cfg.interval_size, rend)
                            focus = None
                    else:
                        focus = scan_focus_positions(
                            motifs, fasta, chrom, start, end,
                            position_filter, tid,
                        )
                elif position_filter is not None:
                    from ..motifs import FocusPositions

                    focus = FocusPositions(
                        start,
                        position_filter.rule_array(tid, start, end),
                        {}, {}, {},
                    )
                scan_end = (
                    time.perf_counter_ns() if scans_focus else scan_start
                )
                done = completed_tiles.get((tid, start))
                if done is not None:
                    start = done["end"]
                    continue
                tracing.emit(
                    "span", "focus_scan", tile_idx, scan_start, scan_end, 0
                )
                tracing.count(
                    "focus_positions",
                    0 if focus is None else np.count_nonzero(focus.rule >= 0),
                    tile_idx,
                )
                tracing.count(
                    "tile_extend_bp",
                    max(0, end - start - cfg.interval_size), tile_idx,
                )
                yield tid, chrom, start, end, focus
                tile_idx += 1
                start = end

    n_rows = 0

    def write_partitioned(chrom, results):
        nonlocal n_rows
        for key, res in results:
            if cfg.bedgraph:
                if isinstance(res, ColumnarRows):
                    writer.write_columnar(chrom, res, partition_key=key)
                    n_rows += len(res)
                else:
                    for _pos, rows in res:
                        writer.write_rows(
                            chrom, rows, motif_labels, partition_key=key
                        )
                        n_rows += len(rows)
                continue
            w = writer.for_key(key)
            if isinstance(res, ColumnarRows):
                w.write_columnar(chrom, res)
                n_rows += len(res)
            else:
                for _pos, rows in res:
                    w.write_rows(chrom, rows, motif_labels)
                    n_rows += len(rows)

    def write_journal_record(tid, start, end):
        if journal_fh is None:
            return
        import json as _json

        rec = {"tid": tid, "start": start, "end": end}
        if multi_file_out:
            # files carried over from a resumed run keep their recorded
            # size until re-opened this run
            rec["out_sizes"] = {**resume_sizes, **writer.sizes()}
        else:
            writer.flush()
            rec["out_size"] = writer.tell()
        journal_fh.write(_json.dumps(rec) + "\n")
        journal_fh.flush()

    def finish_and_write(inflight, tile_idx):
        nonlocal n_rows
        chrom, tid, start, end, pend = inflight
        rows_before = n_rows
        if cfg.partition_tags:
            tracing.begin_tile(tile_idx)
            res = proc.finish_tile(pend)
            tracing.end_tile(tracing.FINISH_STAGES)
            with tracing.span("write", tile_idx):
                write_partitioned(chrom, res)
        else:
            if isinstance(pend, (FormattedRows, ColumnarRows, list)):
                res = pend  # already finished on the worker
            elif isinstance(writer, BedMethylWriter):
                res = proc.finish_tile(pend, chrom=chrom, space=writer.space)
            else:
                res = proc.finish_tile(pend)
            with tracing.span("write", tile_idx):
                if isinstance(res, FormattedRows):
                    writer.write_formatted(res)
                    n_rows += len(res)
                elif isinstance(res, ColumnarRows):
                    writer.write_columnar(chrom, res, motif_labels)
                    n_rows += len(res)
                else:
                    for _pos, rows in res:
                        writer.write_rows(chrom, rows, motif_labels)
                        n_rows += len(rows)
            if isinstance(res, FormattedRows):
                tracing.count("out_bytes", len(res.text), tile_idx)
        tracing.count("rows", n_rows - rows_before, tile_idx)
        write_journal_record(tid, start, end)

    ticker = ProgressTicker(
        "processing genome tiles:", suppress=cfg.suppress_progress
    )

    # Pipelined execution (the GPU analog of the reference's rayon fan-out
    # + ordered channel, pileup/subcommand.rs:714-799):
    #   - tile LAUNCHES (BGZF fetch + native decode + async device
    #     dispatch on the worker's own CUDA stream) run on a small host
    #     worker pool, so host decode of upcoming tiles overlaps device
    #     compute and row emission;
    #   - kernels round-robin across local devices
    #     (TileProcessor._next_device);
    #   - FINISHES pop in FIFO launch order on this thread, keeping the
    #     output genome-ordered.
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    n_devices = len(proc.devices)
    # parallel launches need thread-safe tile state: the native decode path
    # qualifies; the Python event path (CRAM input / no native lib) shares
    # a per-contig read cache and stays single-launcher
    from .. import native as _native

    parallel_ok = _native.available() and not is_cram_input
    n_workers = (
        max(1, min(cfg.threads, os.cpu_count() or 1)) if parallel_ok else 1
    )
    # divide cores across concurrent tile launches so the native
    # inflate/decode pools don't oversubscribe the host
    proc.opts.decode_threads = max(1, (os.cpu_count() or 1) // n_workers)
    # tiles in flight: --chunk-size, else 1.5x threads like the reference
    # (command_utils.rs:279 calculate_chunk_size), floored at one per
    # device + one per launch worker
    n_inflight = max(
        cfg.chunk_size if cfg.chunk_size else int(cfg.threads * 1.5),
        n_devices + n_workers,
    )

    # the workers share the run's reader: parallel launches take the
    # native route, which reads only the reader's map of the BAM (each
    # block's pages dropped once read, native.release_pages) and its
    # index; a map per worker would hold the pages it touched (on some
    # kernels the whole BAM) once more. A CRAM's records decode once, then
    # are read-only.
    # workers run the whole tile (launch + finish: decode, device
    # dispatch, count assembly, row FORMATTING) so the main thread only
    # writes ordered output — formatting was serializing on the main
    # thread behind the fast native decode (round-4 profile: ~0.8 s of
    # finish + 0.5 s of file write per 2.2 s run). Partition mode keeps
    # finishing on the main thread (the partition writer fan-out isn't
    # thread-safe).
    finish_in_worker = not cfg.partition_tags
    worker_stages = (
        tracing.WORKER_STAGES if finish_in_worker else tracing.LAUNCH_STAGES
    )

    def launch(tile_idx, tile, submitted):
        """The tile's worker part: (result, the clock at its return)."""
        tracing.emit(
            "span", "queued", tile_idx, submitted, time.perf_counter_ns(), 0
        )
        tracing.begin_tile(tile_idx)
        try:
            tid, chrom, start, end, focus = tile
            if focus is not None and not (focus.rule >= 0).any():
                pend = None
            else:
                pend = proc.launch_tile(reader, tid, start, end, focus)
            if pend is None:
                tracing.count(
                    "format_route", tracing.FORMAT_ROUTES.index("none")
                )
            if finish_in_worker and pend is not None:
                if isinstance(writer, BedMethylWriter):
                    pend = proc.finish_tile(
                        pend, chrom=chrom, space=writer.space
                    )
                else:
                    pend = proc.finish_tile(pend)
        finally:
            tracing.end_tile(worker_stages)
        return pend, time.perf_counter_ns()

    def finish_one(item):
        meta, fut, tile_idx, submitted = item
        chrom, tid, start, end = meta
        waited = time.perf_counter_ns()
        pend, returned = fut.result()
        taken = time.perf_counter_ns()
        tracing.emit("span", "writer_wait", tile_idx, waited, taken, 0)
        tracing.emit("span", "held", tile_idx, returned, taken, 0)
        finish_and_write((chrom, tid, start, end, pend), tile_idx)
        if shard_mode:
            writer.write_tile_sentinel()
        tracing.emit(
            "span", "tile", tile_idx, submitted, time.perf_counter_ns(), 0
        )

    # a tile's chunks start at the first read that overlaps it, so most of
    # its BGZF blocks are the previous tile's too: the workers share one
    # cache of inflated blocks, each inflated once
    if parallel_ok:
        proc.block_cache = _native.BlockCache.create()
    pool = ThreadPoolExecutor(max_workers=n_workers)
    inflight: deque = deque()
    done = False
    try:
        for tile_idx, tile in enumerate(iter_tiles()):
            if pcount > 1 and tile_idx % pcount != pidx:
                continue  # owned by another host
            tid, chrom, start, end, _focus = tile
            submitted = time.perf_counter_ns()
            inflight.append((
                (chrom, tid, start, end),
                pool.submit(launch, tile_idx, tile, submitted),
                tile_idx, submitted,
            ))
            if len(inflight) > n_inflight:
                finish_one(inflight.popleft())
                ticker.update(
                    rows=n_rows, reads=proc.n_used, skipped=proc.n_skipped
                )
        while inflight:
            finish_one(inflight.popleft())
        done = True
    finally:
        # a finished run joins its idle workers, so what their threads hold
        # is freed before it returns; a failed one does not wait for tiles
        # in flight
        pool.shutdown(wait=done, cancel_futures=True)
        # freed here, or, where a failed run left decodes running, with the
        # last of them
        proc.block_cache = None
    ticker.finish(rows=n_rows, reads=proc.n_used, skipped=proc.n_skipped)
    writer.close()
    if journal_fh is not None:
        journal_fh.close()
    if shard_mode:
        # cross-host barrier, then process 0 interleaves the shards back
        # into one genome-ordered bedMethyl
        from ..parallel.devices import merge_shards, sync_processes

        sync_processes("modkit_pileup_shards")
        if pidx == 0:
            merge_shards(cfg.out, pcount)
    log.info(
        "Done, processed %d rows. Processed ~%d reads and skipped ~%d reads.",
        n_rows, proc.n_used, proc.n_skipped,
    )
    return dict(
        rows=n_rows,
        reads_used=proc.n_used,
        reads_skipped=proc.n_skipped,
        errors=dict(proc.errors),
        thresholds={
            "per_base": dict(caller.per_base),
            "per_mod": dict(caller.per_mod),
            "default": caller.default_threshold,
        },
    )


def resolve_caller(
    cfg: PileupConfig, reader: BamReader, position_filter=None
) -> ThresholdCaller:
    from ..logging import get_logger

    log = get_logger()
    if cfg.no_filtering:
        log.info("not performing filtering")
        return ThresholdCaller.passthrough()
    per_mod = dict(cfg.mod_thresholds or {})
    for code, thresh in per_mod.items():
        log.info(
            "parsed user-input threshold %s for mod-code %s", thresh, code
        )
    if cfg.filter_threshold is not None:
        ft = dict(cfg.filter_threshold)
        default = ft.pop("default", 0.0)
        for base, t in ft.items():
            log.info("using threshold %s for base %s", t, base)
        return ThresholdCaller(ft, per_mod, default)
    # estimate via sampling + percentile (command_utils.rs:74
    # get_threshold_from_options)
    from ..thresholds import estimate_thresholds

    if cfg.sample_frac is not None:
        log.info("sampling %s%% of reads", cfg.sample_frac * 100)
    elif cfg.num_reads:
        log.info("attempting to sample %d reads", cfg.num_reads)
    with tracing.span("estimate", -1):
        per_base = estimate_thresholds(
            reader,
            num_reads=cfg.num_reads,
            sample_frac=cfg.sample_frac,
            seed=cfg.seed,
            include_unmapped=cfg.include_unmapped,
            filter_percentile=cfg.filter_percentile,
            region=cfg.sample_region or cfg.region,
            collapse=cfg.collapse,
            edge_filter=cfg.edge_filter,
            force_allow=cfg.force_allow,
            interval_size=cfg.sampling_interval_size,
            position_filter=position_filter,
        )
    for base, t in per_base.items():
        log.info(
            "estimated pass threshold %s for primary sequence base %s",
            format_float(t), base,
        )
    return ThresholdCaller(per_base, per_mod, 0.0)
