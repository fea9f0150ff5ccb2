"""bedMethyl consumer utilities: `stats`, `localize`, `bedmethyl merge`.

Reference equivalents: ``src/stats/``, ``src/localise/``,
``src/bedmethyl_util/subcommands.rs`` (merge). All three are tabix-driven
region aggregations; the numeric parts are simple count sums done with
dict accumulation host-side (they are IO-bound, not compute-bound).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..bedmethyl import BedMethylLine
from ..io.tabix import TabixFile
from ..modcodes import format_mod_code, mod_code_sort_key, parse_mod_code
from ..writers import format_float


@dataclass
class GenomeRegion:
    """util.rs:851-909 GenomeRegion + bed parsers."""

    chrom: str
    start: int
    end: int
    strand: str = "."
    name: str | None = None

    def midpoint(self) -> int:
        return (self.start + self.end) // 2


def parse_genome_regions(
    path: str, field_split: str = "\t"
) -> list[GenomeRegion]:
    """BED4 (unstranded) vs BED6 (stranded) chosen by the first
    non-comment line's field count (stats/subcommand.rs:85-97 uses tabs,
    localise/subcommand.rs:123-127 uses any whitespace)."""
    from .dmr import _parse_bed_tokens

    with open(path) as fh:
        lines = [l.rstrip("\n") for l in fh if l.strip()]
    while lines and lines[0].startswith("#"):
        lines.pop(0)
    if not lines:
        raise SystemExit("failed to inspect regions BED, no valid lines")
    if field_split == "\t":
        nf = len(lines[0].split("\t"))
    else:
        nf = len(lines[0].split())
    stranded = nf > 4
    out = []
    for line in lines:
        chrom, start, stop, name, tail = _parse_bed_tokens(line)
        strand = "."
        if stranded:
            toks = tail.split()
            if len(toks) >= 2 and toks[1] in "+-.":
                strand = toks[1]
        out.append(GenomeRegion(chrom, start, stop, strand, name))
    return out


def read_sequence_lengths_file(path: str) -> list[tuple[str, int]]:
    """<chrom>\\t<size> TSV or .fai (first two columns)."""
    out = []
    for line in open(path):
        parts = line.split()
        if len(parts) >= 2:
            out.append((parts[0], int(parts[1])))
    return out


def _strand_overlaps(a: str, b: str) -> bool:
    """StrandRule::overlaps -- '.' (Both) overlaps everything."""
    return a == "." or b == "." or a == b


def _fetch_lines(tbx: TabixFile, chrom: str, start: int, end: int, strand: str):
    out = []
    for raw in tbx.fetch(chrom, start, end):
        try:
            bml = BedMethylLine.parse(raw)
        except ValueError:
            continue
        if _strand_overlaps(bml.strand, strand):
            out.append(bml)
    return out


# ----------------------------------------------------------------- stats ----


def run_stats(args) -> int:
    """`stats` (stats/subcommand.rs:66-200): per-region per-mod-code
    n_mod/n_valid/percent table."""
    import os

    tbx = TabixFile(args.in_bedmethyl, io_threads=args.io_threads)
    regions = parse_genome_regions(args.regions, field_split="\t")
    regions = [r for r in regions if tbx.has_contig(r.chrom)]
    mod_codes = (
        {parse_mod_code(c) for c in args.mod_codes}
        if args.mod_codes
        else None
    )
    observed: set = set()
    stats_rows = []
    for r in regions:
        counts: dict = {}
        for bml in _fetch_lines(tbx, r.chrom, r.start, r.end, r.strand):
            if bml.valid_coverage < args.min_coverage:
                continue
            if mod_codes is not None and bml.raw_mod_code not in mod_codes:
                continue
            n_mod, n_valid = counts.get(bml.raw_mod_code, (0, 0))
            counts[bml.raw_mod_code] = (
                n_mod + bml.count_methylated,
                n_valid + bml.valid_coverage,
            )
        if mod_codes is None:
            observed.update(counts)
        stats_rows.append((r, counts))
    codes = sorted(
        mod_codes if mod_codes is not None else observed,
        key=mod_code_sort_key,
    )
    if os.path.exists(args.out_table) and not args.force:
        raise SystemExit(f"refusing to overwrite {args.out_table}")
    with open(args.out_table, "w") as out:
        if not args.no_header:
            header = ["chrom", "start", "end", "name", "strand"]
            for code in codes:
                c = format_mod_code(code)
                header += [f"count_{c}", f"count_valid_{c}", f"percent_{c}"]
            out.write("\t".join(header) + "\n")
        for r, counts in stats_rows:
            row = [
                r.chrom,
                str(r.start),
                str(r.end),
                r.name if r.name else ".",
                r.strand,
            ]
            for code in codes:
                n_mod, n_valid = counts.get(code, (0, 0))
                if n_valid == 0:
                    pct = np.float32(0.0)
                else:
                    pct = (
                        np.float32(n_mod)
                        / np.float32(n_valid)
                        * np.float32(100.0)
                    )
                row += [str(n_mod), str(n_valid), format_float(pct)]
            out.write("\t".join(row) + "\n")
    return 0


# -------------------------------------------------------------- localize ----


def run_localize(args) -> int:
    """`localize` (localise/): per-offset-from-feature-center aggregate
    modification fraction table."""
    import os

    tbx = TabixFile(args.in_bedmethyl, io_threads=args.io_threads)
    sizes = dict(read_sequence_lengths_file(args.genome_sizes))
    regions = parse_genome_regions(args.regions, field_split=None)
    window = args.window
    focus = []
    for r in regions:
        if r.chrom not in sizes or not tbx.has_contig(r.chrom):
            continue
        mp = r.midpoint()
        start = max(mp - (window + 1), 0)
        end = min(mp + window, sizes[r.chrom])
        focus.append(GenomeRegion(r.chrom, start, end, r.strand, r.name))
    if not focus:
        raise SystemExit("failed to find any valid regions")

    # offsets[code][offset] = [n_mod, n_valid] (localise/util.rs:26-47);
    # per-region counts are an additive monoid, so regions fan out across
    # --threads workers (the reference's rayon par_iter,
    # localise/subcommand.rs:265) with thread-local tabix handles and the
    # partials merge order-independently. NOTE: --batch-size is accepted
    # for flag parity but, exactly like the reference (batch_size_bp is
    # declared at subcommand.rs:101 and never read), it has no effect.
    import threading
    from concurrent.futures import ThreadPoolExecutor

    tls = threading.local()

    def get_tbx():
        t = getattr(tls, "tbx", None)
        if t is None:
            t = tls.tbx = TabixFile(
                args.in_bedmethyl, io_threads=args.io_threads
            )
        return t

    def region_counts(r) -> dict:
        local: dict = {}
        anchor = r.midpoint()
        fetch_strand = args.stranded_features or r.strand
        for bml in _fetch_lines(
            get_tbx(), r.chrom, r.start, r.end, fetch_strand
        ):
            if args.stranded is not None:
                ov = _strand_overlaps(r.strand, bml.strand)
                if args.stranded == "same" and not ov:
                    continue
                if args.stranded == "opposite" and ov:
                    continue
            off = anchor - bml.start
            code_map = local.setdefault(bml.raw_mod_code, {})
            cur = code_map.get(off, (0, 0))
            code_map[off] = (
                cur[0] + bml.count_methylated,
                cur[1] + bml.valid_coverage,
            )
        return local

    offsets: dict = {}
    n_workers = max(1, args.threads)
    if n_workers > 1 and len(focus) > 1:
        with ThreadPoolExecutor(n_workers) as ex:
            partials = list(ex.map(region_counts, focus))
    else:
        tls.tbx = tbx
        partials = [region_counts(r) for r in focus]
    for local in partials:
        for code, code_map in local.items():
            dst = offsets.setdefault(code, {})
            for off, (m, v) in code_map.items():
                cur = dst.get(off, (0, 0))
                dst[off] = (cur[0] + m, cur[1] + v)

    if args.out_file is None:
        out = sys.stdout
        close = False
    else:
        if os.path.exists(args.out_file) and not args.force:
            raise SystemExit(f"refusing to overwrite {args.out_file}")
        out = open(args.out_file, "w")
        close = True
    try:
        out.write("mod_code\toffset\tn_valid\tn_mod\tpercent_modified\n")
        for code in sorted(offsets, key=mod_code_sort_key):
            for off in sorted(offsets[code]):
                n_mod, n_valid = offsets[code][off]
                if n_valid == 0:
                    pct = np.float32(0.0)
                else:
                    pct = (
                        np.float32(n_mod)
                        / np.float32(n_valid)
                        * np.float32(100.0)
                    )
                out.write(
                    f"{format_mod_code(code)}\t{off}\t{n_valid}\t{n_mod}\t"
                    f"{format_float(pct)}\n"
                )
    finally:
        if close:
            out.close()

    if getattr(args, "chart_filepath", None):
        # HTML line chart of percent-modified by offset per mod code
        # (localise/subcommand.rs:291 + util.rs:86 get_plot)
        from ..charts import line_chart_html

        name = args.chart_name or "modification_patterns"
        series = []
        for code in sorted(offsets, key=mod_code_sort_key):
            pts = []
            for off in sorted(offsets[code]):
                n_mod, n_valid = offsets[code][off]
                pct = (
                    float(
                        np.float32(n_mod)
                        / np.float32(n_valid)
                        * np.float32(100.0)
                    )
                    if n_valid
                    else 0.0
                )
                pts.append((float(off), pct))
            series.append((format_mod_code(code), pts))
        with open(args.chart_filepath, "w") as fh:
            fh.write(
                line_chart_html(name, series, "offset", "percent modified")
            )
    return 0


# -------------------------------------------------------------- tobigwig ----


def iter_bedmethyl_values(lines_iter, include_codes, negative_strand_values):
    """bedmethyl_util/mod.rs:17-145 BedMethylStream: stream bedMethyl lines,
    combining multi-code records at the same position+strand (requires
    equal valid coverage; equal canonical counts to sum), preferring the
    higher-coverage strand when both strands share a position, yielding
    (chrom, start, end, percent) values."""
    import numpy as np

    record = None
    for raw in lines_iter:
        raw = raw.rstrip("\n")
        if not raw:
            continue
        nxt = BedMethylLine.parse(raw)
        if nxt.raw_mod_code not in include_codes:
            continue
        if record is None:
            record = nxt
            continue
        if (
            nxt.chrom == record.chrom
            and nxt.start == record.start
            and nxt.stop == record.stop
        ):
            if nxt.strand == record.strand:
                if nxt.raw_mod_code == record.raw_mod_code:
                    raise ValueError(f"duplicated record at {nxt.chrom}:{nxt.start}")
                if nxt.valid_coverage != record.valid_coverage:
                    raise ValueError(
                        f"invalid overlapping records at {nxt.chrom}:"
                        f"{nxt.start}, valid coverage should be the same"
                    )
                if nxt.count_canonical == record.count_canonical:
                    record.count_methylated += nxt.count_methylated
                continue
            # same position, different strand: keep higher coverage
            if nxt.valid_coverage > record.valid_coverage:
                record = nxt
            continue
        fact = (
            -100.0
            if negative_strand_values and record.strand == "-"
            else 100.0
        )
        frac = np.float32(record.count_methylated) / np.float32(
            record.valid_coverage
        )
        yield (
            record.chrom,
            record.start,
            record.stop,
            float(frac * np.float32(fact)),
        )
        record = nxt
    if record is not None:
        fact = (
            -100.0
            if negative_strand_values and record.strand == "-"
            else 100.0
        )
        frac = np.float32(record.count_methylated) / np.float32(
            record.valid_coverage
        )
        yield (
            record.chrom,
            record.start,
            record.stop,
            float(frac * np.float32(fact)),
        )


def run_tobigwig(args) -> int:
    """`bedmethyl tobigwig` (bedmethyl_util/subcommands.rs:458-523)."""
    from ..io.bigwig import BigWigWriter

    include = {parse_mod_code(c) for c in args.mod_codes}
    if not include:
        raise SystemExit("must provide at least one modification code to use")
    sizes = dict(read_sequence_lengths_file(args.chromsizes))
    # --inmemory is trivially honored: this writer always builds the
    # BBI in memory (no temp-file mode exists); --nthreads drives parallel
    # section compression (subcommands.rs:443,488)
    writer = BigWigWriter(
        str(args.out_fp),
        sizes,
        compress=not args.uncompressed,
        block_size=args.block_size,
        items_per_slot=args.items_per_slot,
        nzooms=args.nzooms,
        zooms=args.zooms,
        threads=args.nthreads,
    )
    if args.in_bedmethyl in ("-", "stdin"):
        stream = sys.stdin
    else:
        stream = open(args.in_bedmethyl)
    n = 0
    try:
        for chrom, start, end, value in iter_bedmethyl_values(
            stream, include, args.negative_strand_values
        ):
            writer.add_interval(chrom, start, end, value)
            n += 1
    finally:
        if stream is not sys.stdin:
            stream.close()
    writer.close()
    print(f"finished, wrote {n} records", file=sys.stderr)
    return 0


# ----------------------------------------------------------------- merge ----


def run_merge(args) -> int:
    """`bedmethyl merge` (bedmethyl_util/subcommands.rs:136-370): outer
    join N tabix bedMethyls on (start, mod code, strand), summing all 8
    counters; rows re-sorted position -> strand -> mod code."""
    import os

    readers = []
    for p in args.in_bedmethyl:
        try:
            readers.append(TabixFile(p, io_threads=args.io_threads))
        except (FileNotFoundError, ValueError):
            print(f"failed to open {p}", file=sys.stderr)
    if not readers:
        raise SystemExit("no valid input bedMethyl files")
    sizes = read_sequence_lengths_file(args.genome_sizes)
    tabix_contigs = set()
    for r in readers:
        tabix_contigs.update(r.contigs)

    if args.out_bed in ("stdout", "-"):
        out = sys.stdout
        close = False
    else:
        if os.path.exists(args.out_bed) and not args.force:
            raise SystemExit(f"refusing to overwrite {args.out_bed}")
        os.makedirs(os.path.dirname(args.out_bed) or ".", exist_ok=True)
        out = open(args.out_bed, "w")
        close = True
    try:
        for chrom, length in sizes:
            if chrom not in tabix_contigs:
                continue
            for lo in range(0, length, args.interval_size):
                hi = min(lo + args.interval_size, length)
                merged: dict = {}
                for tbx in readers:
                    if not tbx.has_contig(chrom):
                        continue
                    for raw in tbx.fetch(chrom, lo, hi):
                        line = BedMethylLine.parse(raw)
                        key = (line.start, line.raw_mod_code, line.strand)
                        prev = merged.get(key)
                        if prev is None:
                            merged[key] = line
                        else:
                            prev.count_methylated += line.count_methylated
                            prev.valid_coverage += line.valid_coverage
                            prev.count_canonical += line.count_canonical
                            prev.count_other += line.count_other
                            prev.count_delete += line.count_delete
                            prev.count_fail += line.count_fail
                            prev.count_diff += line.count_diff
                            prev.count_nocall += line.count_nocall
                    # tabix fetch returns records overlapping the window;
                    # only count records starting inside it once
                for key in list(merged):
                    if not (lo <= key[0] < hi):
                        del merged[key]
                strand_order = {"+": 0, "-": 1, ".": 2}
                for key in sorted(
                    merged,
                    key=lambda k: (
                        k[0],
                        strand_order[merged[k].strand],
                        mod_code_sort_key(k[1]),
                    ),
                ):
                    out.write(merged[key].to_line())
    finally:
        if close:
            out.close()
    return 0
