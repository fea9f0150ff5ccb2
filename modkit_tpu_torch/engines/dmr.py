"""Differential methylation (DMR) engines: `dmr pair` / `dmr multi`.

Regions mode (reference ``src/dmr/pairwise.rs`` + ``src/dmr/util.rs``):
for each BED region of interest, fetch the bedMethyl records of both
samples via tabix, keep records whose (position, strand, primary base) is a
comparison-base position in the reference genome, aggregate counts per
sample (replicates combined), and score a vs b with the Bayesian
log-marginal-likelihood ratio (``ops/llk.py``).

Scores for all regions are computed in one vectorized pass after the IO
fan-out instead of per-region scalar math.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

from ..bedmethyl import (
    AggregatedCounts,
    BedMethylLine,
    aggregate_counts,
    default_code_lookup,
)
from ..genome_positions import GenomePositions
from ..io.tabix import TabixFile
from ..modcodes import ModCode, mod_code_sort_key
from ..ops.llk import llk_ratio_beta, llk_ratio_dirichlet
from ..writers import format_float


@dataclass
class DmrInterval:
    """One BED region of interest (dmr/util.rs:42-96)."""

    chrom: str
    start: int
    stop: int
    name: str
    strand: str = "."  # StrandRule; '.' = both


def _parse_bed_tokens(line: str):
    """nom-equivalent tokenizer: chrom/start/stop as whitespace-separated
    tokens, name as rest-of-token-until-tab (spaces allowed)
    (util.rs:864-877 GenomeRegion::parse_bed_line)."""
    rest = line.rstrip("\r\n")
    # chrom: leading run of non-whitespace
    i = 0
    while i < len(rest) and rest[i] not in " \t":
        i += 1
    chrom = rest[:i]
    if not chrom:
        raise ValueError(f"failed to parse bed line: {line!r}")
    rest = rest[i:]

    def consume_digit(s: str) -> tuple[str, int]:
        j = 0
        while j < len(s) and s[j] in " \t":
            j += 1
        if j == 0:
            raise ValueError(f"failed to parse bed line: {line!r}")
        k = j
        while k < len(s) and s[k].isdigit():
            k += 1
        if k == j:
            raise ValueError(f"failed to parse bed line: {line!r}")
        return s[k:], int(s[j:k])

    rest, start = consume_digit(rest)
    rest, stop = consume_digit(rest)
    # optional name: skip whitespace, then take everything up to a tab
    j = 0
    while j < len(rest) and rest[j] in " \t\r\n":
        j += 1
    name_part = rest[j:]
    tab = name_part.find("\t")
    if tab >= 0:
        name, tail = name_part[:tab], name_part[tab:]
    else:
        name, tail = name_part, ""
    name = name if name else None
    return chrom, start, stop, name, tail


def parse_roi_bed(path: str) -> list[DmrInterval]:
    """dmr/util.rs:389-428 -- tab-field count of the first line picks the
    unstranded (<=4 cols) or stranded (>4 cols) parser for the whole file."""
    with open(path) as fh:
        lines = [l for l in (x.rstrip("\n") for x in fh) if l]
    # skip leading comment lines only (skip_while semantics)
    while lines and lines[0].startswith("#"):
        lines.pop(0)
    if not lines:
        raise ValueError("zero non-comment lines in regions")
    stranded = len(lines[0].split("\t")) > 4
    rois = []
    for line in lines:
        chrom, start, stop, name, tail = _parse_bed_tokens(line)
        strand = "."
        if stranded:
            # consume score (float or '.') then strand char (util.rs:892-908)
            toks = tail.split()
            if len(toks) >= 2 and toks[1] in "+-.":
                strand = toks[1]
            elif len(toks) >= 2:
                raise ValueError(f"invalid strand in {line!r}")
        if name is None:
            name = f"{chrom}:{start}-{stop}"
        rois.append(DmrInterval(chrom, start, stop, name, strand))
    if not rois:
        raise ValueError("didn't parse any regions")
    return rois


class SampleIndex:
    """Tabix handlers for N samples + the code->base lookup
    (dmr/tabix.rs:30-165 MultiSampleIndex)."""

    def __init__(
        self,
        paths: list[str],
        code_lookup: dict[ModCode, str],
        min_valid_coverage: int = 0,
        io_threads: int | None = None,
        index_paths: list[str | None] | None = None,
    ):
        # index_paths: explicit .tbi paths per sample (the reference's
        # --index-a/--index-b, advanced_usage.md:2280-2285); None entries
        # fall back to <path>.tbi
        if index_paths is None:
            index_paths = [None] * len(paths)
        if len(index_paths) != len(paths):
            raise SystemExit(
                "number of explicit tabix indices must match the number of "
                "bedMethyl files"
            )
        self.handlers = [
            TabixFile(p, io_threads=io_threads, index_path=ip)
            for p, ip in zip(paths, index_paths)
        ]
        self.code_lookup = code_lookup
        self.min_valid_coverage = min_valid_coverage

    def has_contig(self, sample_id: int, contig: str) -> bool:
        return self.handlers[sample_id].has_contig(contig)

    def all_contigs(self) -> set[str]:
        out: set[str] = set()
        for h in self.handlers:
            out.update(h.contigs)
        return out

    def read_lines(
        self, sample_id: int, chrom: str, start: int, end: int
    ) -> list[BedMethylLine]:
        """tabix.rs:163-189 read_bedmethyl_check_code: fetch + min-coverage
        + known-mod-code filters."""
        out = []
        for raw in self.handlers[sample_id].fetch(chrom, start, end):
            try:
                bml = BedMethylLine.parse(raw)
            except ValueError:
                continue
            if bml.valid_coverage < self.min_valid_coverage:
                continue
            if bml.raw_mod_code not in self.code_lookup:
                continue
            out.append(bml)
        return out


@dataclass
class _RegionResult:
    roi: DmrInterval
    counts_a: AggregatedCounts
    counts_b: AggregatedCounts
    score: float = 0.0


def _aggregate_region(
    roi: DmrInterval,
    positions: set,
    per_sample_lines: dict[int, list[BedMethylLine]],
    code_lookup: dict[ModCode, str],
) -> AggregatedCounts | None:
    """pairwise.rs:14-64 filter + per-sample aggregate + monoid combine.
    Returns None if every sample failed (or none had records)."""
    combined: AggregatedCounts | None = None
    any_records = False
    for _sample, lines in per_sample_lines.items():
        hits = [
            l
            for l in lines
            if l.chrom == roi.chrom
            and l.get_stranded_position(code_lookup) in positions
        ]
        if not hits:
            continue
        any_records = True
        try:
            counts = aggregate_counts(hits, code_lookup)
        except ValueError:
            continue
        combined = counts if combined is None else combined.combine(counts)
    if not any_records:
        return None
    return combined


def score_counts_pairs(
    pairs: list[tuple[AggregatedCounts, AggregatedCounts]],
) -> list[float | None]:
    """llk_ratio (llr_model.rs:314-330) for a batch of (a, b) count pairs,
    vectorized; None where the category structure is invalid (2 categories
    but more than one distinct mod code)."""
    scores: list[float | None] = [None] * len(pairs)
    beta_idx, beta_rows = [], []
    dir_groups: dict[int, list[tuple[int, np.ndarray, np.ndarray]]] = {}
    for i, (ca, cb) in enumerate(pairs):
        codes_a = set(ca.mod_code_counts)
        codes_b = set(cb.mod_code_counts)
        n_categories = max(len(codes_a), len(codes_b)) + 1
        if n_categories < 2:
            scores[i] = 0.0
        elif n_categories == 2:
            union = codes_a | codes_b
            if len(union) != 1:
                continue  # invalid -> None
            code = next(iter(union))
            beta_idx.append(i)
            beta_rows.append(
                (
                    ca.mod_code_counts.get(code, 0),
                    ca.total,
                    cb.mod_code_counts.get(code, 0),
                    cb.total,
                )
            )
        else:
            union = sorted(codes_a | codes_b, key=mod_code_sort_key)
            k = len(union) + 1
            row_a = np.zeros(k)
            row_b = np.zeros(k)
            for j, code in enumerate(union):
                row_a[j + 1] = ca.mod_code_counts.get(code, 0)
                row_b[j + 1] = cb.mod_code_counts.get(code, 0)
            row_a[0] = ca.canonical_counts()
            row_b[0] = cb.canonical_counts()
            dir_groups.setdefault(k, []).append((i, row_a, row_b))
    if beta_idx:
        arr = np.array(beta_rows, dtype=np.float64)
        vals = np.atleast_1d(
            llk_ratio_beta(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3])
        )
        for i, s in zip(beta_idx, vals):
            scores[i] = float(s)
    for _k, group in dir_groups.items():
        a = np.stack([g[1] for g in group])
        b = np.stack([g[2] for g in group])
        vals = np.atleast_1d(llk_ratio_dirichlet(a, b))
        for (i, _, _), s in zip(group, vals):
            scores[i] = float(s)
    return scores


def _score_results(results: list[_RegionResult]) -> None:
    """Vectorized scoring pass over regions; raises for regions whose
    category structure is invalid (2 categories but >1 distinct code)."""
    scores = score_counts_pairs([(r.counts_a, r.counts_b) for r in results])
    for r, s in zip(results, scores):
        if s is None:
            raise ValueError(
                "should have exactly one modification to use beta llk"
            )
        r.score = s


def _result_row(r: _RegionResult) -> str:
    """llr_model.rs:187-224 to_row."""
    return (
        f"{r.roi.chrom}\t{r.roi.start}\t{r.roi.stop}\t{r.roi.name}\t"
        f"{format_float(r.score, f64=True)}\t{r.roi.strand}\t"
        f"{r.counts_a.string_counts()}\t{r.counts_a.total}\t"
        f"{r.counts_b.string_counts()}\t{r.counts_b.total}\t"
        f"{r.counts_a.string_percentages()}\t"
        f"{r.counts_b.string_percentages()}\t"
        f"{format_float(r.counts_a.pct_modified())}\t"
        f"{format_float(r.counts_b.pct_modified())}\n"
    )


def _header_row(a_name: str, b_name: str) -> str:
    cols = [
        "chrom", "start", "end", "name", "score", "strand",
        f"{a_name}_counts", f"{a_name}_total",
        f"{b_name}_counts", f"{b_name}_total",
        f"{a_name}_mod_percentages", f"{b_name}_mod_percentages",
        f"{a_name}_pct_modified", f"{b_name}_pct_modified",
    ]
    return "\t".join(cols) + "\n"


def run_pair_regions(
    sample_index: SampleIndex,
    a_idxs: list[int],
    b_idxs: list[int],
    rois: list[DmrInterval],
    genome_positions: GenomePositions,
    out,
    header: bool = False,
    a_name: str = "a",
    b_name: str = "b",
    handle_missing: str = "warn",
    batch_size: int = 6,
) -> tuple[int, int]:
    """Regions-mode pairwise DMR. Returns (successes, failures)."""
    if header:
        out.write(_header_row(a_name, b_name))

    kept: list[DmrInterval] = []
    for roi in rois:
        a_found = any(sample_index.has_contig(i, roi.chrom) for i in a_idxs)
        b_found = any(sample_index.has_contig(i, roi.chrom) for i in b_idxs)
        if a_found and b_found:
            kept.append(roi)
        elif handle_missing == "fail":
            raise RuntimeError(
                f"chrom {roi.chrom} is missing from bedMethyl index"
            )
    if not kept:
        raise RuntimeError("no valid regions in input")

    successes = failures = 0
    code_lookup = sample_index.code_lookup
    for ofs in range(0, len(kept), batch_size):
        batch = kept[ofs : ofs + batch_size]
        # merged per-chrom fetch range for the batch (dmr/util.rs:251-344)
        chrom_range: dict[str, tuple[int, int]] = {}
        for roi in batch:
            lo, hi = chrom_range.get(roi.chrom, (roi.start, roi.stop))
            chrom_range[roi.chrom] = (min(lo, roi.start), max(hi, roi.stop))
        lines_a = {
            i: [
                l
                for chrom, (lo, hi) in chrom_range.items()
                for l in sample_index.read_lines(i, chrom, lo, hi)
            ]
            for i in a_idxs
        }
        lines_b = {
            i: [
                l
                for chrom, (lo, hi) in chrom_range.items()
                for l in sample_index.read_lines(i, chrom, lo, hi)
            ]
            for i in b_idxs
        }
        results: list[_RegionResult] = []
        for roi in batch:
            positions = genome_positions.get_positions(
                roi.chrom, roi.start, roi.stop, roi.strand
            )
            if not positions:
                failures += 1
                continue
            counts_a = _aggregate_region(roi, positions, lines_a, code_lookup)
            counts_b = _aggregate_region(roi, positions, lines_b, code_lookup)
            if counts_a is None or counts_b is None:
                failures += 1
                continue
            results.append(_RegionResult(roi, counts_a, counts_b))
        # score region-by-region so one invalid region doesn't sink the batch
        ok_results = []
        for r in results:
            try:
                _score_results([r])
                ok_results.append(r)
            except ValueError:
                failures += 1
        for r in ok_results:
            out.write(_result_row(r))
            successes += 1
    return successes, failures


def explicit_index_paths(args) -> list[str | None]:
    """--index-a/--index-b explicit tabix indices, one per -a/-b sample
    (advanced_usage.md:2280-2285)."""
    idx_a = list(getattr(args, "index_a", None) or [])
    idx_b = list(getattr(args, "index_b", None) or [])
    if idx_a and len(idx_a) != len(args.a):
        raise SystemExit("--index-a must be given once per -a sample")
    if idx_b and len(idx_b) != len(args.b):
        raise SystemExit("--index-b must be given once per -b sample")
    return (idx_a or [None] * len(args.a)) + (
        idx_b or [None] * len(args.b)
    )


def run_pair(args) -> int:
    """CLI entry for `dmr pair` (dmr/subcommands.rs:373-548)."""
    if not args.a or not args.b:
        raise SystemExit("need to provide at least 1 'a' sample and 'b' sample")
    if not args.base:
        raise SystemExit("need to specify at least 1 modified base")
    for b in args.base:
        if b not in "ACGT":
            raise SystemExit("modified base needs to be A, C, G, or T.")
    code_lookup = default_code_lookup(args.assign_code)
    if args.regions is None:
        from .dmr_single_site import run_single_site

        return run_single_site(args, code_lookup)
    if len(args.a) > 1 or len(args.b) > 1:
        raise SystemExit(
            "in order to perform multiple comparisons over regions use "
            "modkit dmr multi"
        )
    index_paths = explicit_index_paths(args)
    sample_index = SampleIndex(
        list(args.a) + list(args.b), code_lookup, args.min_valid_coverage,
        io_threads=args.io_threads, index_paths=index_paths,
    )
    genome_positions = GenomePositions(
        list(args.base),
        args.ref,
        mask=args.mask,
        contigs=sample_index.all_contigs(),
    )
    rois = parse_roi_bed(args.regions)
    if args.out_path is None:
        out = sys.stdout
        close = False
    else:
        if os.path.exists(args.out_path) and not args.force:
            raise SystemExit(
                f"refusing to overwrite existing file {args.out_path}"
            )
        os.makedirs(os.path.dirname(args.out_path) or ".", exist_ok=True)
        out = open(args.out_path, "w")
        close = True
    try:
        run_pair_regions(
            sample_index,
            [0],
            [1],
            rois,
            genome_positions,
            out,
            header=args.header,
            handle_missing=args.missing,
            batch_size=args.batch_size
            or max(1, int(args.threads * 1.5)),
        )
    finally:
        if close:
            out.close()
    return 0


def run_multi(args) -> int:
    """CLI entry for `dmr multi` (dmr/subcommands.rs:666-832)."""
    import itertools

    if len(args.sample) % 2 != 0:
        raise SystemExit("--sample takes pairs: <path> <name>")
    pairs = [
        (args.sample[i], args.sample[i + 1])
        for i in range(0, len(args.sample), 2)
    ]
    for b in args.base:
        if b not in "ACGT":
            raise SystemExit("modified base needs to be A, C, G, or T.")
    code_lookup = default_code_lookup(args.assign_code)
    names: dict[str, list[int]] = {}
    paths = []
    for i, (path, name) in enumerate(pairs):
        if not os.path.exists(path):
            print(
                f"bedMethyl for {name} at {path} not found", file=sys.stderr
            )
            continue
        names.setdefault(name, []).append(len(paths))
        paths.append(path)
    sample_index = SampleIndex(
        paths, code_lookup, args.min_valid_coverage,
        io_threads=args.io_threads,
    )
    genome_positions = GenomePositions(
        list(args.base),
        args.ref,
        mask=args.mask,
        contigs=sample_index.all_contigs(),
    )
    rois = parse_roi_bed(args.regions)
    os.makedirs(args.out_dir, exist_ok=True)
    for a_name, b_name in itertools.combinations(sorted(names), 2):
        fname = (
            f"{args.prefix}_{a_name}_{b_name}.bed"
            if args.prefix
            else f"{a_name}_{b_name}.bed"
        )
        fp = os.path.join(args.out_dir, fname)
        if os.path.exists(fp) and not args.force:
            raise SystemExit(f"refusing to overwrite {fp}")
        with open(fp, "w") as out:
            try:
                run_pair_regions(
                    sample_index,
                    names[a_name],
                    names[b_name],
                    rois,
                    genome_positions,
                    out,
                    header=args.header,
                    a_name=a_name,
                    b_name=b_name,
                    handle_missing=args.missing,
                    batch_size=max(1, int(args.threads * 1.5)),
                )
            except RuntimeError as e:
                if args.missing == "fail":
                    raise SystemExit(str(e))
                print(
                    f"pair {a_name} {b_name} failed to process, {e}",
                    file=sys.stderr,
                )
    return 0
