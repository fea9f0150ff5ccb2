"""Output writers: bedMethyl, bedGraph, TSV.

Byte-compatible with the reference formats (writers.rs:43-183 BedMethylWriter,
:264 BedGraphWriter). Column layout (18 columns):

chrom start end name score strand thickStart thickEnd color
valid_cov percent_mod n_mod n_canonical n_other_mod n_delete n_fail n_diff n_nocall

The first 9 separators are always tabs; the rest are tabs by default or
spaces with --mixed-delim (writers.rs:94-101). percent_modified is formatted
``{:.2}`` of the f32 ``fraction * 100`` — both Rust and Python round the
exact binary value half-to-even, so formatting the f32 promotion matches.
"""

from __future__ import annotations

import os

import numpy as np

HEADER_FIELDS = (
    "chrom", "chromStart", "chromEnd", "name", "score", "strand",
    "thickStart", "thickEnd", "color", "valid_coverage", "percent_modified",
    "count_modified", "count_canonical", "count_other_mod", "count_delete",
    "count_fail", "count_diff", "count_nocall",
)


import functools
from decimal import ROUND_HALF_UP, Decimal


@functools.lru_cache(maxsize=1 << 16)
def _format_float_cached(v: float, f64: bool) -> str:
    # Rust Display prints the SHORTEST decimal that round-trips; on exact
    # decimal ties it rounds the last digit up (ryu semantics), unlike
    # numpy's dragon4 which rounds to even (e.g. f32 0.251953125 prints as
    # "0.25195313" in Rust).
    if v == 0.0:
        return "0"
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "inf"
    if v == float("-inf"):
        return "-inf"
    exact = Decimal(v)
    adj = exact.adjusted()
    for digits in range(1, 18):
        quant = Decimal(1).scaleb(adj - digits + 1)
        cand = exact.quantize(quant, rounding=ROUND_HALF_UP)
        back = float(cand)
        ok = (
            back == v if f64 else np.float32(back) == np.float32(v)
        )
        if ok:
            s = format(cand.normalize(), "f")
            return s
    return repr(v)


def format_float(x, f64: bool = False) -> str:
    """Shortest round-trip decimal, matching Rust's f32/f64 Display."""
    v = float(x) if f64 else float(np.float32(x))
    return _format_float_cached(v, f64)


def render_clean_table(rows: list[list[str]]) -> str:
    """prettytable FORMAT_CLEAN rendering: no borders, 1-space padding,
    left-aligned columns (used for summary / sample-probs tables)."""
    if not rows:
        return ""
    ncol = max(len(r) for r in rows)
    widths = [
        max(len(r[i]) if i < len(r) else 0 for r in rows) for i in range(ncol)
    ]
    out = []
    for r in rows:
        cells = [
            f" {r[i] if i < len(r) else '':<{widths[i]}} " for i in range(ncol)
        ]
        out.append("".join(cells))
    return "\n".join(out)


@functools.lru_cache(maxsize=1 << 16)
def format_percent(fraction: float) -> str:
    """{:.2} of f32 fraction*100 (writers.rs:140)."""
    v = np.float32(fraction) * np.float32(100.0)
    return format(float(v), ".2f")


class BedMethylWriter:
    def __init__(self, out, mixed_delimiters: bool = False,
                 with_header: bool = False, append: bool = False):
        if isinstance(out, (str, os.PathLike)):
            self._fh = open(out, "a" if append else "w")
            self._owns = True
        else:
            self._fh = out
            self._owns = False
        self.space = " " if mixed_delimiters else "\t"
        self.rows_written = 0
        if with_header and not append:
            self._fh.write("\t".join(HEADER_FIELDS) + "\n")

    def flush(self):
        self._fh.flush()

    def tell(self) -> int:
        return self._fh.tell()

    def write_rows(self, chrom: str, rows, motif_labels=()):
        tab, sp = "\t", self.space
        raw_code_only = len(motif_labels) < 2
        buf = []
        for r in rows:
            if raw_code_only or r.motif_idx is None:
                name = str(r.mod_code)
            else:
                try:
                    name = f"{r.mod_code},{motif_labels[r.motif_idx]}"
                except IndexError:
                    name = str(r.mod_code)
            buf.append(
                f"{chrom}{tab}{r.pos}{tab}{r.pos + 1}{tab}{name}{tab}"
                f"{r.valid_coverage}{tab}{r.strand}{tab}{r.pos}{tab}"
                f"{r.pos + 1}{tab}255,0,0{tab}"
                f"{r.valid_coverage}{sp}{format_percent(r.fraction_modified)}{sp}"
                f"{r.n_modified}{sp}{r.n_canonical}{sp}{r.n_other_modified}{sp}"
                f"{r.n_delete}{sp}{r.n_filtered}{sp}{r.n_diff}{sp}{r.n_nocall}\n"
            )
            self.rows_written += 1
        self._fh.write("".join(buf))

    def write_columnar(self, chrom: str, cols, motif_labels=()) -> None:
        """Vectorized row emission from a ColumnarRows batch (engine.py):
        the rows of ``write_rows``, names ``code,label`` where it gives
        them (two or more motif labels and a row's motif id)."""
        n = len(cols)
        if n == 0:
            return
        tab, sp = "\t", self.space
        names = [str(c) for c in cols.labels]
        name_idx = cols.code_idx
        n_labels = len(motif_labels)
        if n_labels >= 2:
            labeled = (cols.motif_idx >= 0) & (cols.motif_idx < n_labels)
            name_idx = np.where(
                labeled,
                len(names) + name_idx * n_labels + cols.motif_idx,
                name_idx,
            )
            names += [f"{c},{lab}" for c in names for lab in motif_labels]
        sc = ("+", "-", ".")
        buf = [
            f"{chrom}{tab}{p}{tab}{p + 1}{tab}{names[j]}{tab}"
            f"{va}{tab}{sc[s]}{tab}{p}{tab}{p + 1}{tab}255,0,0{tab}"
            f"{va}{sp}{pc}{sp}{nm}{sp}{ncn}{sp}{no}{sp}"
            f"{nd}{sp}{nf}{sp}{ndf}{sp}{nn}\n"
            for p, s, j, va, pc, nm, ncn, no, nd, nf, ndf, nn in zip(
                cols.pos.tolist(), cols.strand.tolist(),
                name_idx.tolist(), cols.valid.tolist(),
                cols.percent_strings(), cols.n_mod.tolist(),
                cols.n_can.tolist(), cols.n_other.tolist(),
                cols.n_del.tolist(), cols.n_filt.tolist(),
                cols.n_diff.tolist(), cols.n_nocall.tolist(),
            )
        ]
        self.rows_written += n
        self._fh.write("".join(buf))

    def write_formatted(self, formatted) -> None:
        """Emit a FormattedRows batch (text already rendered natively).
        Writes the bytes through the underlying binary buffer when there
        is one — skipping a decode + re-encode of multi-MB row blocks."""
        if formatted.n_rows == 0:
            return
        self.rows_written += formatted.n_rows
        buf = getattr(self._fh, "buffer", None)
        if buf is not None:
            self._fh.flush()
            buf.write(formatted.text)
        else:
            self._fh.write(formatted.text.decode("ascii"))

    def write_tile_sentinel(self) -> None:
        """Tile-boundary marker for multi-host shard files; stripped by
        parallel.devices.merge_shards when re-interleaving shards."""
        self._fh.write("\x00TILE\x00")

    def close(self):
        self._fh.flush()
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BedGraphWriter:
    """Per-(mod code, strand) bedGraph files in a directory (writers.rs:264).

    Rows: chrom start end fraction_modified valid_coverage. With
    ``partitioned`` (pileup --partition-tag), the partition key name joins
    the filename and the NoKey partition maps to "ungrouped"
    (writers.rs:318-346 get_writer_for_modstrand + use_groupings).
    """

    def __init__(self, out_dir: str, prefix: str | None = None,
                 partitioned: bool = False, append: bool = False):
        self.out_dir = out_dir
        self.prefix = prefix
        self.partitioned = partitioned
        self.append = append
        os.makedirs(out_dir, exist_ok=True)
        self._files: dict = {}
        self._names: dict = {}

    def _fh_for(self, key: tuple):
        fh = self._files.get(key)
        if fh is None:
            key_name, code, strand = key
            strand_name = {"+": "positive", "-": "negative", ".": "combined"}[strand]
            delim = "_" if key_name else ""
            name = f"{key_name}{delim}{code}_{strand_name}.bedgraph"
            if self.prefix:
                name = f"{self.prefix}_{name}"
            fh = open(
                os.path.join(self.out_dir, name),
                "a" if self.append else "w",
            )
            self._files[key] = fh
            self._names[key] = name
        return fh

    def sizes(self) -> dict:
        """{filename: byte size} of every output file (resume journal)."""
        out = {}
        for key, fh in self._files.items():
            fh.flush()
            out[self._names[key]] = fh.tell()
        return out

    def _key_name(self, partition_key) -> str:
        if not self.partitioned:
            return ""
        return "ungrouped" if partition_key is None else partition_key

    def flush(self):
        for fh in self._files.values():
            fh.flush()

    def write_rows(self, chrom: str, rows, motif_labels=(), partition_key=None):
        key_name = self._key_name(partition_key)
        for r in rows:
            label = str(r.mod_code)
            if len(motif_labels) >= 2 and r.motif_idx is not None:
                label = f"{label}_{motif_labels[r.motif_idx].replace(',', '')}"
            fh = self._fh_for((key_name, label, r.strand))
            frac = format_float(r.fraction_modified)
            fh.write(
                f"{chrom}\t{r.pos}\t{r.pos + 1}\t{frac}\t{r.valid_coverage}\n"
            )

    def write_columnar(self, chrom: str, cols, partition_key=None) -> None:
        key_name = self._key_name(partition_key)
        names = [str(c) for c in cols.labels]
        sc = ("+", "-")
        fracs = (
            cols.n_mod.astype(np.float32) / cols.valid.astype(np.float32)
        )
        for p, s, j, va, fr in zip(
            cols.pos.tolist(), cols.strand.tolist(),
            cols.code_idx.tolist(), cols.valid.tolist(), fracs.tolist(),
        ):
            fh = self._fh_for((key_name, names[j], sc[s]))
            fh.write(
                f"{chrom}\t{p}\t{p + 1}\t{_format_float_cached(float(np.float32(fr)), False)}\t{va}\n"
            )

    def close(self):
        for fh in self._files.values():
            fh.close()


class PartitioningBedMethylWriter:
    """bedMethyl rows routed to one file per partition key in a directory
    (writers.rs:1005 PartitioningBedMethylWriter): ``{prefix_}{key}.bed``,
    the NoKey partition writing to ``ungrouped.bed``."""

    def __init__(
        self,
        out_dir: str,
        prefix: str | None = None,
        mixed_delimiters: bool = False,
        append: bool = False,
    ):
        self.out_dir = out_dir
        self.prefix = prefix
        self.mixed_delimiters = mixed_delimiters
        self.append = append
        os.makedirs(out_dir, exist_ok=True)
        self._writers: dict = {}
        self._names: dict = {}

    def for_key(self, partition_key) -> BedMethylWriter:
        key_name = "ungrouped" if partition_key is None else partition_key
        w = self._writers.get(key_name)
        if w is None:
            name = (
                f"{self.prefix}_{key_name}.bed"
                if self.prefix
                else f"{key_name}.bed"
            )
            w = BedMethylWriter(
                os.path.join(self.out_dir, name), self.mixed_delimiters,
                append=self.append,
            )
            self._writers[key_name] = w
            self._names[key_name] = name
        return w

    def sizes(self) -> dict:
        """{filename: byte size} of every output file (resume journal)."""
        out = {}
        for key_name, w in self._writers.items():
            w.flush()
            out[self._names[key_name]] = w.tell()
        return out

    @property
    def rows_written(self) -> int:
        return sum(w.rows_written for w in self._writers.values())

    def flush(self):
        for w in self._writers.values():
            w.flush()

    def close(self):
        for w in self._writers.values():
            w.close()


class TsvWriter:
    def __init__(self, out, header: str | None = None):
        if isinstance(out, (str, os.PathLike)):
            self._fh = open(out, "w")
            self._owns = True
        else:
            self._fh = out
            self._owns = False
        if header:
            self._fh.write(header if header.endswith("\n") else header + "\n")

    def write(self, line: str):
        self._fh.write(line)

    def close(self):
        self._fh.flush()
        if self._owns:
            self._fh.close()
