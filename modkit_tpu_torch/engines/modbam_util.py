"""`modbam check-tags`: audit MM/ML tag validity over a modBAM.

Reference equivalent: ``src/modbam_util/check_tags.rs``. Each record's raw
tags are parsed at two levels: the MM sub-tag headers (``C+h?`` etc.) and
the full decode. Outputs per-header counts for valid and invalid records,
an error-count table, and the observed (strand, base, code, mode) rows.

`modbam sample-reads` is a ``todo!()`` stub in the reference
(modbam_util/subcommands.rs:421-429) and is surfaced the same way here.
"""

from __future__ import annotations

import os
import sys

from ..errors import ModKitError
from ..io.bam import BamReader
from ..modcodes import mod_code_sort_key
from ..modtags import (
    DEFAULT_IMPLICIT,
    decode_read_mods,
    parse_mm_tag,
    parse_raw_mod_tags,
)


_MODE_DISPLAY = {
    "?": "?",
    ".": ".",
    DEFAULT_IMPLICIT: "default-implicit-unmodified",
}


def _subtag_header(sub) -> str:
    strand = "+" if sub.mod_strand == 0 else "-"
    codes = "".join(str(c) for c in sub.codes)
    mode = sub.mode if sub.mode in ("?", ".") else ""
    return f"{sub.fundamental_base}{strand}{codes}{mode}"


class TagViews:
    def __init__(self):
        self.valid_headers: dict[str, int] = {}
        self.invalid_headers: dict[str, int] = {}
        # (mod_strand, base) -> set of (code, mode)
        self.modified_bases: dict[tuple, set] = {}
        self.error_counts: dict[str, int] = {}
        self.ok_records = 0
        self.num_records = 0

    def add_record(self, rec):
        self.num_records += 1
        try:
            mm, ml, _mms, _mls = parse_raw_mod_tags(rec)
        except ModKitError as e:
            self._err(e)
            return
        n_tags = sum(
            1 for t, _ in rec.aux_items() if t in ("MM", "Mm", "ML", "Ml")
        )
        if n_tags != 2:
            self._err(ModKitError("multiple-tag-instances", ""))
            return
        try:
            subtags = parse_mm_tag(mm)
        except ModKitError as e:
            self._err(e)
            return
        headers = []
        for sub in subtags:
            if len(sub.deltas):
                h = _subtag_header(sub)
                if h not in headers:
                    headers.append(h)
        try:
            info = decode_read_mods(rec.forward_seq(), mm, ml)
        except ModKitError as e:
            for h in headers:
                self.invalid_headers[h] = self.invalid_headers.get(h, 0) + 1
            self._err(e)
            return
        for h in headers:
            self.valid_headers[h] = self.valid_headers.get(h, 0) + 1
        for base, strand, g in info.iter_groups():
            agg = self.modified_bases.setdefault((strand, base), set())
            present = (g.probs >= 0).any(axis=0)
            for j, code in enumerate(g.codes):
                if present[j]:
                    agg.add((code, g.skip_mode))
        self.ok_records += 1

    def _err(self, e: ModKitError):
        name = getattr(e, "name", None) or str(e)
        self.error_counts[name] = self.error_counts.get(name, 0) + 1

    # ------------------------------------------------------------ report

    def _header_rows(self, counts: dict) -> list[list[str]]:
        rows = [["tag_header", "count"]]
        for h, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            rows.append([h, str(c)])
        return rows

    def report(self, out_dir, prefix, force, permissive) -> int:
        total_err = sum(self.error_counts.values())

        def write_tsv(fname, rows):
            if out_dir is None:
                return
            os.makedirs(out_dir, exist_ok=True)
            fp = os.path.join(
                out_dir, f"{prefix}_{fname}" if prefix else fname
            )
            if os.path.exists(fp) and not force:
                raise SystemExit(f"refusing to overwrite {fp}")
            with open(fp, "w") as fh:
                for r in rows:
                    fh.write("\t".join(r) + "\n")

        if self.error_counts:
            rows = [["error", "count", "pct"]]
            for er, c in sorted(
                self.error_counts.items(), key=lambda kv: -kv[1]
            ):
                rows.append([er, str(c), f"{100.0 * c / total_err:.2f}"])
            rows.append(["total", str(total_err), "100"])
            write_tsv("error_counts.tsv", rows)
        if self.valid_headers:
            write_tsv(
                "valid_mm_headers.tsv", self._header_rows(self.valid_headers)
            )
        if self.invalid_headers:
            write_tsv(
                "invalid_mm_headers.tsv",
                self._header_rows(self.invalid_headers),
            )
        rows = [["strand", "primary_base", "mod_code", "mode"]]
        # positive strand bases sorted DESCENDING, negative ascending
        # (check_tags.rs:247-278)
        for strand_val, reverse in ((0, True), (1, False)):
            bases = sorted(
                {
                    b
                    for (s, b) in self.modified_bases
                    if s == strand_val
                },
                reverse=reverse,
            )
            for b in bases:
                entries = sorted(
                    self.modified_bases[(strand_val, b)],
                    key=lambda cm: (mod_code_sort_key(cm[0]), cm[1]),
                )
                for code, mode in entries:
                    rows.append(
                        [
                            "+" if strand_val == 0 else "-",
                            b,
                            str(code),
                            _MODE_DISPLAY.get(mode, mode),
                        ]
                    )
        write_tsv("modified_bases.tsv", rows)
        print(
            f"num PASS records: {self.ok_records} "
            f"({100.0 * self.ok_records / max(self.num_records, 1):.2f}%)",
            file=sys.stderr,
        )
        print(f"num records: {self.num_records}", file=sys.stderr)
        if total_err and not permissive:
            print(
                f"input modBAM contains {total_err} failed records",
                file=sys.stderr,
            )
            return 1
        return 0


def run_check_tags(args) -> int:
    from ..io.cram import open_alignment_reader

    reader = open_alignment_reader(args.in_bam)
    views = TagViews()
    n = 0
    # indexed region fetch unless --ignore-index forces the linear scan
    # (modbam_util/subcommands.rs:71,177 linear_scan = ignore_index || !index)
    if args.region is not None:
        from ..pileup.runner import parse_region

        tid, start, end = parse_region(args.region, reader.header)
        if reader.has_index() and not args.ignore_index:
            records = reader.fetch(tid, start, end)
        else:
            records = (
                r
                for r in reader.records()
                if r.ref_id == tid
                and not r.is_unmapped
                and r.pos < end
                and r.reference_end() > start
            )
    else:
        records = reader.records()
    for rec in records:
        if args.only_mapped and rec.is_unmapped:
            continue
        if not args.allow_non_primary and rec.is_not_primary:
            continue
        views.add_record(rec)
        n += 1
        if args.num_reads is not None and n >= args.num_reads:
            break
    return views.report(args.out_dir, args.prefix, args.force, args.permissive)


def run_sample_reads(args) -> int:
    raise SystemExit(
        "modbam sample-reads is not implemented (todo!() in the reference)"
    )
