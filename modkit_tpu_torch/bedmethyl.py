"""bedMethyl record parsing and per-position count aggregation.

Semantics mirror reference ``src/dmr/bedmethyl.rs``:

- ``BedMethylLine.parse`` (bedmethyl.rs:40-93): nom field consumers; the
  name column may be ``code``, ``code,MOTIF,offset`` -- only the first
  comma-separated token is the mod code; columns 7-9 (thickStart/thickEnd/
  color) are discarded; column 5 is the valid coverage; the trailing 9
  stat columns may be tab- OR space-separated.
- ``get_stranded_position`` (bedmethyl.rs:136-151): a record's comparison
  key is (start, strand, primary base), where '+'/'.' records map to the
  positive strand with the code's primary base and '-' records map to the
  negative strand with the complemented base.
- ``aggregate_counts`` (bedmethyl.rs:172-267): group records by stranded
  position, validate that each position has a single valid-coverage and
  canonical count and that canonical + sum(modified) == valid coverage,
  then sum per-code modified counts and total coverage.
"""

from __future__ import annotations

from dataclasses import dataclass

from .modcodes import (
    MOD_CODE_TO_DNA_BASE,
    ModCode,
    complement,
    format_mod_code,
    mod_code_sort_key,
    parse_mod_code,
)


@dataclass
class BedMethylLine:
    chrom: str
    start: int
    stop: int
    raw_mod_code: ModCode
    strand: str  # '+', '-', or '.'
    count_methylated: int
    valid_coverage: int
    count_canonical: int
    count_other: int
    count_delete: int
    count_fail: int
    count_diff: int
    count_nocall: int

    @classmethod
    def parse(cls, line: str) -> "BedMethylLine":
        fields = line.split("\t")
        if len(fields) < 10:
            raise ValueError(f"failed to parse bedmethyl line {line!r}")
        chrom = fields[0]
        start = int(fields[1])
        stop = int(fields[2])
        # name column: first comma-separated token is the mod code
        # (bedmethyl.rs:41-45 consume_string_from_list)
        raw_code = fields[3].split(",")[0]
        code = parse_mod_code(raw_code)
        valid_coverage = int(fields[4])
        strand = fields[5][0]
        if strand not in "+-.":
            raise ValueError(f"invalid strand {strand!r} in {line!r}")
        # columns 7,8 (thickStart/thickEnd) and 9 (color) are discarded; the
        # remaining 9 stats columns may be tab or space separated
        # (bedmethyl.rs:56-66; writers.rs:94-101 --mixed-delim output)
        rest = "\t".join(fields[9:]).replace(" ", "\t").split("\t")
        rest = [r for r in rest if r]
        if len(rest) < 9:
            raise ValueError(f"failed to parse bedmethyl line {line!r}")
        # rest[0] = valid coverage (again), rest[1] = percent modified
        nums = [int(x) for x in rest[2:9]]
        return cls(
            chrom=chrom,
            start=start,
            stop=stop,
            raw_mod_code=code,
            strand=strand,
            count_methylated=nums[0],
            valid_coverage=valid_coverage,
            count_canonical=nums[1],
            count_other=nums[2],
            count_delete=nums[3],
            count_fail=nums[4],
            count_diff=nums[5],
            count_nocall=nums[6],
        )

    def get_stranded_position(
        self, code_lookup: dict[ModCode, str]
    ) -> tuple[int, str, str]:
        """(position, strand, primary base) comparison key
        (bedmethyl.rs:136-151)."""
        strand = "-" if self.strand == "-" else "+"
        base = code_lookup[self.raw_mod_code]
        if strand == "-":
            base = complement(base)
        return (self.start, strand, base)

    def frac_modified(self) -> float:
        return self.count_methylated / self.valid_coverage

    def to_line(self) -> str:
        """18-column tab-separated row (tabix.rs:33-74 to_line)."""
        import numpy as np

        pct = float(
            np.float32(self.count_methylated)
            / np.float32(self.valid_coverage)
            * np.float32(100.0)
        )
        return (
            f"{self.chrom}\t{self.start}\t{self.stop}\t"
            f"{format_mod_code(self.raw_mod_code)}\t{self.valid_coverage}\t"
            f"{self.strand}\t{self.start}\t{self.stop}\t255,0,0\t"
            f"{self.valid_coverage}\t{format(float(np.float32(pct)), '.2f')}\t"
            f"{self.count_methylated}\t{self.count_canonical}\t"
            f"{self.count_other}\t{self.count_delete}\t{self.count_fail}\t"
            f"{self.count_diff}\t{self.count_nocall}\n"
        )


class AggregatedCounts:
    """Per-region modified/total counts (llr_model.rs:12-116)."""

    __slots__ = ("mod_code_counts", "total")

    def __init__(self, mod_code_counts: dict | None = None, total: int = 0):
        self.mod_code_counts = mod_code_counts or {}
        self.total = total
        mods = sum(self.mod_code_counts.values())
        if mods > total:
            raise ValueError(
                f"total modification counts ({mods}) cannot be greater than "
                f"total counts ({total})"
            )

    def modified_counts(self) -> int:
        return sum(self.mod_code_counts.values())

    def canonical_counts(self) -> int:
        return self.total - self.modified_counts()

    def combine(self, other: "AggregatedCounts") -> "AggregatedCounts":
        counts = dict(self.mod_code_counts)
        for code, n in other.mod_code_counts.items():
            counts[code] = counts.get(code, 0) + n
        return AggregatedCounts(counts, self.total + other.total)

    def string_counts(self) -> str:
        if not self.mod_code_counts:
            return "."
        items = sorted(self.mod_code_counts.items(), key=lambda kv: mod_code_sort_key(kv[0]))
        return ",".join(f"{format_mod_code(c)}:{n}" for c, n in items)

    def string_percentages(self) -> str:
        import numpy as np

        if not self.mod_code_counts:
            return "."
        items = sorted(self.mod_code_counts.items(), key=lambda kv: mod_code_sort_key(kv[0]))
        parts = []
        for c, n in items:
            frac = np.float32(n) / np.float32(self.total)
            pct = float(np.float32(frac * np.float32(100.0)))
            parts.append(f"{format_mod_code(c)}:{format(pct, '.2f')}")
        return ",".join(parts)

    def pct_modified(self):
        import numpy as np

        return np.float32(self.modified_counts()) / np.float32(self.total)


def aggregate_counts(
    lines: list[BedMethylLine], code_lookup: dict[ModCode, str]
) -> AggregatedCounts:
    """bedmethyl.rs:172-267 -- group by stranded position, validate, sum."""
    if not lines:
        return AggregatedCounts()
    grouped: dict[tuple, list[BedMethylLine]] = {}
    for l in lines:
        grouped.setdefault(l.get_stranded_position(code_lookup), []).append(l)
    counts: dict[ModCode, int] = {}
    total = 0
    for _pos, group in grouped.items():
        valid_covs = {g.valid_coverage for g in group}
        canonicals = {g.count_canonical for g in group}
        if len(valid_covs) != 1 or len(canonicals) != 1:
            raise ValueError(
                "invalid data found, should not have more than 1 score or "
                "number of canonical calls per position for a base"
            )
        valid_coverage = group[0].valid_coverage
        check = group[0].count_canonical
        for g in group:
            counts[g.raw_mod_code] = (
                counts.get(g.raw_mod_code, 0) + g.count_methylated
            )
            check += g.count_methylated
        if check != valid_coverage:
            raise ValueError(
                f"invalid data, valid coverage ({valid_coverage}) is not "
                f"equal to the sum of canonical and modified counts ({check})"
            )
        total += valid_coverage
    return AggregatedCounts(counts, total)


def default_code_lookup(
    assignments: list[str] | None = None,
) -> dict[ModCode, str]:
    """SAM-spec code->base map plus user --assign-code overrides
    (dmr/subcommands.rs:302-352)."""
    lookup = dict(MOD_CODE_TO_DNA_BASE)
    if assignments:
        for raw in assignments:
            if ":" not in raw:
                raise ValueError(
                    f"invalid assignment {raw}, should be <code>:<DNA>"
                )
            code_s, base = raw.split(":", 1)
            if base not in "ACGT" or len(base) != 1:
                raise ValueError(f"invalid DNA base {base!r}")
            lookup[parse_mod_code(code_s)] = base
    return lookup
