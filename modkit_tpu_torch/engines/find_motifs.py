"""Motif discovery from bedMethyl + reference (`motif search/refine/
evaluate`, `find-motifs`).

Reference equivalent: ``src/find_motifs/``. Genome positions are classified
low/mid/high modified by their bedMethyl fraction; the +-context_size
sequence contexts around each position are tallied into k-mer tables, and
IUPAC motifs are grown by log-odds enrichment of high-modified vs
low-modified contexts: seeded search (enriched fixed-length seeds joined at
Hamming distance 1), seedless refinement from the empty motif, and an
exhaustive scan over short seeds, with extend/add/contract refinement and
superset merging.

IUPAC bases are 4-bit masks (A=1, C=2, G=4, T=8); the reference's
``intersect`` quirk for fixed bases (fixed base intersect anything other
than itself = Hole, including N) is reproduced (iupac.rs:116-135).
All motif-vs-context matching is vectorized: each k-mer table is an
``[N, L]`` uint8 matrix with per-mod-code count vectors, and a motif match
is a fused boolean-mask reduction over the constrained columns.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..bedmethyl import BedMethylLine
from ..modcodes import MOD_CODE_TO_DNA_BASE, ModCode, mod_code_sort_key
from ..writers import format_float

# ------------------------------------------------------------------ iupac --

BIT = {"A": 1, "C": 2, "G": 4, "T": 8}
BASES = ("A", "C", "G", "T")
N_MASK = 15
HOLE = 0
_MASK_TO_CHAR = {
    1: "A", 2: "C", 4: "G", 8: "T",
    5: "R", 10: "Y", 6: "S", 9: "W", 12: "K", 3: "M",
    14: "B", 13: "D", 11: "H", 7: "V", 15: "N", 0: "!",
}
_CHAR_TO_MASK = {v: k for k, v in _MASK_TO_CHAR.items()}
# bit offsets used by to_bits (A=0, C=1, G=2, T=3)
_OFFSET = {"A": 0, "C": 1, "G": 2, "T": 3}


def iupac_intersect(a: int, b: int) -> int:
    """iupac.rs:116-311 -- set intersection with the reference's fixed-base
    quirk: a fixed base intersected with anything but itself (even N) is
    Hole; N intersected with anything is N."""
    if bin(a).count("1") == 1:
        return a if a == b else HOLE
    if a == N_MASK:
        return a
    if b == N_MASK:
        return a
    return a & b


def iupac_is_superset(a: int, b: int) -> bool:
    return (a | b) == a


def iupac_remove_to_n(a: int, base: str) -> int:
    out = a & ~BIT[base]
    return N_MASK if out == HOLE else out


def iupac_char(mask: int) -> str:
    return _MASK_TO_CHAR[mask]


def parse_iupac(ch: str) -> int:
    m = _CHAR_TO_MASK.get(ch.upper())
    if m is None:
        raise ValueError(f"invalid IUPAC char {ch!r}")
    return m


# --------------------------------------------------------------- sequences --


@dataclass(frozen=True)
class MultiSequence:
    """mod_code + {motif_position: iupac mask}; position 0 is the modified
    base and is implicit (find_motifs/mod.rs:46-252)."""

    mod_code: ModCode
    seq: tuple  # sorted tuple of (pos, mask)

    @classmethod
    def from_dict(cls, mod_code, d: dict) -> "MultiSequence":
        items = tuple(
            sorted((p, m) for p, m in d.items() if m not in (HOLE, N_MASK))
        )
        return cls(mod_code, items)

    def as_dict(self) -> dict:
        return dict(self.seq)

    @classmethod
    def from_kmers(cls, kmers, context, mod_code) -> "MultiSequence":
        d: dict[int, int] = {}
        for kmer in kmers:
            for i in range(context[0]):
                pos = i - context[0]
                d[pos] = d.get(pos, 0) | BIT[chr(kmer[i])]
            for i in range(context[1]):
                col = i + context[0] + 1
                pos = i + 1
                d[pos] = d.get(pos, 0) | BIT[chr(kmer[col])]
        return cls.from_dict(mod_code, d)

    def bookends(self) -> tuple[str, str]:
        d = self.as_dict()
        neg = [p for p in d if p < 0]
        pos = [p for p in d if p > 0]
        before = ""
        if neg:
            size = max(-p for p in neg)
            slots = ["N"] * size
            for p in neg:
                slots[size - (-p)] = iupac_char(d[p])
            before = "".join(slots)
        after = ""
        if pos:
            size = max(pos)
            slots = ["N"] * size
            for p in pos:
                slots[p - 1] = iupac_char(d[p])
            after = "".join(slots)
        return before, after

    def __str__(self):
        b, a = self.bookends()
        return f"{b}[{self.mod_code}]{a}"

    def format_seq(self, canonical_base: str) -> str:
        b, a = self.bookends()
        return f"{b}{canonical_base}{a}"

    def get_offset(self) -> int:
        d = self.as_dict()
        neg = [p for p in d if p < 0]
        return max(-p for p in neg) if neg else 0

    def is_superset(self, other: "MultiSequence") -> bool:
        """mod_bam... find_motifs/mod.rs:116-145."""
        if self.mod_code != other.mod_code:
            return False
        if self.seq == other.seq:
            return True
        a, b = self.as_dict(), other.as_dict()
        if not a:
            return False
        if not b:
            return True
        if len(a) < len(b):
            return False
        if not set(a) >= set(b):
            return False
        return all(iupac_is_superset(a[p], b[p]) for p in a if p in b)

    def to_bits(self, context) -> np.ndarray:
        total = (context[0] + context[1]) * 4
        bv = np.zeros(total, dtype=bool)
        for pos, mask in self.seq:
            idx = (pos - 1 if pos > 0 else pos) + context[0]
            for b in BASES:
                if mask & BIT[b]:
                    bv[idx * 4 + _OFFSET[b]] = True
        return bv

    def edit_distance(self, other, context) -> int:
        return int((self.to_bits(context) ^ other.to_bits(context)).sum())


@dataclass(frozen=True)
class EnrichedMotif:
    canonical_base: str
    multi_sequence: MultiSequence

    def __str__(self):
        return str(self.multi_sequence)

    def format_seq(self) -> str:
        return self.multi_sequence.format_seq(self.canonical_base)

    def is_superset(self, other) -> bool:
        return self.multi_sequence.is_superset(other.multi_sequence)

    def is_subset(self, other) -> bool:
        if self.multi_sequence.mod_code != other.multi_sequence.mod_code:
            return False
        if self.multi_sequence.seq == other.multi_sequence.seq:
            return True
        a = self.multi_sequence.as_dict()
        b = other.multi_sequence.as_dict()
        for p, mask in a.items():
            om = b.get(p)
            if om is None or not iupac_is_superset(om, mask):
                return False
        return True

    def compare(self, other, context) -> tuple:
        """-> sort-ordered relationship tuple: (rank, edit_distance)
        (Equal < Subset < Superset < Disjoint{ed})."""
        if (
            self.canonical_base == other.canonical_base
            and self.multi_sequence == other.multi_sequence
        ):
            return (0, 0)
        if self.is_subset(other):
            return (1, 0)
        if self.is_superset(other):
            return (2, 0)
        return (
            3,
            self.multi_sequence.edit_distance(other.multi_sequence, context),
        )

    def with_seq(self, d: dict) -> "EnrichedMotif":
        return EnrichedMotif(
            self.canonical_base,
            MultiSequence.from_dict(self.multi_sequence.mod_code, d),
        )


RELATIONSHIP_NAMES = {0: "Equal", 1: "Subset", 2: "Superset", 3: "Disjoint"}


def parse_motif_string(
    raw_seq: str, raw_mod_code: str, raw_offset: str, context, mod_code_lookup
) -> EnrichedMotif:
    """EnrichedMotif::new_from_parts (find_motifs/mod.rs:1412-1489)."""
    offset = int(raw_offset)
    if offset >= len(raw_seq):
        raise ValueError(f"offset {offset} off the end of {raw_seq}")
    from ..modcodes import parse_mod_code

    mod_code = parse_mod_code(raw_mod_code)
    before, after = raw_seq[:offset], raw_seq[offset:]
    canonical_base = after[0]
    if canonical_base not in BASES:
        raise ValueError(f"invalid primary base {canonical_base}")
    known = mod_code_lookup.get(mod_code)
    if known is not None and known != canonical_base:
        raise ValueError(
            f"association of {mod_code} with {canonical_base} differs from "
            f"bedMethyl ({known})"
        )
    if len(before) > context[0] or len(after) - 1 > context[1]:
        raise ValueError(f"known motif {raw_seq} too large for context")
    d = {}
    lc = len(before)
    for i, ch in enumerate(before):
        d[i - lc] = parse_iupac(ch)
    for i, ch in enumerate(after[1:]):
        d[i + 1] = parse_iupac(ch)
    return EnrichedMotif(
        canonical_base, MultiSequence.from_dict(mod_code, d)
    )


# ------------------------------------------------------------------ tables --


def log_odds(low_pos, low_neg, high_pos, high_neg) -> float:
    """util.rs:30-52 (f32)."""
    numer = float(high_pos) * float(low_neg)
    denom = float(low_pos) * float(high_neg)
    if denom == 0.0:
        return 0.0 if numer == 0.0 else float("inf")
    if numer == 0.0:
        return float("-inf")
    return float(np.log2(np.float32(numer) / np.float32(denom)))


class KmerTable:
    """[N, L] context matrix with per-code counts."""

    def __init__(self, L: int):
        self.L = L
        self._rows: dict[bytes, int] = {}
        self._kmers: list[bytes] = []
        self._counts: dict[ModCode, dict[int, int]] = {}
        self.kmers: np.ndarray | None = None
        self.counts: dict[ModCode, np.ndarray] = {}

    def add(self, kmer: bytes, code: ModCode):
        i = self._rows.get(kmer)
        if i is None:
            i = len(self._kmers)
            self._rows[kmer] = i
            self._kmers.append(kmer)
        per = self._counts.setdefault(code, {})
        per[i] = per.get(i, 0) + 1

    def finalize(self):
        n = len(self._kmers)
        self.kmers = (
            np.frombuffer(b"".join(self._kmers), dtype=np.uint8).reshape(
                n, self.L
            )
            if n
            else np.empty((0, self.L), dtype=np.uint8)
        )
        for code, per in self._counts.items():
            arr = np.zeros(n, dtype=np.int64)
            for i, c in per.items():
                arr[i] = c
            self.counts[code] = arr

    @property
    def n(self) -> int:
        return len(self._kmers)

    def match_mask(self, motif: EnrichedMotif, focus: int) -> np.ndarray:
        """Boolean rows matching canonical base + motif constraints."""
        m = self.kmers[:, focus] == ord(motif.canonical_base)
        for pos, mask_bits in motif.multi_sequence.seq:
            lut = np.zeros(256, dtype=bool)
            for b in BASES:
                if mask_bits & BIT[b]:
                    lut[ord(b)] = True
            m &= lut[self.kmers[:, focus + pos]]
        return m

    def code_counts(self, code: ModCode) -> np.ndarray:
        got = self.counts.get(code)
        if got is None:
            return np.zeros(self.n, dtype=np.int64)
        return got


class MotifDB:
    """KmerModificationDb (find_motifs/mod.rs:670-965)."""

    def __init__(self, context, low: KmerTable, mid: KmerTable, high: KmerTable):
        self.context = context
        self.low = low
        self.mid = mid
        self.high = high
        self._cache: dict[str, tuple[float, int]] = {}

    @property
    def focus(self) -> int:
        return self.context[0]

    def total_mod_counts(self, motif) -> tuple[int, int]:
        code = motif.multi_sequence.mod_code
        high = int(
            self.high.code_counts(code)[
                self.high.match_mask(motif, self.focus)
            ].sum()
        )
        low = int(
            self.low.code_counts(code)[
                self.low.match_mask(motif, self.focus)
            ].sum()
        )
        return high, low

    def counts_and_frac(self, motif) -> tuple[float, int]:
        key = str(motif)
        got = self._cache.get(key)
        if got is not None:
            return got
        high, low = self.total_mod_counts(motif)
        total = high + low
        frac = float(np.float32(high) / np.float32(total)) if total else float("nan")
        self._cache[key] = (frac, high)
        return frac, high

    def masked_mod_counts(self, motif, mask) -> tuple[int, int]:
        code = motif.multi_sequence.mod_code
        hm = self.high.match_mask(motif, self.focus)
        lm = self.low.match_mask(motif, self.focus)
        if mask is not None:
            hm &= ~mask["high"]
            lm &= ~mask["low"]
        return (
            int(self.high.code_counts(code)[hm].sum()),
            int(self.low.code_counts(code)[lm].sum()),
        )

    def total_not_matching(self, motif, n_high, n_low) -> tuple[int, int]:
        code = motif.multi_sequence.mod_code
        base = ord(motif.canonical_base)
        high_pot = int(
            self.high.code_counts(code)[
                self.high.kmers[:, self.focus] == base
            ].sum()
        )
        low_pot = int(
            self.low.code_counts(code)[
                self.low.kmers[:, self.focus] == base
            ].sum()
        )
        return high_pot - n_high, low_pot - n_low

    def mid_counts(self, motif) -> int:
        code = motif.multi_sequence.mod_code
        return int(
            self.mid.code_counts(code)[
                self.mid.match_mask(motif, self.focus)
            ].sum()
        )

    def empty_mask(self) -> dict:
        return {
            "high": np.zeros(self.high.n, dtype=bool),
            "low": np.zeros(self.low.n, dtype=bool),
        }

    def subset_rows(self, canonical_base, mask, code) -> dict:
        """Row masks limited to canonical base, un-masked, code present
        (get_kmer_subset)."""
        out = {}
        for name, table in (("high", self.high), ("low", self.low)):
            m = (table.kmers[:, self.focus] == ord(canonical_base)) & (
                table.code_counts(code) > 0
            )
            if mask is not None:
                m &= ~mask[name]
            out[name] = m
        return out

    def inferred_associations(self, force_spec: bool) -> dict:
        counter: dict[ModCode, dict[str, int]] = {}
        for table in (self.high, self.mid, self.low):
            for code, arr in table.counts.items():
                present = arr > 0
                bases = table.kmers[present, self.focus]
                per = counter.setdefault(code, {})
                for b in BASES:
                    n = int((bases == ord(b)).sum())
                    if n:
                        per[b] = per.get(b, 0) + n
        out = {}
        for code, per in counter.items():
            base = max(per.items(), key=lambda kv: kv[1])[0]
            expected = MOD_CODE_TO_DNA_BASE.get(code)
            if expected is not None and expected != base and force_spec:
                raise SystemExit(
                    f"modification code {code} should be associated with "
                    f"{expected}, use --force-override-spec to override."
                )
            out[code] = base
        return out


def build_motif_db(
    reference_sequences: dict[str, np.ndarray],
    bedmethyl_lines,
    context: tuple[int, int],
    min_coverage: int,
    low_threshold: float,
    high_threshold: float,
) -> MotifDB:
    """load_bedmethyl (find_motifs/mod.rs:1109-1344)."""
    L = context[0] + context[1] + 1
    low, mid, high = KmerTable(L), KmerTable(L), KmerTable(L)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    valid = frozenset(b"ACGT")
    for bml in bedmethyl_lines:
        if bml.valid_coverage < min_coverage:
            continue
        seq = reference_sequences.get(bml.chrom)
        if seq is None:
            continue
        frac = bml.count_methylated / bml.valid_coverage
        if frac <= low_threshold:
            table = low
        elif frac > high_threshold:
            table = high
        else:
            table = mid
        pos = bml.start
        if bml.strand in (".", "+"):
            s, e = pos - context[0], pos + context[1] + 1
            if s < 0 or e > len(seq):
                continue
            kmer = seq[s:e].tobytes()
        else:
            s, e = pos - context[1], pos + context[0] + 1
            if s < 0 or e > len(seq):
                continue
            kmer = seq[s:e].tobytes().translate(comp)[::-1]
        if all(b in valid for b in kmer):
            table.add(kmer, bml.raw_mod_code)
    for t in (low, mid, high):
        t.finalize()
    return MotifDB(context, low, mid, high)


# ------------------------------------------------------------- refinement --


def _aggregate_base_counts(kmers: np.ndarray, counts: np.ndarray):
    """per (base, position) weighted counts -> [4, L] int64 (A,C,G,T)."""
    L = kmers.shape[1]
    out = np.zeros((4, L), dtype=np.int64)
    for j, b in enumerate(BASES):
        out[j] = ((kmers == ord(b)) * counts[:, None]).sum(axis=0)
    return out


def extend_motif(
    motif: EnrichedMotif,
    subset: dict,
    db: MotifDB,
    min_sites: int,
    frac_thresh: float,
    min_log_odds: float,
    extend_iters: int = 24,
) -> EnrichedMotif:
    """find_motifs/mod.rs:1491-1656."""
    focus = db.focus
    code = motif.multi_sequence.mod_code
    for _ in range(extend_iters):
        hm = db.high.match_mask(motif, focus) & subset["high"]
        lm = db.low.match_mask(motif, focus) & subset["low"]
        h_counts = db.high.code_counts(code)
        l_counts = db.low.code_counts(code)
        high_count = int(h_counts[hm].sum())
        low_count = int(l_counts[lm].sum())
        if high_count < min_sites or low_count < min_sites:
            break
        frac, _ = db.counts_and_frac(motif)
        if frac > frac_thresh:
            break
        high_bc = _aggregate_base_counts(db.high.kmers[hm], h_counts[hm])
        low_bc = _aggregate_base_counts(db.low.kmers[lm], l_counts[lm])
        d = motif.multi_sequence.as_dict()
        candidates = []
        for idx in range(db.context[0] + db.context[1] + 1):
            mot_pos = idx - db.context[0]
            if mot_pos == 0:
                continue
            cur = d.get(mot_pos)
            if cur is not None and bin(cur).count("1") == 1:
                continue  # fixed position
            for j, b in enumerate(BASES):
                if cur is not None and (cur & BIT[b]):
                    continue
                hp = int(high_bc[j, idx])
                lp = int(low_bc[j, idx])
                hn = int(high_bc[:, idx].sum()) - hp
                ln = int(low_bc[:, idx].sum()) - lp
                lo = log_odds(lp, ln, hp, hn)
                candidates.append((b, lo, mot_pos))
        if not candidates:
            break
        candidates.sort(key=lambda t: -abs(t[1]))
        max_base, max_lo, max_pos = candidates[0]
        if abs(max_lo) < min_log_odds:
            break
        if max_lo > 0:
            allowed = BIT[max_base]
        else:
            allowed = 0
            for b, lo, p in candidates:
                if lo > 0 and p == max_pos:
                    allowed |= BIT[b]
            if allowed == 0:
                break
        cur = d.pop(max_pos, None)
        newmask = allowed if cur is None else iupac_intersect(cur, allowed)
        if newmask not in (HOLE, N_MASK):
            d[max_pos] = newmask
        motif = motif.with_seq(d)
    return motif


def add_bases_to_motif(motif, db: MotifDB, frac_thresh: float):
    """find_motifs/mod.rs:1713-1771."""
    while True:
        d = motif.multi_sequence.as_dict()
        proposals: dict[int, int] = {}
        for pos, cur in d.items():
            for b in BASES:
                if cur & BIT[b]:
                    continue
                alt = dict(d)
                alt[pos] = BIT[b]
                frac, _ = db.counts_and_frac(motif.with_seq(alt))
                if frac > frac_thresh:
                    proposals[pos] = proposals.get(pos, 0) | BIT[b]
        if not proposals:
            return motif
        for pos, add_mask in proposals.items():
            cur = d.pop(pos, None)
            newmask = add_mask if cur is None else (cur | add_mask)
            if newmask not in (HOLE, N_MASK):
                d[pos] = newmask
        motif = motif.with_seq(d)


def contract_motif(motif, db: MotifDB, frac_thresh: float):
    """find_motifs/mod.rs:1800-1887."""
    while True:
        d = motif.multi_sequence.as_dict()
        candidates = []
        for pos, cur in d.items():
            for b in BASES:
                if not (cur & BIT[b]):
                    continue
                alt = dict(d)
                nm = iupac_remove_to_n(cur, b)
                if nm == N_MASK:
                    alt.pop(pos)
                else:
                    alt[pos] = nm
                frac, count = db.counts_and_frac(motif.with_seq(alt))
                if frac > frac_thresh:
                    candidates.append((frac, count, pos, b))
        if not candidates:
            return motif
        frac, count, pos, b = max(
            candidates, key=lambda t: (t[0], t[1], t[3])
        )
        cur = d.pop(pos)
        nm = iupac_remove_to_n(cur, b)
        if nm != N_MASK:
            d[pos] = nm
        motif = motif.with_seq(d)


def refine_motif(
    motif, db: MotifDB, subset, min_sites, frac_thresh, min_log_odds
):
    """find_motifs/mod.rs:1889-1929."""
    motif = extend_motif(
        motif, subset, db, min_sites, frac_thresh, min_log_odds
    )
    motif = add_bases_to_motif(motif, db, frac_thresh)
    last = motif
    while True:
        motif = contract_motif(motif, db, frac_thresh)
        motif = add_bases_to_motif(motif, db, frac_thresh)
        if motif == last:
            return motif
        last = motif


def merge_motifs(motifs: list[EnrichedMotif]) -> list[EnrichedMotif]:
    """find_motifs/mod.rs:1990-2041."""
    motifs = list(motifs)
    while True:
        matches: dict[int, set] = {}
        for i, a in enumerate(motifs):
            for j, b in enumerate(motifs):
                if i != j and a.is_superset(b):
                    matches.setdefault(i, set()).add(j)
        if not matches:
            return motifs
        discard = max(
            sorted(matches.items()), key=lambda kv: len(kv[1])
        )[1]
        motifs = [m for i, m in enumerate(motifs) if i not in discard]


# ----------------------------------------------------------------- search --


def get_fixed_length_motifs(
    canonical_base, code, init_context, min_log_odds, db: MotifDB, mask
):
    """find_motifs/mod.rs:2043-2172."""
    focus = db.focus
    lo_c, hi_c = init_context

    def sliced(table: KmerTable, table_mask):
        m = (table.kmers[:, focus] == ord(canonical_base)) & ~table_mask
        counts = table.code_counts(code)
        m &= counts > 0
        sl = table.kmers[m][:, focus - lo_c : focus + hi_c + 1]
        agg: dict[bytes, int] = {}
        for row, c in zip(sl, counts[m]):
            k = row.tobytes()
            agg[k] = agg.get(k, 0) + int(c)
        return agg

    sliced_low = sliced(db.low, mask["low"])
    sliced_high = sliced(db.high, mask["high"])
    low_total = float(sum(sliced_low.values()))
    high_total = float(sum(sliced_high.values()))
    enriched = []
    for kmer, lo_count in sliced_low.items():
        hi_count = sliced_high.get(kmer)
        if hi_count is None:
            continue
        numer = np.float32(hi_count) * np.float32(low_total)
        denom = np.float32(lo_count) * np.float32(high_total)
        if float(np.log2(numer / denom)) >= min_log_odds:
            enriched.append(kmer)
    enriched.sort()
    if not enriched:
        return []
    # join kmers at hamming distance 1 into core sets
    joined: dict[bytes, set] = {}
    for i, k1 in enumerate(enriched[:-1]):
        for k2 in enriched[i + 1 :]:
            ham = sum(1 for a, b in zip(k1, k2) if a != b)
            if ham == 1:
                joined.setdefault(k1, set()).add(k2)
                joined.setdefault(k2, set()).add(k1)
    core_sets: list[set] = []
    kmer_to_core: dict[bytes, int] = {}
    for kmer in enriched:
        if kmer in kmer_to_core:
            idx = kmer_to_core[kmer]
        else:
            core_sets.append({kmer})
            idx = len(core_sets) - 1
            kmer_to_core[kmer] = idx
        for k2 in joined.get(kmer, ()):
            if k2 not in core_sets[idx]:
                core_sets[idx].add(k2)
                kmer_to_core[k2] = idx
    out = []
    for kmers in sorted(core_sets, key=len):
        out.append(
            EnrichedMotif(
                canonical_base,
                MultiSequence.from_kmers(
                    sorted(kmers), init_context, code
                ),
            )
        )
    return out


def _update_mask(db: MotifDB, motifs, mask) -> tuple[dict, bool]:
    """KmerMask::update_with_check (find_motifs/mod.rs:417-462)."""
    new_high = np.zeros(db.high.n, dtype=bool)
    new_low = np.zeros(db.low.n, dtype=bool)
    for motif in motifs:
        new_high |= db.high.match_mask(motif, db.focus) & ~mask["high"]
        new_low |= db.low.match_mask(motif, db.focus) & ~mask["low"]
    removed = int(new_high.sum()) + int(new_low.sum())
    return (
        {"high": mask["high"] | new_high, "low": mask["low"] | new_low},
        removed > 0,
    )


def find_exhaustive_seed_motifs(
    canonical_base,
    code,
    kmer_length,
    search_min_log_odds,
    refine_log_odds,
    min_sites,
    frac_thresh,
    db: MotifDB,
    mask,
):
    """find_motifs/mod.rs:2473-2558 -- vectorized: per position-combination
    a base-tuple histogram gives all 4^k seed counts at once."""
    import itertools

    subset = db.subset_rows(canonical_base, mask, code)
    h_rows = subset["high"]
    l_rows = subset["low"]
    h_counts = db.high.code_counts(code)[h_rows]
    l_counts = db.low.code_counts(code)[l_rows]
    high_total = int(h_counts.sum())
    low_total = int(l_counts.sum())
    base_lut = np.full(256, -1, dtype=np.int8)
    for j, b in enumerate(BASES):
        base_lut[ord(b)] = j
    h_base = base_lut[db.high.kmers[h_rows]]
    l_base = base_lut[db.low.kmers[l_rows]]

    L = db.context[0] + db.context[1] + 1
    positions = [i for i in range(L) if i != db.focus]
    seeds = []
    n_pat = 4**kmer_length
    for combo in itertools.combinations(positions, kmer_length):
        def hist(base_mat, counts):
            if base_mat.shape[0] == 0:
                return np.zeros(n_pat, dtype=np.int64)
            flat = np.zeros(base_mat.shape[0], dtype=np.int64)
            for p in combo:
                flat = flat * 4 + base_mat[:, p]
            return np.bincount(flat, weights=counts, minlength=n_pat).astype(
                np.int64
            )

        h_hist = hist(h_base, h_counts)
        l_hist = hist(l_base, l_counts)
        h_not = high_total - h_hist
        l_not = low_total - l_hist
        with np.errstate(divide="ignore", invalid="ignore"):
            numer = h_hist.astype(np.float64) * l_not
            denom = l_hist.astype(np.float64) * h_not
            lo = np.where(
                denom == 0,
                np.where(numer == 0, 0.0, np.inf),
                np.where(
                    numer == 0,
                    -np.inf,
                    np.log2(
                        np.float32(1.0) * numer.astype(np.float32)
                        / np.maximum(denom, 1e-300).astype(np.float32)
                    ),
                ),
            )
        for pat in np.nonzero(lo >= search_min_log_odds)[0]:
            bases = []
            x = int(pat)
            for _ in range(kmer_length):
                bases.append(x % 4)
                x //= 4
            bases.reverse()
            d = {
                p - db.focus: BIT[BASES[bj]]
                for p, bj in zip(combo, bases)
            }
            seeds.append(
                EnrichedMotif(
                    canonical_base,
                    MultiSequence.from_dict(code, d),
                )
            )
    refined = set()
    for seed in seeds:
        refined.add(
            refine_motif(
                seed, db, subset, min_sites, frac_thresh, refine_log_odds
            )
        )
    out = []
    for motif in refined:
        high, low = db.masked_mod_counts(motif, None)
        total = high + low
        frac = high / total if total else 0.0
        if high >= min_sites and frac > frac_thresh:
            out.append(motif)
    return out


def find_motifs_for_mod(
    canonical_base,
    code,
    db: MotifDB,
    init_context,
    min_log_odds,
    min_sites,
    frac_thresh,
    skip_search,
    exhaustive_len,
    exhaustive_min_log_odds,
):
    """find_motifs/mod.rs:2310-2471."""
    mask = db.empty_mask()
    motifs: list[EnrichedMotif] = []
    # seeded loop
    while True:
        subset = db.subset_rows(canonical_base, mask, code)
        fixed = get_fixed_length_motifs(
            canonical_base, code, init_context, min_log_odds, db, mask
        )
        if not fixed:
            break
        refined = set()
        for m in fixed:
            refined.add(
                refine_motif(
                    m, db, subset, min_sites, frac_thresh, min_log_odds
                )
            )
        kept = []
        for m in refined:
            high, low = db.masked_mod_counts(m, None)
            total = high + low
            frac = high / total if total else 0.0
            if high < min_sites or frac <= frac_thresh:
                continue
            if any(m.is_superset(prev) for prev in motifs):
                continue
            kept.append(m)
        if not kept:
            break
        mask, _removed = _update_mask(db, kept, mask)
        motifs.extend(kept)
        motifs = merge_motifs(motifs)
    # seedless loop
    while True:
        subset = db.subset_rows(canonical_base, mask, code)
        empty = EnrichedMotif(
            canonical_base, MultiSequence.from_dict(code, {})
        )
        motif = refine_motif(
            empty, db, subset, min_sites, frac_thresh, min_log_odds
        )
        high, low = db.masked_mod_counts(motif, None)
        total = high + low
        frac = high / total if total else 0.0
        if high >= min_sites and frac > frac_thresh:
            motifs.append(motif)
            motifs = merge_motifs(motifs)
            mask, removed = _update_mask(db, motifs, mask)
            if not removed:
                break
        else:
            break
    if not skip_search:
        exhaustive = find_exhaustive_seed_motifs(
            canonical_base,
            code,
            exhaustive_len,
            exhaustive_min_log_odds,
            min_log_odds,
            min_sites,
            frac_thresh,
            db,
            mask,
        )
        exhaustive = [
            m
            for m in exhaustive
            if not any(m.is_subset(sm) for sm in motifs)
        ]
        motifs = merge_motifs(exhaustive + motifs)
    return [score_motif(db, m) for m in motifs]


@dataclass
class MotifResult:
    motif: EnrichedMotif
    high_count: int
    low_count: int
    mid_count: int
    high_not_matching: int
    low_not_matching: int

    def frac_modified(self) -> float:
        total = self.high_count + self.low_count
        return (
            float(np.float32(self.high_count) / np.float32(total))
            if total
            else float("nan")
        )

    def log_odds(self) -> float:
        return log_odds(
            self.low_count,
            self.low_not_matching,
            self.high_count,
            self.high_not_matching,
        )


def score_motif(db: MotifDB, motif: EnrichedMotif) -> MotifResult:
    high, low = db.total_mod_counts(motif)
    mid = db.mid_counts(motif)
    high_nm, low_nm = db.total_not_matching(motif, high, low)
    return MotifResult(motif, high, low, mid, high_nm, low_nm)


# -------------------------------------------------------------- CLI glue --


def _load_reference(path: str) -> dict[str, np.ndarray]:
    from ..io.fasta import FastaReader

    fasta = FastaReader(path)
    out = {}
    for name in fasta.names():
        seq = fasta.fetch(name)
        lower = (seq >= ord("a")) & (seq <= ord("z"))
        out[name] = np.where(lower, seq - 32, seq).astype(np.uint8)
    return out


def _iter_bedmethyl(path: str, contig: str | None, io_threads=None):
    """Plain-text or bgzf/tabix bedMethyl line iterator."""
    from ..io.bgzf import is_bgzf

    if is_bgzf(path):
        try:
            from ..io.tabix import TabixFile

            tbx = TabixFile(path, io_threads=io_threads)
            contigs = [contig] if contig else tbx.contigs
            for c in contigs:
                for line in tbx.fetch(c, 0, 1 << 60):
                    yield BedMethylLine.parse(line)
            return
        except FileNotFoundError:
            from ..io.bgzf import BgzfReader

            data = BgzfReader(path).read_all_from().decode()
            for line in data.splitlines():
                if line:
                    yield BedMethylLine.parse(line)
            return
    if contig:
        raise SystemExit(
            "--contig requires a bgzip-compressed, tabix-indexed bedMethyl"
        )
    with open(path) as fh:
        for line in fh:
            if line.strip():
                yield BedMethylLine.parse(line)


def _load_db(args, context, min_coverage, low_thresh, high_thresh) -> MotifDB:
    refs = _load_reference(args.ref)
    lines = _iter_bedmethyl(
        args.in_bedmethyl, getattr(args, "contig", None),
        io_threads=getattr(args, "io_threads", None),
    )
    return build_motif_db(
        refs, lines, context, min_coverage, low_thresh, high_thresh
    )


def _parse_known_motifs(args, context, lookup) -> list[EnrichedMotif]:
    out = []
    if getattr(args, "known_motif", None):
        raw = args.known_motif
        for i in range(0, len(raw), 3):
            seq, offset, code = raw[i], raw[i + 1], raw[i + 2]
            out.append(
                parse_motif_string(seq, code, offset, context, lookup)
            )
    if getattr(args, "known_motifs_table", None):
        for line in open(args.known_motifs_table):
            if line.startswith("mod_code") or not line.strip():
                continue
            parts = line.split()
            code, seq, offset = parts[0], parts[1], parts[2]
            out.append(
                parse_motif_string(seq, code, offset, context, lookup)
            )
    # dedup preserving order
    seen = set()
    uniq = []
    for m in out:
        if m not in seen:
            seen.add(m)
            uniq.append(m)
    return uniq


def _closest_motif(motif, others_by_base, context):
    group = others_by_base.get(motif.canonical_base)
    if not group:
        return "-", "-"
    best_idx, best_rel = min(
        ((i, motif.compare(m, context)) for i, m in enumerate(group)),
        key=lambda t: t[1],
    )
    return str(group[best_idx]), RELATIONSHIP_NAMES[best_rel[0]]


def _write_results_table(
    out, results: list[MotifResult], known_by_base, context
):
    header = [
        "mod_code", "motif", "offset", "frac_mod",
        "high_count", "low_count", "mid_count",
    ]
    if known_by_base is not None:
        header += ["status", "closest_known_motif"]
    out.write("\t".join(header) + "\n")
    for r in results:
        row = [
            str(r.motif.multi_sequence.mod_code),
            r.motif.format_seq(),
            str(r.motif.multi_sequence.get_offset()),
            format_float(r.frac_modified()),
            str(r.high_count),
            str(r.low_count),
            str(r.mid_count),
        ]
        if known_by_base is not None:
            closest, rel = _closest_motif(r.motif, known_by_base, context)
            row += [rel, closest]
        out.write("\t".join(row) + "\n")


def _write_scored_table(out, results: list[MotifResult]):
    """make_tables machine variant (find_motifs/mod.rs:2591-2646)."""
    out.write(
        "mod_code\tmotif\toffset\tfrac_mod\thigh_count\tlow_count\t"
        "mid_count\tlog_odds\n"
    )
    for r in sorted(results, key=lambda x: -x.frac_modified()):
        out.write(
            f"{r.motif.multi_sequence.mod_code}\t{r.motif.format_seq()}\t"
            f"{r.motif.multi_sequence.get_offset()}\t"
            f"{format_float(r.frac_modified())}\t{r.high_count}\t"
            f"{r.low_count}\t{r.mid_count}\t"
            f"{format_float(r.log_odds())}\n"
        )


def run_motif_search(args) -> int:
    """`motif search` / `find-motifs` (subcommand.rs:55-400)."""
    context = (args.context_size[0], args.context_size[1])
    db = _load_db(
        args, context, args.min_coverage, args.low_thresh, args.high_thresh
    )
    lookup = db.inferred_associations(not args.force_override_spec)
    known = _parse_known_motifs(args, context, lookup) or None

    if args.mod_code:
        from ..modcodes import parse_mod_code

        wanted = [parse_mod_code(c) for c in args.mod_code]
        codes = [
            (c, lookup[c]) for c in sorted(wanted, key=mod_code_sort_key)
            if c in lookup
        ]
        if not codes:
            raise SystemExit(
                "zero modification codes in common with requested and "
                "bedMethyl"
            )
    else:
        codes = sorted(lookup.items(), key=lambda kv: mod_code_sort_key(kv[0]))

    results: list[MotifResult] = []
    for code, base in codes:
        results.extend(
            find_motifs_for_mod(
                base,
                code,
                db,
                tuple(args.init_context_size),
                args.min_log_odds,
                args.min_sites,
                args.min_frac_mod,
                args.skip_search,
                args.exhaustive_seed_len,
                args.exhaustive_seed_min_log_odds,
            )
        )
    results.sort(key=lambda r: -r.frac_modified())

    known_by_base = None
    if known:
        known_by_base = {}
        for m in known:
            known_by_base.setdefault(m.canonical_base, []).append(m)

    if args.out_table:
        with open(args.out_table, "w") as fh:
            _write_results_table(fh, results, known_by_base, context)
    else:
        _write_results_table(sys.stdout, results, known_by_base, context)

    # known motifs not found -> scored table
    if known:
        found_by_base: dict[str, list] = {}
        for r in results:
            found_by_base.setdefault(r.motif.canonical_base, []).append(
                r.motif
            )
        unfound = []
        for km in known:
            hits = found_by_base.get(km.canonical_base, [])
            if not any(m.compare(km, context)[0] == 0 for m in hits):
                unfound.append(score_motif(db, km))
        if unfound and args.eval_motifs_table:
            with open(args.eval_motifs_table, "w") as fh:
                fh.write(
                    "mod_code\tmotif\toffset\tfrac_mod\thigh_count\t"
                    "low_count\tmid_count\tstatus\tclosest_found_motif\n"
                )
                disc_by_base: dict[str, list] = {}
                for r in results:
                    disc_by_base.setdefault(
                        r.motif.canonical_base, []
                    ).append(r.motif)
                for r in unfound:
                    closest, rel = _closest_motif(
                        r.motif, disc_by_base, context
                    )
                    fh.write(
                        f"{r.motif.multi_sequence.mod_code}\t"
                        f"{r.motif.format_seq()}\t"
                        f"{r.motif.multi_sequence.get_offset()}\t"
                        f"{format_float(r.frac_modified())}\t"
                        f"{r.high_count}\t{r.low_count}\t{r.mid_count}\t"
                        f"{rel}\t{closest}\n"
                    )
    return 0


def run_motif_refine(args) -> int:
    """`motif refine` (subcommand.rs:629-811)."""
    context = (args.context_size[0], args.context_size[1])
    db = _load_db(
        args, context, args.min_coverage, args.low_thresh, args.high_thresh
    )
    lookup = db.inferred_associations(not args.force_override_spec)
    known = _parse_known_motifs(args, context, lookup)
    if not known:
        raise SystemExit("failed to parse any motifs to evaluate")
    scored = [score_motif(db, m) for m in known]
    to_refine = [
        r.motif
        for r in scored
        if (
            r.high_count >= args.min_refine_sites
            or r.low_count >= args.min_refine_sites
        )
        and r.frac_modified() >= args.min_refine_frac_mod
    ]
    refined = []
    for motif in to_refine:
        subset = db.subset_rows(
            motif.canonical_base, None, motif.multi_sequence.mod_code
        )
        refined.append(
            refine_motif(
                motif, db, subset, args.min_sites, args.min_frac_mod,
                args.min_log_odds,
            )
        )
    merged = merge_motifs(refined)
    results = [score_motif(db, m) for m in merged]
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        _write_scored_table(out, results)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def run_motif_evaluate(args) -> int:
    """`motif evaluate` (subcommand.rs:812-928)."""
    context = (args.context_size[0], args.context_size[1])
    db = _load_db(
        args, context, args.min_coverage, args.low_thresh, args.high_thresh
    )
    lookup = db.inferred_associations(not args.force_override_spec)
    known = _parse_known_motifs(args, context, lookup)
    if not known:
        raise SystemExit("failed to parse any motifs to evaluate")
    results = [score_motif(db, m) for m in known]
    # --suppress-table: don't print the human-readable table; it must
    # then have somewhere else to go (subcommand.rs:849-855,916-919)
    if args.suppress_table and not (args.out or args.log_filepath):
        raise SystemExit(
            "must provide an file to output table or a log file if "
            "suppressing human-readable table"
        )
    if args.out:
        with open(args.out, "w") as out:
            _write_scored_table(out, results)
    if args.suppress_table:
        import io as _io

        from ..logging import get_logger

        buf = _io.StringIO()
        _write_scored_table(buf, results)
        get_logger().debug("evaluated motifs:\n%s", buf.getvalue())
    elif not args.out:
        _write_scored_table(sys.stdout, results)
    return 0
