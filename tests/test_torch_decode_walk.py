"""The port's tile decode walks each read's alignment as runs clipped to the
tile (and its focus); its output equals modkit_tpu's per-base decode.

``modkit_tpu_torch.native`` builds from the port's own copy of the native
runtime (``modkit_tpu_torch/csrc/modkit_native.cpp``), whose
``mk_decode_tile`` maps only the calls that land in the tile and counts
no-calls and deletions straight into the tile's histograms. Every field of
a decoded tile must equal ``modkit_tpu.native``'s for the same inputs:
``n_used``, ``n_skipped``, the errors, the vocabulary, the event arrays
and probabilities, the no-call, deletion and observed-code arrays at every
position, and the partitions.

Data: the benchmark's generator (``benchmark/gen.py``) at a 150 kb contig,
both configurations, two seeds; and a hand-built modBAM with the edge
cases (reads failing MM/ML validation, N ops, soft clips, insertions,
deletions, ``=``/``X`` ops, calls on both strands, a partition tag, a
stack of reads for ``--max-depth``, reads inside, straddling and outside
a tile).
"""

import os
import struct
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import gen, run  # noqa: E402
from modkit_tpu import native as ref_native  # noqa: E402
from modkit_tpu_torch import native  # noqa: E402
from modkit_tpu_torch.collapse import CollapseMethod  # noqa: E402
from modkit_tpu_torch.io.bam import (  # noqa: E402
    BamHeader, BamReader, BamWriter, Reference, build_bai, reg2bin,
)
from modkit_tpu_torch.io.fasta import FastaReader  # noqa: E402
from modkit_tpu_torch.modcodes import parse_mod_code  # noqa: E402
from modkit_tpu_torch.motifs import parse_motifs, scan_focus_positions  # noqa: E402
from modkit_tpu_torch.pileup.events import EdgeFilter  # noqa: E402

SMALL = {"contig_length": 150_000}
CONFIGS = ("allc-5mC5hmC-30x.pileup", "cpg-5mCG5hmCG-30x.cpg-combined")
SEEDS = (7, 3_000_000_017)
H, M = parse_mod_code("h"), parse_mod_code("m")
COLLAPSE = {
    "none": None,
    "dist_h": [CollapseMethod("dist", (H,))],  # --preset traditional
    "ignore_m": [CollapseMethod("dist", (M,))],  # --ignore m
    "norm_h": [CollapseMethod("norm", (H,))],
    "convert_h_m": [CollapseMethod("convert", (H,), M)],
}
EDGES = {"none": None, "plain": EdgeFilter(40, 25),
         "inverted": EdgeFilter(300, 200, inverted=True)}


def same_tile(got, want):
    """Every field of two decoded tiles, at every position."""
    for key in ("n_used", "n_skipped", "errors", "vocab", "n_events", "m",
                "n_parts", "part_keys"):
        assert getattr(got, key) == getattr(want, key), key
    assert (got._out.n_nc, got._out.n_del) == (want._out.n_nc, want._out.n_del)
    for key in ("rpos", "strand", "base", "probs"):
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    for key in ("nc_counts", "del_counts", "observed"):
        a, b = getattr(got, key), getattr(want, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert a.shape == b.shape and np.array_equal(a, b), key
    assert 0 <= got.walked_columns <= got.aligned_columns


def decode_both(reader, start, end, entry="bgzf", **kw):
    if entry == "bgzf":
        chunks = reader.fetch_chunk_voffsets(0, start, end)
        return (native.decode_tile_bgzf(reader.bam_raw, chunks, 0, start, end, **kw),
                ref_native.decode_tile_bgzf(reader.bam_raw, chunks, 0, start, end, **kw))
    chunks = reader.fetch_chunks_raw(0, start, end)
    return (native.decode_tile(chunks, 0, start, end, **kw),
            ref_native.decode_tile(chunks, 0, start, end, **kw))


def cpg_rule(fasta, chrom, start, end):
    return scan_focus_positions(parse_motifs([], True), fasta, chrom, start, end,
                                None, 0).rule


def focus_rule(kind, fasta, chrom, start, end):
    if kind == "none":
        return None
    if kind == "cpg":
        return cpg_rule(fasta, chrom, start, end)
    # every rule value, 2 (both strands) too, at random positions
    rng = np.random.default_rng(start)
    return rng.choice(np.array([-1, -1, -1, 0, 1, 2], np.int8), end - start)


# ------------------------------------------------------ generator modBAMs
@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Per (cell, seed): the directory of the generator's modBAM at 150 kb."""
    made = {}

    def get(cell, seed):
        if (cell, seed) not in made:
            d = tmp_path_factory.mktemp("walk")
            _wl, cfg = run.cell(cell, SMALL)
            gen.generate(cfg, seed, str(d), workers=2)
            made[cell, seed] = (BamReader(str(d / "reads.bam")),
                                FastaReader(str(d / "ref.fa")), cfg["data"]["contig_name"])
        return made[cell, seed]

    return get


# (tile, first base, last base, focus, collapse, edge, max_depth, threads, entry)
GEN_CASES = {
    "cell1": (100_000, 0, 150_000, "none", "none", "none", 8000, 2, "bgzf"),
    "cell3": (100_000, 0, 150_000, "cpg", "dist_h", "none", 8000, 2, "bgzf"),
    "cpg_cell": (100_000, 0, 150_000, "cpg", "none", "none", 8000, 1, "bgzf"),
    "1kb_ignore_m": (1_000, 40_000, 52_000, "none", "ignore_m", "none", 0, 1, "bgzf"),
    "1kb_cpg_edge": (1_000, 60_000, 72_000, "cpg", "none", "plain", 8000, 2, "fetch"),
    "1kb_inverted_depth5": (1_000, 90_000, 98_000, "rule", "dist_h", "inverted", 5, 2,
                            "bgzf"),
    "25bp_cpg_depth5": (25, 100_000, 100_500, "cpg", "dist_h", "plain", 5, 1, "fetch"),
    "25bp_rule": (25, 120_000, 120_500, "rule", "convert_h_m", "none", 0, 2, "bgzf"),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CONFIGS)
@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generated_tiles_equal_modkit_tpu(generated, case, cell, seed):
    tile, lo, hi, focus, collapse, edge, depth, threads, entry = GEN_CASES[case]
    reader, fasta, chrom = generated(cell, seed)
    events = 0
    for start in range(lo, hi, tile):
        end = min(start + tile, hi)
        got, want = decode_both(
            reader, start, end, entry, max_depth=depth, n_threads=threads,
            collapse=COLLAPSE[collapse], edge_filter=EDGES[edge],
            focus_rule=focus_rule(focus, fasta, chrom, start, end))
        same_tile(got, want)
        events += got.n_events
    assert events > 0


# ------------------------------------------------------ hand-built modBAM
CONTIG = 1_600
CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "=": 7, "X": 8}
NT16 = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
COMP = str.maketrans("ACGTN", "TGCAN")


def encode(name, pos, flag, cigar, seq, aux):
    """One BAM record (without its block size) of ``seq`` (reference
    orientation) aligned at ``pos`` by ``cigar`` [(op, length)]."""
    ref_len = sum(n for op, n in cigar if op in "MDN=X")
    packed = bytearray()
    for i in range(0, len(seq), 2):
        hi = NT16[seq[i]]
        lo = NT16[seq[i + 1]] if i + 1 < len(seq) else 0
        packed.append(hi << 4 | lo)
    rname = name.encode() + b"\0"
    cig = b"".join(struct.pack("<I", n << 4 | CIGAR_OPS[op]) for op, n in cigar)
    head = struct.pack("<iiBBHHHiiii", 0, pos, len(rname), 60,
                       reg2bin(pos, pos + max(ref_len, 1)), len(cigar), flag,
                       len(seq), -1, -1, 0)
    return head + rname + cig + bytes(packed) + bytes([30] * len(seq)) + aux


def mm_ml(fwd, rng, specs):
    """MM/ML aux of calls on a subset of each spec's base in ``fwd`` (the
    read in its sequencing orientation); spec (base, strand, codes, mode,
    extra) where ``extra`` adds deltas past the read's last base."""
    mm, ml = [], []
    for base, strand, codes, mode, extra in specs:
        at = [i for i, b in enumerate(fwd) if b == base]
        keep = sorted(rng.choice(len(at), size=len(at) * 2 // 3, replace=False)) if at else []
        deltas, prev = [], -1
        for k in keep:
            deltas.append(k - prev - 1)
            prev = k
        deltas += [0] * extra
        mm.append(f"{base}{strand}{codes}{mode}" + "".join(f",{d}" for d in deltas) + ";")
        ml += list(rng.integers(0, 256, size=len(deltas) * len(codes)))
    return "".join(mm), bytes(int(v) for v in ml)


def aux_of(mm, ml, hp=None, ml_cut=0):
    out = b""
    if mm is not None:
        out += b"MMZ" + mm.encode() + b"\0"
        ml = ml[:len(ml) - ml_cut]
        out += b"MLBC" + struct.pack("<I", len(ml)) + ml
    if hp is not None:
        out += b"HPi" + struct.pack("<i", hp)
    return out


@pytest.fixture(scope="module")
def hand_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("hand")
    rng = np.random.default_rng(19)
    ref = "".join(rng.choice(list("ACGT"), CONTIG))
    ref = ref[:300] + "CG" * 40 + ref[380:]  # a CpG island
    with open(d / "ref.fa", "w") as fh:
        fh.write(">ctg\n" + "\n".join(ref[i:i + 60] for i in range(0, CONTIG, 60)) + "\n")

    def read_of(pos, cigar):
        """A read's bases, reference orientation: matches copy the reference
        (X ops change it), insertions and soft clips are random."""
        seq, r = [], pos
        for op, n in cigar:
            if op in "M=":
                seq.append(ref[r:r + n])
            elif op == "X":
                seq.append(ref[r:r + n].translate(str.maketrans("ACGT", "CATG")))
            elif op in "IS":
                seq.append("".join(rng.choice(list("ACGT"), n)))
            if op in "MDN=X":
                r += n
        return "".join(seq)

    C2 = ("C", "+", "hm", "?", 0)
    # (pos, flag, cigar, specs, hp, ml_cut, mm missing)
    layout = [
        (0, 0, [("S", 12), ("M", 200), ("I", 3), ("M", 90), ("D", 4), ("M", 150)], [C2], 1, 0, False),
        (5, 16, [("M", 120), ("N", 300), ("M", 240), ("S", 7)], [C2], 2, 0, False),
        (30, 0, [("M", 60), ("=", 40), ("X", 2), ("=", 80), ("D", 1), ("M", 300)],
         [("C", "+", "m", "?", 0), ("G", "-", "m", "?", 0)], None, 0, False),
        (250, 16, [("S", 20), ("M", 400), ("D", 12), ("M", 200), ("S", 15)],
         [C2, ("G", "-", "m", ".", 0)], 1, 0, False),
        (260, 0, [("M", 500)], [("C", "+", "m", "?", 3)], 2, 0, False),  # invalid MM
        (270, 16, [("M", 500)], [C2], 1, 5, False),  # ML short: invalid ML
        (280, 0, [("M", 500)], [], None, 0, True),  # no MM tag
        (290, 0, [("M", 480)], [("C", "+", "m", "", 0)], 1, 0, False),  # implicit mode
        (300, 256, [("M", 300)], [C2], 1, 0, False),  # secondary: not decoded
        (310, 0, [("S", 5), ("M", 10), ("I", 2), ("M", 7)], [C2], None, 0, False),  # short
        (1_000, 16, [("M", 100), ("D", 3), ("M", 150), ("N", 100), ("M", 180)], [C2], 2, 0,
         False),
        (1_450, 0, [("M", 140), ("S", 30)], [C2], 1, 0, False),  # to the contig's end
    ]
    # a stack of reads over the CpG island, for --max-depth 5
    for i in range(7):
        layout.append((320 + i, 16 * (i % 2), [("M", 90 + 10 * i), ("D", 2), ("M", 60)], [C2],
                       i % 3 or None, 0, False))
    layout.sort(key=lambda x: x[0])
    header = BamHeader(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:ctg\tLN:{CONTIG}\n",
                       [Reference("ctg", CONTIG)])
    path = str(d / "hand.bam")
    with BamWriter(path, header) as w:
        for i, (pos, flag, cigar, specs, hp, ml_cut, no_mm) in enumerate(layout):
            seq = read_of(pos, cigar)
            fwd = seq[::-1].translate(COMP) if flag & 16 else seq
            mm, ml = (None, b"") if no_mm else mm_ml(fwd, rng, specs)
            w.write_raw(encode(f"r{i}", pos, flag, cigar, seq, aux_of(mm, ml, hp, ml_cut)))
    build_bai(path)
    return BamReader(path), FastaReader(str(d / "ref.fa"))


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("collapse", list(COLLAPSE))
@pytest.mark.parametrize("focus", ["none", "cpg", "rule"])
@pytest.mark.parametrize("tile", [25, 1_000, 100_000])
def test_hand_built_tiles_equal_modkit_tpu(hand_bam, tile, focus, collapse, edge):
    reader, fasta = hand_bam
    seen = {"skipped": 0, "events": 0, "parts": 0}
    variants = [  # (max_depth, partition tag, threads, entry, force_allow)
        (0, None, 1, "bgzf", False), (5, ["HP"], 2, "fetch", True),
        (5, None, 2, "bgzf", False), (0, ["HP"], 1, "fetch", False),
    ]
    for depth, ptags, threads, entry, force in variants:
        for start in range(0, CONTIG, tile):
            end = min(start + tile, CONTIG)
            got, want = decode_both(
                reader, start, end, entry, max_depth=depth, n_threads=threads,
                collapse=COLLAPSE[collapse], edge_filter=EDGES[edge],
                focus_rule=focus_rule(focus, fasta, "ctg", start, end),
                partition_tags=ptags, force_allow=force)
            same_tile(got, want)
            seen["skipped"] += got.n_skipped
            seen["events"] += got.n_events
            seen["parts"] = max(seen["parts"], got.n_parts)
    assert seen["skipped"] > 0 and seen["events"] > 0 and seen["parts"] == 3
