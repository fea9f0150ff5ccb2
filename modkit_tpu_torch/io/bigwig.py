"""bigWig (BBI) writer + reader.

The reference writes bigWig via the Rust `bigtools` crate
(bedmethyl_util/subcommands.rs:458-523). This is a from-scratch
implementation of the UCSC BBI container (Kent et al. 2010): 64-byte
header, zoom-level headers, total summary, chromosome B+ tree, bedGraph
data sections (zlib-compressed), and cIR (R-tree) indexes for the main
data and each zoom level.

Layout notes (matching Kent's bbiWrite behavior):
- fullDataOffset points at a u64 section count, then the sections.
- each zoom level's dataOffset points at a u32 zoom-record count, then
  32-byte zoom records in (possibly compressed) sections.
- chrom ids are assigned in order of first appearance in the data; the
  B+ tree is keyed by (zero-padded) name.

The bundled reader exists for round-trip verification in tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0
BBI_VERSION = 4


class _Section:
    __slots__ = (
        "chrom_id", "start", "end", "offset", "size"
    )

    def __init__(self, chrom_id, start, end, offset, size):
        self.chrom_id = chrom_id
        self.start = start
        self.end = end
        self.offset = offset
        self.size = size


def _write_rtree(out, sections: list[_Section], block_size: int,
                 items_per_slot: int, end_file_offset: int):
    """cirTree index over data sections (bbiWrite.c cirTreeFileBulkIndex)."""
    n = len(sections)
    start_cix = sections[0].chrom_id if n else 0
    start_base = sections[0].start if n else 0
    end_cix = max((s.chrom_id for s in sections), default=0)
    end_base = 0
    for s in sections:
        if s.chrom_id == end_cix:
            end_base = max(end_base, s.end)
    out.write(
        struct.pack(
            "<IIQIIIIQII",
            RTREE_MAGIC,
            block_size,
            n,
            start_cix,
            start_base,
            end_cix,
            end_base,
            end_file_offset,
            items_per_slot,
            0,
        )
    )
    # build levels bottom-up: leaves hold up to block_size sections
    levels = []
    leaves = [
        sections[i : i + block_size] for i in range(0, n, block_size)
    ]
    levels.append(leaves)
    while len(levels[-1]) > 1:
        prev = levels[-1]
        levels.append(
            [prev[i : i + block_size] for i in range(0, len(prev), block_size)]
        )
    levels.reverse()  # root first

    def bounds(group):
        """group is a list of sections or of sub-groups."""
        if isinstance(group[0], _Section):
            scix, sbase = group[0].chrom_id, group[0].start
            ecix = max(s.chrom_id for s in group)
            ebase = max(s.end for s in group if s.chrom_id == ecix)
            return scix, sbase, ecix, ebase
        first = bounds(group[0])
        scix, sbase = first[0], first[1]
        ecix, ebase = 0, 0
        for sub in group:
            _, _, c, b = bounds(sub)
            if c > ecix or (c == ecix and b > ebase):
                if c > ecix:
                    ecix, ebase = c, b
                else:
                    ebase = max(ebase, b)
        return scix, sbase, ecix, ebase

    # compute offsets: nodes are written level by level, root first
    node_header = 4
    leaf_item = 32
    internal_item = 24
    level_offsets = []
    pos = out.tell()
    for li, level in enumerate(levels):
        level_offsets.append(pos)
        is_leaf = li == len(levels) - 1
        item_sz = leaf_item if is_leaf else internal_item
        for node in level:
            pos += node_header + item_sz * len(node)
    for li, level in enumerate(levels):
        is_leaf = li == len(levels) - 1
        if not is_leaf:
            # children of this level live in the next level, in order
            child_iter_offset = level_offsets[li + 1]
            next_level = levels[li + 1]
            child_is_leaf = li + 1 == len(levels) - 1
            child_item = leaf_item if child_is_leaf else internal_item
            child_offsets = []
            p = child_iter_offset
            for child in next_level:
                child_offsets.append(p)
                p += node_header + child_item * len(child)
            child_idx = 0
        for node in level:
            out.write(struct.pack("<BBH", 1 if is_leaf else 0, 0, len(node)))
            if is_leaf:
                for s in node:
                    out.write(
                        struct.pack(
                            "<IIIIQQ",
                            s.chrom_id,
                            s.start,
                            s.chrom_id,
                            s.end,
                            s.offset,
                            s.size,
                        )
                    )
            else:
                for sub in node:
                    scix, sbase, ecix, ebase = bounds(sub)
                    out.write(
                        struct.pack(
                            "<IIIIQ",
                            scix,
                            sbase,
                            ecix,
                            ebase,
                            child_offsets[child_idx],
                        )
                    )
                    child_idx += 1


def _zoom_reduce(intervals, chrom_ids, reduction: int):
    """Aggregate (chrom, start, end, value) intervals into fixed bins of
    size `reduction`; returns 32-byte zoom records as arrays."""
    recs = []
    for chrom, arr in intervals.items():
        cid = chrom_ids[chrom]
        starts, ends, vals = arr
        bin_lo = starts // reduction
        bin_hi = (ends - 1) // reduction
        # split intervals spanning bins (rare for 1bp bedMethyl records)
        simple = bin_lo == bin_hi
        s_, e_, v_, b_ = (
            starts[simple], ends[simple], vals[simple], bin_lo[simple],
        )
        extra = np.nonzero(~simple)[0]
        ex_rows = []
        for i in extra:
            s, e, v = int(starts[i]), int(ends[i]), float(vals[i])
            b = s // reduction
            while s < e:
                nxt = min((b + 1) * reduction, e)
                ex_rows.append((s, nxt, v, b))
                s = nxt
                b += 1
        if ex_rows:
            ex = np.array(ex_rows)
            s_ = np.concatenate([s_, ex[:, 0].astype(np.int64)])
            e_ = np.concatenate([e_, ex[:, 1].astype(np.int64)])
            v_ = np.concatenate([v_, ex[:, 2]])
            b_ = np.concatenate([b_, ex[:, 3].astype(np.int64)])
        if len(s_) == 0:
            continue
        order = np.argsort(b_, kind="stable")
        s_, e_, v_, b_ = s_[order], e_[order], v_[order], b_[order]
        uniq, idx = np.unique(b_, return_index=True)
        span = (e_ - s_).astype(np.float64)
        valid = np.add.reduceat(span, idx)
        sum_data = np.add.reduceat(span * v_, idx)
        sum_sq = np.add.reduceat(span * v_ * v_, idx)
        min_v = np.minimum.reduceat(v_, idx)
        max_v = np.maximum.reduceat(v_, idx)
        bin_start = uniq * reduction
        bin_end = np.minimum(bin_start + reduction, int(e_.max()))
        # bin end should cover at least the last interval end in the bin
        last_end = np.maximum.reduceat(e_, idx)
        bin_end = np.minimum(bin_start + reduction, last_end)
        for j in range(len(uniq)):
            recs.append(
                (
                    cid,
                    int(bin_start[j]),
                    int(bin_end[j]),
                    int(valid[j]),
                    float(min_v[j]),
                    float(max_v[j]),
                    float(sum_data[j]),
                    float(sum_sq[j]),
                )
            )
    return recs


class BigWigWriter:
    def __init__(
        self,
        path: str,
        chrom_sizes: dict[str, int],
        compress: bool = True,
        block_size: int = 256,
        items_per_slot: int = 1024,
        nzooms: int = 10,
        zooms: list[int] | None = None,
        threads: int = 1,
    ):
        self.path = path
        self.chrom_sizes = chrom_sizes
        self.compress = compress
        self.block_size = block_size
        self.items_per_slot = items_per_slot
        self.nzooms = nzooms
        self.manual_zooms = zooms
        # zlib releases the GIL, so section compression scales across a
        # thread pool (tobigwig --nthreads; the reference's bigtools runs
        # on a tokio pool, bedmethyl_util/subcommands.rs:488)
        self.threads = max(1, threads)
        # chrom -> (starts, ends, values); ids by first appearance
        self._data: dict[str, list] = {}
        self._order: list[str] = []

    def add_interval(self, chrom: str, start: int, end: int, value: float):
        if chrom not in self.chrom_sizes:
            raise ValueError(f"chrom {chrom} not in sizes")
        if chrom not in self._data:
            if chrom in self._order:
                raise ValueError(f"chrom {chrom} not contiguous in input")
            self._data[chrom] = [[], [], []]
            self._order.append(chrom)
        col = self._data[chrom]
        if col[0] and start < col[1][-1]:
            raise ValueError(
                f"input not sorted at {chrom}:{start} (prev end {col[1][-1]})"
            )
        col[0].append(start)
        col[1].append(end)
        col[2].append(value)

    def close(self):
        chrom_ids = {c: i for i, c in enumerate(self._order)}
        for name in sorted(self.chrom_sizes):
            if name not in chrom_ids:
                chrom_ids[name] = len(chrom_ids)
        intervals = {
            c: (
                np.asarray(v[0], dtype=np.int64),
                np.asarray(v[1], dtype=np.int64),
                np.asarray(v[2], dtype=np.float64),
            )
            for c, v in self._data.items()
        }
        total_span = 0.0
        sum_data = sum_sq = 0.0
        min_v, max_v = np.inf, -np.inf
        n_items = 0
        for starts, ends, vals in intervals.values():
            span = (ends - starts).astype(np.float64)
            total_span += float(span.sum())
            sum_data += float((span * vals).sum())
            sum_sq += float((span * vals * vals).sum())
            if len(vals):
                min_v = min(min_v, float(vals.min()))
                max_v = max(max_v, float(vals.max()))
            n_items += len(vals)
        if n_items == 0:
            min_v = max_v = 0.0

        # zoom reduction levels (bbiWrite: initial ~10x mean span, x4 each)
        if self.manual_zooms:
            reductions = sorted(set(self.manual_zooms))
        else:
            mean_span = (total_span / n_items) if n_items else 1.0
            red = max(int(mean_span * 10), 1)
            longest = max(self.chrom_sizes.values(), default=0)
            reductions = []
            while len(reductions) < self.nzooms and red < longest:
                reductions.append(red)
                red *= 4

        with open(self.path, "wb") as out:
            out.write(b"\x00" * 64)  # header placeholder
            out.write(b"\x00" * (24 * len(reductions)))  # zoom headers
            summary_offset = out.tell()
            out.write(b"\x00" * 40)
            # ---- chromosome B+ tree ----
            chrom_tree_offset = out.tell()
            names = sorted(self.chrom_sizes)
            key_size = max((len(n) for n in names), default=1)
            out.write(
                struct.pack(
                    "<IIIIQQ",
                    CHROM_TREE_MAGIC,
                    self.block_size,
                    key_size,
                    8,
                    len(names),
                    0,
                )
            )
            # single leaf (chrom counts are small in practice)
            out.write(struct.pack("<BBH", 1, 0, len(names)))
            for name in names:
                key = name.encode().ljust(key_size, b"\x00")
                out.write(key)
                out.write(
                    struct.pack("<II", chrom_ids[name], self.chrom_sizes[name])
                )
            # ---- main data ----
            full_data_offset = out.tell()
            out.write(struct.pack("<Q", 0))  # section count placeholder
            sections: list[_Section] = []
            max_uncompressed = 0

            def compress_all(payloads: list[bytes]) -> list[bytes]:
                if not self.compress:
                    return payloads
                if self.threads > 1 and len(payloads) > 2:
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(self.threads) as ex:
                        return list(ex.map(zlib.compress, payloads))
                return [zlib.compress(p) for p in payloads]

            metas: list[tuple[int, int, int]] = []
            payloads: list[bytes] = []
            for chrom in self._order:
                cid = chrom_ids[chrom]
                starts, ends, vals = intervals[chrom]
                for ofs in range(0, len(starts), self.items_per_slot):
                    s = starts[ofs : ofs + self.items_per_slot]
                    e = ends[ofs : ofs + self.items_per_slot]
                    v = vals[ofs : ofs + self.items_per_slot].astype(
                        np.float32
                    )
                    payload = struct.pack(
                        "<IIIIIBBH",
                        cid,
                        int(s[0]),
                        int(e[-1]),
                        0,
                        0,
                        1,  # bedGraph type
                        0,
                        len(s),
                    )
                    items = np.empty((len(s), 3), dtype=np.uint32)
                    items[:, 0] = s
                    items[:, 1] = e
                    items[:, 2] = v.view(np.uint32)
                    payload += items.tobytes()
                    max_uncompressed = max(max_uncompressed, len(payload))
                    metas.append((cid, int(s[0]), int(e[-1])))
                    payloads.append(payload)
            for (cid, s0, e1), blob in zip(metas, compress_all(payloads)):
                sections.append(
                    _Section(cid, s0, e1, out.tell(), len(blob))
                )
                out.write(blob)
            # ---- main index ----
            full_index_offset = out.tell()
            _write_rtree(
                out,
                sections,
                self.block_size,
                self.items_per_slot,
                full_index_offset,
            )
            # ---- zoom levels ----
            zoom_headers = []
            for red in reductions:
                recs = _zoom_reduce(intervals, chrom_ids, red)
                data_offset = out.tell()
                out.write(struct.pack("<I", len(recs)))
                zsections: list[_Section] = []
                zmetas: list[tuple[int, int, int]] = []
                zpayloads: list[bytes] = []
                for ofs in range(0, len(recs), self.items_per_slot):
                    chunk = recs[ofs : ofs + self.items_per_slot]
                    payload = b"".join(
                        struct.pack("<IIIIffff", *r) for r in chunk
                    )
                    max_uncompressed = max(max_uncompressed, len(payload))
                    zmetas.append(
                        (chunk[0][0], chunk[0][1], max(r[2] for r in chunk))
                    )
                    zpayloads.append(payload)
                for (cid, s0, e1), blob in zip(
                    zmetas, compress_all(zpayloads)
                ):
                    zsections.append(
                        _Section(cid, s0, e1, out.tell(), len(blob))
                    )
                    out.write(blob)
                index_offset = out.tell()
                _write_rtree(
                    out,
                    zsections,
                    self.block_size,
                    self.items_per_slot,
                    index_offset,
                )
                zoom_headers.append((red, data_offset, index_offset))
            end_of_file = out.tell()
            # backfill section count
            out.seek(full_data_offset)
            out.write(struct.pack("<Q", len(sections)))
            # header
            out.seek(0)
            out.write(
                struct.pack(
                    "<IHHQQQHHQQIQ",
                    BIGWIG_MAGIC,
                    BBI_VERSION,
                    len(zoom_headers),
                    chrom_tree_offset,
                    full_data_offset,
                    full_index_offset,
                    0,
                    0,
                    0,  # autoSql
                    summary_offset,
                    max_uncompressed if self.compress else 0,
                    0,
                )
            )
            for red, d_off, i_off in zoom_headers:
                out.write(struct.pack("<IIQQ", red, 0, d_off, i_off))
            out.seek(summary_offset)
            out.write(
                struct.pack(
                    "<Qdddd",
                    int(total_span),
                    min_v,
                    max_v,
                    sum_data,
                    sum_sq,
                )
            )
            _ = end_of_file


class BigWigReader:
    """Minimal reader for verifying written files."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        hdr = self._fh.read(64)
        (
            magic, version, zoom_levels, self.chrom_tree_offset,
            self.full_data_offset, self.full_index_offset,
            _fc, _dfc, _autosql, self.summary_offset,
            self.uncompress_buf_size, _res,
        ) = struct.unpack("<IHHQQQHHQQIQ", hdr)
        if magic != BIGWIG_MAGIC:
            raise ValueError("not a bigWig file")
        self.version = version
        self.zooms = []
        for _ in range(zoom_levels):
            red, _r, d_off, i_off = struct.unpack("<IIQQ", self._fh.read(24))
            self.zooms.append((red, d_off, i_off))
        # summary
        self._fh.seek(self.summary_offset)
        (
            self.valid_count, self.min_val, self.max_val,
            self.sum_data, self.sum_squares,
        ) = struct.unpack("<Qdddd", self._fh.read(40))
        # chrom tree
        self._fh.seek(self.chrom_tree_offset)
        magic, _bs, key_size, _vs, item_count, _r = struct.unpack(
            "<IIIIQQ", self._fh.read(32)
        )
        assert magic == CHROM_TREE_MAGIC
        self.chroms: dict[str, tuple[int, int]] = {}
        self._read_chrom_node(key_size)
        self.id_to_chrom = {
            cid: name for name, (cid, _sz) in self.chroms.items()
        }

    def _read_chrom_node(self, key_size):
        is_leaf, _r, count = struct.unpack("<BBH", self._fh.read(4))
        if is_leaf:
            for _ in range(count):
                key = self._fh.read(key_size).rstrip(b"\x00").decode()
                cid, size = struct.unpack("<II", self._fh.read(8))
                self.chroms[key] = (cid, size)
        else:
            offsets = []
            for _ in range(count):
                self._fh.read(key_size)
                (off,) = struct.unpack("<Q", self._fh.read(8))
                offsets.append(off)
            for off in offsets:
                self._fh.seek(off)
                self._read_chrom_node(key_size)

    def _walk_rtree(self, offset):
        self._fh.seek(offset)
        magic = struct.unpack("<I", self._fh.read(4))[0]
        assert magic == RTREE_MAGIC
        (_bs, item_count, *_rest) = struct.unpack("<IQIIIIQII", self._fh.read(44))
        sections = []
        self._walk_rtree_node(self._fh.tell(), sections)
        return sections

    def _walk_rtree_node(self, offset, acc):
        self._fh.seek(offset)
        is_leaf, _r, count = struct.unpack("<BBH", self._fh.read(4))
        if is_leaf:
            for _ in range(count):
                scix, sb, ecix, eb, d_off, d_sz = struct.unpack(
                    "<IIIIQQ", self._fh.read(32)
                )
                acc.append((scix, sb, ecix, eb, d_off, d_sz))
        else:
            children = []
            for _ in range(count):
                vals = struct.unpack("<IIIIQ", self._fh.read(24))
                children.append(vals[4])
            for off in children:
                self._walk_rtree_node(off, acc)

    def intervals(self) -> list[tuple[str, int, int, float]]:
        out = []
        for _scix, _sb, _ecix, _eb, d_off, d_sz in self._walk_rtree(
            self.full_index_offset
        ):
            self._fh.seek(d_off)
            blob = self._fh.read(d_sz)
            if self.uncompress_buf_size:
                blob = zlib.decompress(blob)
            cid, _cs, _ce, _step, _span, sect_type, _r, n = struct.unpack(
                "<IIIIIBBH", blob[:24]
            )
            assert sect_type == 1
            arr = np.frombuffer(blob[24:], dtype=np.uint32).reshape(-1, 3)
            chrom = self.id_to_chrom[cid]
            for s, e, v_bits in arr:
                out.append(
                    (
                        chrom,
                        int(s),
                        int(e),
                        float(np.uint32(v_bits).view(np.float32)),
                    )
                )
        return out

    def close(self):
        self._fh.close()
