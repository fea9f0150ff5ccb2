"""Tabix (.tbi) indexed access to bgzip-compressed text (bedMethyl) files.

Reference equivalent: src/tabix.rs HtsTabixHandler (htslib-backed). TBI
binary layout mirrors BAI with a text-format header (format, column
indices, meta char, names).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .bam import _PSEUDO_BIN, reg2bins
from .bgzf import BgzfReader


class TabixIndex:
    def __init__(self, path: str):
        # .tbi is BGZF = concatenated gzip members; decompress them all
        with open(path, "rb") as fh:
            raw = fh.read()
        blob = bytearray()
        while raw:
            d = zlib.decompressobj(wbits=47)
            blob += d.decompress(raw)
            raw = d.unused_data
        data = bytes(blob)
        if data[:4] != b"TBI\x01":
            raise ValueError(f"{path}: bad tabix magic")
        (n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm) = (
            struct.unpack_from("<8i", data, 4)
        )
        self.format = fmt
        self.col_seq, self.col_beg, self.col_end = col_seq, col_beg, col_end
        self.meta = chr(meta & 0xFF)
        p = 36
        names_blob = data[p : p + l_nm]
        self.names = [n.decode() for n in names_blob.split(b"\x00") if n]
        self.name_to_id = {n: i for i, n in enumerate(self.names)}
        p += l_nm
        per_ref = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, p); p += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, p); p += 8
                chunks = np.frombuffer(
                    data, dtype="<u8", count=2 * n_chunk, offset=p
                )
                p += 16 * n_chunk
                if bin_id != _PSEUDO_BIN:
                    bins[bin_id] = chunks.reshape(-1, 2)
            (n_intv,) = struct.unpack_from("<i", data, p); p += 4
            ioffsets = np.frombuffer(data, dtype="<u8", count=n_intv, offset=p)
            p += 8 * n_intv
            per_ref.append((bins, ioffsets))
        self._per_ref = per_ref

    def query_chunks(self, rid: int, beg: int, end: int):
        bins, ioffsets = self._per_ref[rid]
        min_off = 0
        if len(ioffsets):
            w = min(beg >> 14, len(ioffsets) - 1)
            while w >= 0 and ioffsets[w] == 0:
                w -= 1
            if w >= 0:
                min_off = int(ioffsets[w])
        chunks = []
        for b in reg2bins(beg, end):
            arr = bins.get(b)
            if arr is not None:
                for cbeg, cend in arr:
                    if cend > min_off:
                        chunks.append((max(int(cbeg), min_off), int(cend)))
        if not chunks:
            return []
        chunks.sort()
        merged = [chunks[0]]
        for cbeg, cend in chunks[1:]:
            if cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged


def bgzip_text(src, out_path: str, level: int = 6) -> str:
    """BGZF-compress text (bytes or a file path) to ``out_path`` — the
    `bgzip` step users need before tabix-indexing a bedMethyl. File
    sources stream in 4 MB chunks (WGS bedMethyls don't fit in RAM)."""
    from .bgzf import BgzfWriter

    w = BgzfWriter(out_path, level=level)
    if isinstance(src, (bytes, bytearray)):
        w.write(bytes(src))
    else:
        with open(src, "rb") as fh:
            while True:
                chunk = fh.read(4 << 20)
                if not chunk:
                    break
                w.write(chunk)
    w.close()
    return out_path


def build_tabix(
    gz_path: str,
    out_path: str | None = None,
    col_seq: int = 1,
    col_beg: int = 2,
    col_end: int = 3,
    meta: str = "#",
    skip: int = 0,
) -> str:
    """Build a .tbi index for a BGZF-compressed BED-like text file — the
    standalone equivalent of htslib's `tabix -p bed` that the reference's
    dmr/stats/localize workflows assume the user has run
    (dmr/subcommands.rs:33 "has an associated tabix index"). BED preset
    defaults (htslib tbx_conf_bed: format 0x10000, columns 1/2/3, '#').
    """
    from .bgzf import BgzfWriter
    from .bam import reg2bin

    out_path = out_path or gz_path + ".tbi"
    import mmap as _mmap

    _fh = open(gz_path, "rb")
    try:
        raw = _mmap.mmap(_fh.fileno(), 0, access=_mmap.ACCESS_READ)
    except ValueError:
        raw = _fh.read()  # empty file
    names: list[str] = []
    name_to_id: dict[str, int] = {}
    bins: list[dict] = []
    linear: list[dict] = []
    coffset = 0
    carry = b""
    carry_vbeg = 0
    meta_b = meta.encode()
    n_skipped = 0

    def handle(line: bytes, vbeg: int, vend: int):
        nonlocal n_skipped
        if not line or line.startswith(meta_b):
            return
        if n_skipped < skip:
            n_skipped += 1
            return
        f = line.split(b"\t")
        chrom = f[col_seq - 1].decode()
        beg = int(f[col_beg - 1])
        end = int(f[col_end - 1]) if col_end > 0 else beg + 1
        if end <= beg:
            end = beg + 1
        rid = name_to_id.get(chrom)
        if rid is None:
            rid = name_to_id[chrom] = len(names)
            names.append(chrom)
            bins.append({})
            linear.append({})
        b = reg2bin(beg, end)
        chunk_list = bins[rid].setdefault(b, [])
        # merge adjacent chunks (consecutive lines) to keep indexes small
        if chunk_list and chunk_list[-1][1] == vbeg:
            chunk_list[-1][1] = vend
        else:
            chunk_list.append([vbeg, vend])
        lin = linear[rid]
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            cur = lin.get(w)
            if cur is None or vbeg < cur:
                lin[w] = vbeg

    while coffset < len(raw):
        if raw[coffset : coffset + 2] != b"\x1f\x8b":
            raise ValueError(f"{gz_path}: not BGZF at offset {coffset}")
        xlen = struct.unpack_from("<H", raw, coffset + 10)[0]
        bsize = None
        p = coffset + 12
        end_x = p + xlen
        while p < end_x:
            si1, si2, slen = raw[p], raw[p + 1], struct.unpack_from(
                "<H", raw, p + 2
            )[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", raw, p + 4)[0] + 1
            p += 4 + slen
        if bsize is None:
            raise ValueError(f"{gz_path}: missing BGZF BC field")
        comp = raw[coffset + 12 + xlen : coffset + bsize - 8]
        data = zlib.decompress(comp, wbits=-15)
        pos = 0
        while True:
            nl = data.find(b"\n", pos)
            if nl < 0:
                if pos < len(data) and not carry:
                    carry_vbeg = (coffset << 16) | pos
                carry += data[pos:]
                break
            vbeg = carry_vbeg if carry else (coffset << 16) | pos
            line = carry + data[pos:nl]
            carry = b""
            handle(line, vbeg, (coffset << 16) | (nl + 1))
            pos = nl + 1
        coffset += bsize
    if carry:
        # final line without a trailing newline still indexes (htslib
        # tabix accepts it)
        handle(bytes(carry), carry_vbeg, coffset << 16)

    names_blob = b"".join(n.encode() + b"\x00" for n in names)
    out = bytearray()
    out += b"TBI\x01"
    out += struct.pack(
        "<8i", len(names), 0x10000, col_seq, col_beg, col_end,
        ord(meta), skip, len(names_blob),
    )
    out += names_blob
    for rid in range(len(names)):
        out += struct.pack("<i", len(bins[rid]))
        for b in sorted(bins[rid]):
            chunks = bins[rid][b]
            out += struct.pack("<Ii", b, len(chunks))
            for vb, ve in chunks:
                out += struct.pack("<QQ", vb, ve)
        lin = linear[rid]
        n_intv = (max(lin) + 1) if lin else 0
        out += struct.pack("<i", n_intv)
        ioff = [0] * n_intv
        for w, v in lin.items():
            ioff[w] = v
        # fill leading/interior zeros with the previous window's offset
        # (htslib does this so query's walk-back terminates fast)
        last = 0
        for w in range(n_intv):
            if ioff[w] == 0:
                ioff[w] = last
            else:
                last = ioff[w]
        for v in ioff:
            out += struct.pack("<Q", v)
    w = BgzfWriter(out_path)
    w.write(bytes(out))
    w.close()
    return out_path


class TabixFile:
    """Region fetch over a bgzipped, tabix-indexed text file
    (tabix.rs:77 HtsTabixHandler)."""

    def __init__(self, path: str, io_threads: int | None = None,
                 index_path: str | None = None):
        self.path = os.fspath(path)
        # Explicit index path = the reference's dmr --index-a/--index-b
        # (advanced_usage.md:2280: "or the --index-a option must be provided")
        idx_path = os.fspath(index_path) if index_path else self.path + ".tbi"
        if not os.path.exists(idx_path):
            raise FileNotFoundError(f"no tabix index for {path}")
        self.index = TabixIndex(idx_path)
        # io_threads = BGZF inflate workers per fetch (the reference's
        # htslib tpool / --io-threads, tabix.rs:146)
        self._bgzf = BgzfReader(self.path, io_threads=io_threads)

    @property
    def contigs(self) -> list[str]:
        return list(self.index.names)

    def has_contig(self, name: str) -> bool:
        return name in self.index.name_to_id

    def _read_chunk_lines(self, cbeg: int, cend: int) -> bytes:
        """One chunk's bytes, completed to a line boundary (line-aligned
        chunk ends — e.g. from build_tabix — must NOT pull in the next
        chunk's first line)."""
        buf = bytearray(self._bgzf.read_span(cbeg, cend))
        if not buf.endswith(b"\n"):
            self._bgzf.seek_voffset(cend)
            tail = self._bgzf.read(1 << 12)
            while tail and b"\n" not in tail:
                buf += tail
                tail = self._bgzf.read(1 << 12)
            if tail:
                buf += tail.split(b"\n", 1)[0] + b"\n"
        return bytes(buf)

    def fetch_blob(self, chrom: str, start: int, end: int) -> bytes:
        """Raw text bytes of every indexed chunk overlapping the region
        (complete lines; may include lines outside the region — the
        caller filters, e.g. the native columnar bedMethyl parser)."""
        rid = self.index.name_to_id.get(chrom)
        if rid is None:
            return b""
        return b"".join(
            self._read_chunk_lines(cbeg, cend)
            for cbeg, cend in self.index.query_chunks(rid, start, end)
        )

    def fetch(self, chrom: str, start: int, end: int):
        """Yield text lines overlapping [start, end) on chrom."""
        rid = self.index.name_to_id.get(chrom)
        if rid is None:
            return
        cb, ce = self.index.col_beg - 1, self.index.col_end - 1
        cs = self.index.col_seq - 1
        zero_based = bool(self.index.format & 0x10000)
        for cbeg, cend in self.index.query_chunks(rid, start, end):
            buf = self._read_chunk_lines(cbeg, cend)
            for line in buf.split(b"\n"):
                if not line or line.startswith(self.index.meta.encode()):
                    continue
                fields = line.split(b"\t")
                if len(fields) <= max(cb, ce, cs):
                    continue
                if fields[cs].decode() != chrom:
                    continue
                b0 = int(fields[cb])
                if not zero_based:
                    b0 -= 1
                e0 = int(fields[ce]) if ce != cb else b0 + 1
                if b0 < end and e0 > start:
                    yield line.decode()
