"""From-scratch CRAM 3.0 reader (htslib-free).

The reference reads CRAM through htslib (command_utils.rs:212
get_serial_reader handles .cram transparently; fixtures
tests/resources/*.cram). This module implements the CRAM 3.0 container
format directly: ITF8/LTF8 varints, gzip/rANS-4x8 block codecs, the
compression-header encoding maps, the core bitstream codecs (HUFFMAN /
BETA / EXTERNAL / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP), slice record decode
with reference-based sequence reconstruction, and re-encoding of each
record into raw BAM record bytes so the rest of the stack (BamRecord,
MM/ML decode, pileup engines) consumes CRAM inputs unchanged.

Scope: read-only, CRAM 3.0 (the fixtures' version); the sequence requires
the reference FASTA (slice-embedded references are also honored).
Region fetch uses the .crai index when present (read_crai/build_crai —
htslib cram_index format, validated against the samtools-built fixture
indexes) to decode only covered containers; without one it falls back to
a lazy full scan.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import os
import struct
import zlib

import numpy as np

from .bam import BamHeader, BamRecord, Reference

# ---------------------------------------------------------------- varints


class Cursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def bytes(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def itf8(self) -> int:
        """CRAM ITF8: 1-5 bytes, prefix bits of the first byte give length."""
        b0 = self.u8()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x7F) << 8) | self.u8()
        elif b0 < 0xE0:
            v = ((b0 & 0x3F) << 16) | (self.u8() << 8) | self.u8()
        elif b0 < 0xF0:
            v = (
                ((b0 & 0x1F) << 24)
                | (self.u8() << 16)
                | (self.u8() << 8)
                | self.u8()
            )
        else:
            v = (
                ((b0 & 0x0F) << 28)
                | (self.u8() << 20)
                | (self.u8() << 12)
                | (self.u8() << 4)
                | (self.u8() & 0x0F)
            )
        # 32-bit signed
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        """CRAM LTF8: leading 1-bits of the first byte count extra bytes."""
        b0 = self.u8()
        n_extra = 0
        for i in range(8):
            if b0 & (0x80 >> i):
                n_extra += 1
            else:
                break
        if n_extra == 8:
            v = int.from_bytes(self.bytes(8), "big")
        else:
            v = b0 & (0xFF >> (n_extra + 1))
            for _ in range(n_extra):
                v = (v << 8) | self.u8()
        return v - (1 << 64) if v >= (1 << 63) else v

    def array_itf8(self) -> list[int]:
        n = self.itf8()
        return [self.itf8() for _ in range(n)]


# ---------------------------------------------------------------- blocks

RAW, GZIP, BZIP2, LZMA, RANS4X8 = 0, 1, 2, 3, 4

CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5


class Block:
    __slots__ = ("method", "content_type", "content_id", "data")

    def __init__(self, method, content_type, content_id, data):
        self.method = method
        self.content_type = content_type
        self.content_id = content_id
        self.data = data


def read_block(cur: Cursor) -> Block:
    method = cur.u8()
    content_type = cur.u8()
    content_id = cur.itf8()
    comp_size = cur.itf8()
    raw_size = cur.itf8()
    payload = cur.bytes(comp_size)
    cur.bytes(4)  # CRC32
    if method == RAW:
        data = payload
    elif method == GZIP:
        data = gzip.decompress(payload)
    elif method == BZIP2:
        data = bz2.decompress(payload)
    elif method == LZMA:
        data = lzma.decompress(payload)
    elif method == RANS4X8:
        data = rans4x8_decode(payload)
    else:
        raise ValueError(f"unsupported CRAM block method {method}")
    if len(data) != raw_size:
        raise ValueError(
            f"block raw size mismatch: {len(data)} != {raw_size}"
        )
    return Block(method, content_type, content_id, data)


# ------------------------------------------------------------- rANS 4x8

_RANS_LOW = 1 << 23


def rans4x8_decode(payload: bytes) -> bytes:
    """rANS 4x8 (order-0/order-1) static arithmetic coder (CRAM 3.0 §13)."""
    cur = Cursor(payload)
    order = cur.u8()
    _comp_size = struct.unpack_from("<I", payload, 1)[0]
    raw_size = struct.unpack_from("<I", payload, 5)[0]
    cur.pos = 9
    if order == 0:
        return _rans0_decode(cur, raw_size)
    return _rans1_decode(cur, raw_size)


def _read_freq_table0(cur: Cursor):
    """Order-0 frequency table (spec: symbol, freq, with RLE on symbols)."""
    freqs = np.zeros(256, dtype=np.uint32)
    sym = cur.u8()
    rle = 0
    last_sym = sym
    while True:
        freqs[sym] = cur.itf8()
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = cur.u8()
            if nxt == 0:
                break
            if nxt == last_sym + 1:
                rle = cur.u8()
                sym = nxt
            else:
                sym = nxt
        last_sym = sym
    return freqs


def _cumulative(freqs):
    cum = np.zeros(257, dtype=np.uint32)
    cum[1:] = np.cumsum(freqs)
    # symbol lookup table: for each slot in [0, 4096) which symbol
    lut = np.zeros(4096, dtype=np.uint8)
    for s in range(256):
        if freqs[s]:
            lut[cum[s] : cum[s + 1]] = s
    return cum, lut


def _rans0_decode(cur: Cursor, n_out: int) -> bytes:
    freqs = _read_freq_table0(cur)
    cum, lut = _cumulative(freqs)
    data = cur.data
    p = cur.pos
    states = list(struct.unpack_from("<4I", data, p))
    p += 16
    out = np.empty(n_out, dtype=np.uint8)
    f_arr = freqs
    c_arr = cum
    for i in range(n_out):
        j = i & 3
        x = states[j]
        slot = x & 0xFFF
        s = int(lut[slot])
        out[i] = s
        x = int(f_arr[s]) * (x >> 12) + slot - int(c_arr[s])
        while x < _RANS_LOW and p < len(data):
            x = (x << 8) | data[p]
            p += 1
        states[j] = x
    return out.tobytes()


def _rans1_decode(cur: Cursor, n_out: int) -> bytes:
    # order-1: 256 contexts, each with its own table
    freqs = np.zeros((256, 256), dtype=np.uint32)
    sym_i = cur.u8()
    rle_i = 0
    while True:
        # inner order-0 style table for context sym_i
        sym_j = cur.u8()
        rle_j = 0
        while True:
            freqs[sym_i, sym_j] = cur.itf8()
            if rle_j > 0:
                rle_j -= 1
                sym_j += 1
            else:
                nxt = cur.u8()
                if nxt == 0:
                    break
                if nxt == sym_j + 1:
                    rle_j = cur.u8()
                sym_j = nxt
        if rle_i > 0:
            rle_i -= 1
            sym_i += 1
        else:
            nxt = cur.u8()
            if nxt == 0:
                break
            if nxt == sym_i + 1:
                rle_i = cur.u8()
            sym_i = nxt

    cums = np.zeros((256, 257), dtype=np.uint32)
    np.cumsum(freqs, axis=1, out=cums[:, 1:])
    luts = np.zeros((256, 4096), dtype=np.uint8)
    for c in range(256):
        row = freqs[c]
        if not row.any():
            continue
        cum = cums[c]
        for s in np.nonzero(row)[0]:
            luts[c, cum[s] : cum[s + 1]] = s
    data = cur.data
    p = cur.pos
    states = list(struct.unpack_from("<4I", data, p))
    p += 16
    out = np.empty(n_out, dtype=np.uint8)
    # htslib stream layout: stream j decodes out[j*isz4 : (j+1)*isz4]
    # sequentially with context = previous byte of its own quarter; the
    # tail beyond 4*isz4 continues on stream 3 (rANS_static.c O1)
    isz4 = n_out >> 2
    ctx = [0, 0, 0, 0]
    for i in range(isz4):
        for j in range(4):
            idx = j * isz4 + i
            x = states[j]
            slot = x & 0xFFF
            s = int(luts[ctx[j], slot])
            out[idx] = s
            x = int(freqs[ctx[j], s]) * (x >> 12) + slot - int(cums[ctx[j], s])
            while x < _RANS_LOW and p < len(data):
                x = (x << 8) | data[p]
                p += 1
            states[j] = x
            ctx[j] = s
    for idx in range(4 * isz4, n_out):
        x = states[3]
        slot = x & 0xFFF
        s = int(luts[ctx[3], slot])
        out[idx] = s
        x = int(freqs[ctx[3], s]) * (x >> 12) + slot - int(cums[ctx[3], s])
        while x < _RANS_LOW and p < len(data):
            x = (x << 8) | data[p]
            p += 1
        states[3] = x
        ctx[3] = s
    return out.tobytes()



# ------------------------------------------------------- encodings/codecs


class BitReader:
    """MSB-first core bitstream reader."""

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.bitpos >> 3]
            bit = (byte >> (7 - (self.bitpos & 7))) & 1
            v = (v << 1) | bit
            self.bitpos += 1
        return v


class Encoding:
    """One data-series encoding from the compression header map."""

    __slots__ = ("codec", "params")

    def __init__(self, cur: Cursor):
        self.codec = cur.itf8()
        n = cur.itf8()
        self.params = Cursor(cur.bytes(n))

    def reader(self, external: dict, core: BitReader):
        p = Cursor(self.params.data)
        if self.codec == 1:  # EXTERNAL
            cid = p.itf8()
            return ExternalReader(external[cid])
        if self.codec == 3:  # HUFFMAN
            alphabet = p.array_itf8()
            lengths = p.array_itf8()
            return HuffmanReader(alphabet, lengths, core)
        if self.codec == 4:  # BYTE_ARRAY_LEN
            len_enc = Encoding(p)
            val_enc = Encoding(p)
            return ByteArrayLenReader(
                len_enc.reader(external, core),
                val_enc.reader(external, core),
            )
        if self.codec == 5:  # BYTE_ARRAY_STOP
            stop = p.u8()
            cid = p.itf8()
            return ByteArrayStopReader(stop, external[cid])
        if self.codec == 6:  # BETA
            offset = p.itf8()
            length = p.itf8()
            return BetaReader(offset, length, core)
        raise ValueError(f"unsupported CRAM encoding codec {self.codec}")


class ExternalReader:
    __slots__ = ("cur",)

    def __init__(self, cur: Cursor):
        # shares one cursor per content id: interleaved consumers of the
        # same external block (e.g. BYTE_ARRAY_LEN length+values) must
        # advance a single stream position
        self.cur = cur

    def read_int(self) -> int:
        return self.cur.itf8()

    def read_byte(self) -> int:
        return self.cur.u8()

    def read_bytes(self, n: int) -> bytes:
        return self.cur.bytes(n)


class HuffmanReader:
    """Canonical Huffman over int symbols; the ubiquitous special case is
    a single symbol with bit length 0 (a constant, consuming no bits)."""

    __slots__ = ("alphabet", "lengths", "core", "codes")

    def __init__(self, alphabet, lengths, core):
        self.alphabet = alphabet
        self.lengths = lengths
        self.core = core
        if len(alphabet) == 1:
            self.codes = None
            return
        # canonical code assignment: the CRAM spec orders by
        # (code length, SYMBOL VALUE) — an encoder may write the alphabet
        # unsorted, so ordering by list index would decode wrong symbols
        order = sorted(
            range(len(alphabet)), key=lambda i: (lengths[i], alphabet[i])
        )
        codes = {}
        code = 0
        prev_len = 0
        for i in order:
            L = lengths[i]
            code <<= L - prev_len
            prev_len = L
            codes[(L, code)] = alphabet[i]
            code += 1
        self.codes = codes

    def read_int(self) -> int:
        if self.codes is None:
            return self.alphabet[0]
        L = 0
        code = 0
        while True:
            code = (code << 1) | self.core.read_bits(1)
            L += 1
            sym = self.codes.get((L, code))
            if sym is not None:
                return sym
            if L > 31:
                raise ValueError("bad huffman stream")

    read_byte = read_int


class BetaReader:
    __slots__ = ("offset", "length", "core")

    def __init__(self, offset, length, core):
        self.offset = offset
        self.length = length
        self.core = core

    def read_int(self) -> int:
        return self.core.read_bits(self.length) - self.offset

    read_byte = read_int


class ByteArrayLenReader:
    __slots__ = ("len_r", "val_r")

    def __init__(self, len_r, val_r):
        self.len_r = len_r
        self.val_r = val_r

    def read_bytes(self) -> bytes:
        n = self.len_r.read_int()
        return self.val_r.read_bytes(n)


class ByteArrayStopReader:
    __slots__ = ("stop", "cur")

    def __init__(self, stop, cur: Cursor):
        self.stop = stop
        self.cur = cur

    def read_bytes(self) -> bytes:
        data = self.cur.data
        p = self.cur.pos
        q = data.index(self.stop, p)
        self.cur.pos = q + 1
        return data[p:q]


# ------------------------------------------------- compression header


class CompressionHeader:
    def __init__(self, data: bytes):
        cur = Cursor(data)
        # preservation map
        _size = cur.itf8()
        n = cur.itf8()
        self.read_names_included = True
        self.ap_delta = True
        self.reference_required = True
        self.substitution_matrix = b"\x00" * 5
        self.tag_dict: list[list[tuple[str, str]]] = [[]]
        for _ in range(n):
            key = cur.bytes(2)
            if key == b"RN":
                self.read_names_included = cur.u8() != 0
            elif key == b"AP":
                self.ap_delta = cur.u8() != 0
            elif key == b"RR":
                self.reference_required = cur.u8() != 0
            elif key == b"SM":
                self.substitution_matrix = cur.bytes(5)
            elif key == b"TD":
                blob_len = cur.itf8()
                blob = cur.bytes(blob_len)
                self.tag_dict = []
                for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                    tags = []
                    for i in range(0, len(line), 3):
                        tags.append(
                            (line[i : i + 2].decode(), chr(line[i + 2]))
                        )
                    self.tag_dict.append(tags)
            else:
                raise ValueError(f"unknown preservation key {key}")
        # data series encodings
        _size = cur.itf8()
        n = cur.itf8()
        self.series: dict[bytes, Encoding] = {}
        for _ in range(n):
            key = cur.bytes(2)
            self.series[key] = Encoding(cur)
        # tag encodings
        _size = cur.itf8()
        n = cur.itf8()
        self.tag_enc: dict[int, Encoding] = {}
        for _ in range(n):
            key = cur.itf8()
            self.tag_enc[key] = Encoding(cur)

        # substitution matrix decode (spec section 10.4): per reference
        # base (ACGTN order), one byte packs 2-bit codes for each of the 4
        # substitutable bases in alphabetical order, highest bits first;
        # invert to (ref_base, code) -> substituted base
        self.sub_code = {}
        bases = "ACGTN"
        for r_i, ref_base in enumerate(bases):
            others = [b for b in bases if b != ref_base]
            byte = self.substitution_matrix[r_i]
            for j, other in enumerate(others):
                code = (byte >> (6 - 2 * j)) & 3
                self.sub_code[(ref_base, code)] = other


# ------------------------------------------------------------ slice decode

_SEQ_NIB = {b: i for i, b in enumerate("=ACMGRSVTWYHKDBN")}


def _encode_bam_record(
    name: bytes, flag: int, ref_id: int, pos: int, mapq: int,
    cigar: list[tuple[int, int]], mate_ref: int, mate_pos: int, tlen: int,
    seq: bytes, quals: bytes, aux: bytes,
) -> bytes:
    l_seq = len(seq)
    nib = bytearray((l_seq + 1) // 2)
    for i, b in enumerate(seq):
        code = _SEQ_NIB.get(chr(b), 15)
        if i & 1:
            nib[i >> 1] |= code
        else:
            nib[i >> 1] = code << 4
    cig = b"".join(
        struct.pack("<I", (length << 4) | op) for op, length in cigar
    )
    # BAM reg2bin
    end = pos
    for op, length in cigar:
        if op in (0, 2, 3, 7, 8):
            end += length
    end = max(end, pos + 1)
    from .bam import reg2bin

    head = struct.pack(
        "<iiBBHHHiiii",
        ref_id, pos, len(name) + 1, mapq, reg2bin(pos, end),
        len(cigar), flag, l_seq, mate_ref, mate_pos, tlen,
    )
    return (
        head + name + b"\x00" + cig + bytes(nib)
        + (quals if len(quals) == l_seq else b"\xff" * l_seq)
        + aux
    )


class SliceDecoder:
    """Decodes one slice's records into raw BAM record byte buffers."""

    def __init__(self, comp: CompressionHeader, blocks: list[Block],
                 header: BamHeader, ref_getter, rg_ids=()):
        self.comp = comp
        self.rg_ids = list(rg_ids)
        sh = Cursor(blocks[0].data)  # slice header block
        self.ref_id = sh.itf8()
        self.start = sh.itf8()  # 1-based
        self.span = sh.itf8()
        self.n_records = sh.itf8()
        self.record_counter = sh.ltf8()
        self.n_blocks = sh.itf8()
        _ids = sh.array_itf8()
        self.embedded_ref_id = sh.itf8()
        self.md5 = sh.bytes(16)
        self.header = header
        core = None
        external: dict[int, Cursor] = {}
        embedded_ref = None
        # only THIS slice's n_blocks belong to it — scanning the rest of
        # the container would let a later slice's CORE/EXTERNAL blocks
        # overwrite this slice's streams (multi-slice containers)
        for b in blocks[1 : 1 + self.n_blocks]:
            if b.content_type == CT_CORE:
                core = BitReader(b.data)
            elif b.content_type == CT_EXTERNAL:
                external[b.content_id] = Cursor(b.data)
                if (
                    self.embedded_ref_id >= 0
                    and b.content_id == self.embedded_ref_id
                ):
                    embedded_ref = b.data
        self.core = core
        self.external = external
        # per-series readers, created lazily
        self._readers: dict[bytes, object] = {}
        self._tag_readers: dict[int, object] = {}
        self._ref_getter = ref_getter
        self._cur_rid = None  # multi-ref: per-record reference switch
        if embedded_ref is not None:
            self._ref = embedded_ref
            self._ref_offset = self.start - 1
        elif self.ref_id >= 0 and comp.reference_required:
            self._ref = ref_getter(self.ref_id)
            self._ref_offset = 0
        else:
            self._ref = b""
            self._ref_offset = 0

    def _r(self, key: bytes):
        r = self._readers.get(key)
        if r is None:
            enc = self.comp.series.get(key)
            if enc is None:
                raise ValueError(f"missing data series {key!r}")
            r = self._readers[key] = enc.reader(self.external, self.core)
        return r

    def _tag_r(self, key: int):
        r = self._tag_readers.get(key)
        if r is None:
            r = self._tag_readers[key] = self.comp.tag_enc[key].reader(
                self.external, self.core
            )
        return r

    def _ref_base(self, rpos0: int) -> str:
        i = rpos0 - self._ref_offset
        if 0 <= i < len(self._ref):
            return chr(self._ref[i]).upper()
        return "N"

    def _ref_bytes(self, rpos0: int, n: int) -> bytes:
        i = rpos0 - self._ref_offset
        chunk = self._ref[max(i, 0) : max(i + n, 0)].upper()
        if len(chunk) < n:
            chunk = chunk + b"N" * (n - len(chunk))
        return chunk

    def decode_records(self) -> list[bytes]:
        comp = self.comp
        recs = []
        raw_fields = []
        last_pos = self.start - 1  # 0-based running AP base
        for _ in range(self.n_records):
            bf = self._r(b"BF").read_int()
            cf = self._r(b"CF").read_int()
            if self.ref_id == -2:
                ri = self._r(b"RI").read_int()
                # multi-reference slice: resolve this record's reference
                # (RR=0 files store sequences verbatim and need no ref,
                # same as the single-ref branch's reference_required guard)
                if ri != self._cur_rid:
                    self._cur_rid = ri
                    self._ref = (
                        self._ref_getter(ri)
                        if ri >= 0 and comp.reference_required
                        else b""
                    )
                    self._ref_offset = 0
            else:
                ri = self.ref_id
            rl = self._r(b"RL").read_int()
            ap = self._r(b"AP").read_int()
            if comp.ap_delta:
                pos0 = last_pos + ap
                last_pos = pos0
            else:
                pos0 = ap - 1
            rg = self._r(b"RG").read_int()
            name = b""
            if comp.read_names_included:
                name = self._r(b"RN").read_bytes()
            mate_ref, mate_pos, tlen = -1, -1, 0
            mf = 0
            nf = -1
            if cf & 0x2:  # detached
                mf = self._r(b"MF").read_int()
                if not comp.read_names_included:
                    name = self._r(b"RN").read_bytes()
                mate_ref = self._r(b"NS").read_int()
                mate_pos = self._r(b"NP").read_int() - 1
                tlen = self._r(b"TS").read_int()
                if mf & 1:
                    bf |= 0x20  # mate reverse
                if mf & 2:
                    bf |= 0x8  # mate unmapped
            elif cf & 0x4:  # mate downstream in this slice
                nf = self._r(b"NF").read_int()
            tl = self._r(b"TL").read_int()
            aux = bytearray()
            for tag, typ in comp.tag_dict[tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                val = self._tag_r(key).read_bytes()
                # tag values are verbatim BAM aux value bytes (for B
                # arrays: subtype + LE32 count + elements)
                aux += tag.encode() + typ.encode() + val
            if rg >= 0 and rg < len(self.rg_ids):
                aux += b"RGZ" + self.rg_ids[rg].encode() + b"\x00"

            quals = bytearray(b"\xff" * rl)
            cigar: list[tuple[int, int]] = []
            if not (bf & 4):  # mapped
                seq = bytearray(rl)
                fn = self._r(b"FN").read_int()
                qpos = 0  # 0-based read coordinate
                rpos = pos0
                fpos = 0  # running 1-based feature position
                pend_m = 0

                def emit(op, length):
                    if length <= 0:
                        return
                    if cigar and cigar[-1][0] == op:
                        cigar[-1] = (op, cigar[-1][1] + length)
                    else:
                        cigar.append((op, length))

                def advance_match(n):
                    nonlocal qpos, rpos
                    if n <= 0:
                        return
                    seq[qpos : qpos + n] = self._ref_bytes(rpos, n)
                    emit(0, n)
                    qpos += n
                    rpos += n

                for _f in range(fn):
                    fc = chr(self._r(b"FC").read_byte())
                    # FP: 1-based in-read position, delta-coded from the
                    # previous feature (first delta is from position 0)
                    fpos += self._r(b"FP").read_int()
                    advance_match(fpos - 1 - qpos)
                    if fc == "B":
                        seq[qpos] = self._r(b"BA").read_byte()
                        quals[qpos] = self._r(b"QS").read_byte()
                        emit(0, 1)
                        qpos += 1
                        rpos += 1
                    elif fc == "X":
                        code = self._r(b"BS").read_int()
                        seq[qpos] = ord(
                            comp.sub_code[(self._ref_base(rpos), code)]
                        )
                        emit(0, 1)
                        qpos += 1
                        rpos += 1
                    elif fc == "I":
                        ins = self._r(b"IN").read_bytes()
                        seq[qpos : qpos + len(ins)] = ins
                        emit(1, len(ins))
                        qpos += len(ins)
                    elif fc == "i":
                        seq[qpos] = self._r(b"BA").read_byte()
                        emit(1, 1)
                        qpos += 1
                    elif fc == "S":
                        sc = self._r(b"SC").read_bytes()
                        seq[qpos : qpos + len(sc)] = sc
                        emit(4, len(sc))
                        qpos += len(sc)
                    elif fc == "D":
                        dl = self._r(b"DL").read_int()
                        emit(2, dl)
                        rpos += dl
                    elif fc == "N":
                        rs = self._r(b"RS").read_int()
                        emit(3, rs)
                        rpos += rs
                    elif fc == "P":
                        emit(6, self._r(b"PD").read_int())
                    elif fc == "H":
                        emit(5, self._r(b"HC").read_int())
                    elif fc == "Q":
                        quals[qpos] = self._r(b"QS").read_byte()
                    elif fc == "b":
                        bb = self._r(b"BB").read_bytes()
                        seq[qpos : qpos + len(bb)] = bb
                        emit(0, len(bb))
                        qpos += len(bb)
                        rpos += len(bb)
                    elif fc == "q":
                        qq = self._r(b"QQ").read_bytes()
                        quals[qpos : qpos + len(qq)] = qq
                    else:
                        raise ValueError(f"unknown feature code {fc!r}")
                advance_match(rl - qpos)
                if not cigar:
                    cigar = [(0, rl)] if rl else []
                # regenerate NM/MD (dropped at encode when derivable from
                # the reference; htslib reconstructs them on decode too)
                td_tags = {t for t, _ in comp.tag_dict[tl]}
                if self._ref and not {"NM", "MD"} <= td_tags:
                    md, nm = self._md_nm(seq, cigar, pos0)
                    if "NM" not in td_tags:
                        if nm < 256:
                            aux += b"NMC" + bytes([nm])
                        elif nm < 65536:
                            aux += b"NMS" + struct.pack("<H", nm)
                        else:
                            aux += b"NMI" + struct.pack("<I", nm)
                    if "MD" not in td_tags:
                        aux += b"MDZ" + md.encode() + b"\x00"
                mq = self._r(b"MQ").read_int()
                if cf & 0x1:
                    q = self._r(b"QS")
                    quals = bytearray(
                        bytes(q.read_byte() for _ in range(rl))
                    )
            else:
                mq = 0
                ba = self._r(b"BA")
                seq = bytearray(ba.read_byte() for _ in range(rl))
                if cf & 0x1:
                    q = self._r(b"QS")
                    quals = bytearray(
                        bytes(q.read_byte() for _ in range(rl))
                    )
                pos0 = pos0 if self.ref_id != -1 else -1

            raw_fields.append(
                dict(
                    name=bytes(name), flag=bf, ref_id=ri, pos=pos0,
                    mapq=mq if not (bf & 4) else 0, cigar=cigar,
                    mate_ref=mate_ref, mate_pos=mate_pos, tlen=tlen,
                    seq=bytes(seq), quals=bytes(quals), aux=bytes(aux),
                    nf=nf, cf=cf, rg=rg,
                )
            )

        # resolve downstream mates (CF bit 0x4): record i pairs with
        # record i + NF + 1
        for i, f in enumerate(raw_fields):
            if f["nf"] >= 0:
                j = i + f["nf"] + 1
                m = raw_fields[j]
                f["mate_ref"] = m["ref_id"]
                f["mate_pos"] = m["pos"]
                m["mate_ref"] = f["ref_id"]
                m["mate_pos"] = f["pos"]
                if m["flag"] & 0x10:
                    f["flag"] |= 0x20
                if f["flag"] & 0x10:
                    m["flag"] |= 0x20
                if m["flag"] & 0x4:
                    f["flag"] |= 0x8
                if f["flag"] & 0x4:
                    m["flag"] |= 0x8
                # template size: leftmost to rightmost
                lo = min(f["pos"], m["pos"])
                hi = max(
                    f["pos"] + _ref_len(f["cigar"]),
                    m["pos"] + _ref_len(m["cigar"]),
                )
                if f["pos"] <= m["pos"]:
                    f["tlen"], m["tlen"] = hi - lo, lo - hi
                else:
                    f["tlen"], m["tlen"] = lo - hi, hi - lo

        for f in raw_fields:
            recs.append(
                _encode_bam_record(
                    f["name"], f["flag"], f["ref_id"], f["pos"], f["mapq"],
                    f["cigar"], f["mate_ref"], f["mate_pos"], f["tlen"],
                    f["seq"], f["quals"], f["aux"],
                )
            )
        return recs


    def _md_nm(self, seq, cigar, pos0):
        """MD string + NM edit distance from the reconstructed alignment
        (samtools calmd semantics)."""
        md = []
        nm = 0
        match_run = 0
        qpos = 0
        rpos = pos0
        for op, ln in cigar:
            if op in (0, 7, 8):
                for k in range(ln):
                    rb = self._ref_base(rpos + k)
                    if chr(seq[qpos + k]) == rb:
                        match_run += 1
                    else:
                        md.append(str(match_run))
                        md.append(rb)
                        match_run = 0
                        nm += 1
                qpos += ln
                rpos += ln
            elif op == 1:
                nm += ln
                qpos += ln
            elif op == 4:
                qpos += ln
            elif op == 2:
                md.append(str(match_run))
                match_run = 0
                md.append(
                    "^" + "".join(
                        self._ref_base(rpos + k) for k in range(ln)
                    )
                )
                nm += ln
                rpos += ln
            elif op == 3:
                rpos += ln
        md.append(str(match_run))
        return "".join(md), nm


def _ref_len(cigar) -> int:
    return sum(length for op, length in cigar if op in (0, 2, 3, 7, 8))


# --------------------------------------------------------------- reader


class CramReader:
    """Read-only CRAM 3.0 reader exposing the BamReader surface used by
    the engines: .header, .records(), .fetch(tid, start, end),
    .has_index(). Records come back as BamRecord objects re-encoded to raw
    BAM bytes, so every downstream consumer (MM/ML decode, pileup events,
    adjust, extract) works unchanged.

    ``reference_fasta``: path to the reference (required when slices are
    not self-contained; the reference's htslib resolves it via UR/M5 —
    here an explicit path, the @SQ UR field, or MODKIT_REF_PATH)."""

    def __init__(self, path: str, reference_fasta: str | None = None):
        self.path = str(path)
        with open(self.path, "rb") as fh:
            self._data = fh.read()
        if self._data[:4] != b"CRAM":
            raise ValueError(f"{path}: not a CRAM file")
        self.major, self.minor = self._data[4], self._data[5]
        if self.major != 3:
            raise ValueError(
                f"unsupported CRAM version {self.major}.{self.minor}"
            )
        cur = Cursor(self._data, 26)
        # first container: SAM header text
        blocks, _meta = self._read_container(cur)
        text_block = blocks[0].data
        (hlen,) = struct.unpack_from("<i", text_block, 0)
        text = text_block[4 : 4 + hlen].decode()
        refs = []
        self._ur = {}
        self._rg_ids = []
        for line in text.splitlines():
            if line.startswith("@RG"):
                for f in line.split("\t")[1:]:
                    if f.startswith("ID:"):
                        self._rg_ids.append(f[3:])
            if line.startswith("@SQ"):
                fields = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                refs.append(Reference(fields["SN"], int(fields["LN"])))
                if "UR" in fields:
                    self._ur[len(refs) - 1] = fields["UR"]
        self.header = BamHeader(text, refs)
        self._containers_at = cur.pos
        self._reference_fasta = reference_fasta
        self._fasta = None
        self._ref_cache: dict[int, bytes] = {}
        self._records: list[BamRecord] | None = None
        # .crai indexed seek: region fetch decodes only covered containers
        # (htslib cram_index behavior; O(file) lazy scan without it)
        self._crai = None
        crai_path = self.path + ".crai"
        if os.path.exists(crai_path):
            self._crai = read_crai(crai_path)
        self._container_cache: dict[int, list[BamRecord]] = {}

    def _read_container(self, cur: Cursor):
        length = int.from_bytes(cur.bytes(4), "little", signed=True)
        ref = cur.itf8()
        start = cur.itf8()
        span = cur.itf8()
        nrec = cur.itf8()
        cur.ltf8()  # record counter
        cur.ltf8()  # bases
        nblocks = cur.itf8()
        cur.array_itf8()  # landmarks
        cur.bytes(4)  # crc
        body = Cursor(self._data, cur.pos)
        blocks = [read_block(body) for _ in range(nblocks)]
        cur.pos += length
        return blocks, (ref, start, span, nrec)

    def _get_ref(self, tid: int) -> bytes:
        seq = self._ref_cache.get(tid)
        if seq is not None:
            return seq
        if self._fasta is None:
            from .fasta import FastaReader

            path = self._reference_fasta
            if path is None:
                path = os.environ.get("MODKIT_REF_PATH")
            if path is None:
                ur = self._ur.get(tid, "")
                if ur.startswith("file://"):
                    ur = ur[7:]
                if ur and os.path.exists(ur):
                    path = ur
            if path is None:
                raise ValueError(
                    "CRAM decode requires the reference FASTA: pass "
                    "reference_fasta/--ref or set MODKIT_REF_PATH"
                )
            self._fasta = FastaReader(path)
        seq = bytes(self._fasta.fetch(self.header.tid2name(tid))).upper()
        self._ref_cache[tid] = seq
        return seq

    def _container_meta(self, offset: int):
        """(next_offset, ref, start, span, nrec) from the container header
        only — no block decompression."""
        cur = Cursor(self._data, offset)
        length = int.from_bytes(cur.bytes(4), "little", signed=True)
        ref = cur.itf8()
        start = cur.itf8()
        span = cur.itf8()
        nrec = cur.itf8()
        cur.ltf8()
        cur.ltf8()
        cur.itf8()  # n blocks
        cur.array_itf8()
        cur.bytes(4)
        return cur.pos + length, ref, start, span, nrec

    def _native_decode_container(self, offset: int):
        """Raw BAM record bytes via the native decoder (C++
        gzip/rANS-4x8/bzip2/lzma codecs + slice decode, byte-identical to
        SliceDecoder, incl. multi-reference containers via a lazy ref
        callback); None -> use the Python path (native unavailable or an
        unsupported codec)."""
        from .. import native as _native

        if not _native.available():
            return None
        cur = Cursor(self._data, offset + 4)
        ref = cur.itf8()
        ref_bytes = None
        get_ref = None
        if ref == -2:
            # multi-reference container: per-record RI lookup in C++
            get_ref = self._get_ref
        elif ref >= 0:
            try:
                ref_bytes = self._get_ref(ref)
            except ValueError:
                return None  # no FASTA: python path handles embedded refs
        return _native.cram_decode_container(
            self._data, offset, ref_bytes, self._rg_ids, get_ref=get_ref
        )

    def _decode_all(self) -> list[BamRecord]:
        if self._records is not None:
            return self._records
        pos = self._containers_at
        out: list[BamRecord] = []
        while pos < len(self._data):
            next_pos, ref, _start, _span, nrec = self._container_meta(pos)
            if nrec == 0 and ref == -1:
                break  # EOF container
            if nrec:
                out.extend(self._decode_container_at(pos))
            pos = next_pos
        self._records = out
        return out

    # ---- BamReader-compatible surface ----
    def records(self):
        yield from self._decode_all()

    def has_index(self) -> bool:
        return False  # serial paths engage (sampling, non-indexed pileup)

    def _decode_container_at(self, offset: int) -> list[BamRecord]:
        """Decode one container's records (cached per container offset;
        native decoder first, Python SliceDecoder fallback)."""
        recs = self._container_cache.get(offset)
        if recs is not None:
            return recs
        if len(self._container_cache) > 64:
            self._container_cache.clear()  # bound region-fetch memory
        raws = self._native_decode_container(offset)
        if raws is not None:
            recs = [BamRecord(r) for r in raws]
            self._container_cache[offset] = recs
            return recs
        cur = Cursor(self._data, offset)
        blocks, (ref, start, span, nrec) = self._read_container(cur)
        recs = []
        if nrec:
            comp = CompressionHeader(blocks[0].data)
            i = 1
            while i < len(blocks):
                if blocks[i].content_type != CT_SLICE_HEADER:
                    i += 1
                    continue
                sd = SliceDecoder(
                    comp, blocks[i:], self.header, self._get_ref,
                    rg_ids=self._rg_ids,
                )
                for raw in sd.decode_records():
                    recs.append(BamRecord(raw))
                i += 1 + sd.n_blocks
        self._container_cache[offset] = recs
        return recs

    def fetch(self, tid: int, start: int, end: int):
        if self._records is None and self._crai is not None:
            # indexed path: only containers whose slices overlap the query
            offsets = sorted(
                {
                    e[3]
                    for e in self._crai
                    if e[0] == tid
                    and e[1] - 1 < end
                    and e[1] - 1 + e[2] > start
                }
            )
            for off in offsets:
                for rec in self._decode_container_at(off):
                    if rec.ref_id != tid or rec.is_unmapped:
                        continue
                    if rec.pos < end and rec.reference_end() > start:
                        yield rec
            return
        for rec in self._decode_all():
            if rec.ref_id != tid or rec.is_unmapped:
                continue
            if rec.pos < end and rec.reference_end() > start:
                yield rec

    def fetch_unmapped(self):
        for rec in self._decode_all():
            if rec.ref_id < 0:
                yield rec

    def idxstats(self) -> list[tuple[str, int, int, int]]:
        counts = [[0, 0] for _ in self.header.refs]
        n_no_coor = 0
        for rec in self._decode_all():
            if rec.ref_id < 0:
                n_no_coor += 1
            elif rec.is_unmapped:
                counts[rec.ref_id][1] += 1
            else:
                counts[rec.ref_id][0] += 1
        self._n_no_coor = n_no_coor
        return [
            (r.name, r.length, c[0], c[1])
            for r, c in zip(self.header.refs, counts)
        ]

    def n_no_coor(self) -> int:
        return sum(1 for rec in self._decode_all() if rec.ref_id < 0)


# ------------------------------------------------------------- .crai index

def read_crai(path: str) -> list[tuple[int, int, int, int, int, int]]:
    """Parse a .crai index: gzip'd text lines of
    (seq_id, aln_start, aln_span, container_offset, slice_offset,
    slice_size) — htslib cram_index format (the reference gets indexed
    CRAM seek via htslib, command_utils.rs:212-240)."""
    raw = open(path, "rb").read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    out = []
    for line in raw.decode().splitlines():
        if not line.strip():
            continue
        f = [int(x) for x in line.split("\t")]
        out.append((f[0], f[1], f[2], f[3], f[4], f[5]))
    return out


def build_crai(cram_path: str) -> list[tuple[int, int, int, int, int, int]]:
    """Index a CRAM by container walk: one entry per slice, offsets from
    the container landmarks (byte-compatible with samtools index output;
    tests/test_cram.py compares against the shipped .crai fixtures)."""
    data = open(cram_path, "rb").read()
    if data[:4] != b"CRAM":
        raise ValueError(f"{cram_path}: not a CRAM file")
    cur = Cursor(data, 26)
    entries = []
    first = True
    while cur.pos < len(data):
        cont_off = cur.pos
        length = int.from_bytes(cur.bytes(4), "little", signed=True)
        ref = cur.itf8()
        cur.itf8()  # start
        cur.itf8()  # span
        nrec = cur.itf8()
        cur.ltf8()  # record counter
        cur.ltf8()  # bases
        cur.itf8()  # n_blocks
        landmarks = cur.array_itf8()
        cur.bytes(4)  # crc
        body_start = cur.pos
        if nrec == 0 and ref == -1 and not first:
            break  # EOF container
        if not first and nrec > 0:
            for i, lm in enumerate(landmarks):
                blk = read_block(Cursor(data, body_start + lm))
                sh = Cursor(blk.data)
                s_ref = sh.itf8()
                s_start = sh.itf8()
                s_span = sh.itf8()
                size = (
                    landmarks[i + 1] if i + 1 < len(landmarks) else length
                ) - lm
                entries.append((s_ref, s_start, s_span, cont_off, lm, size))
        cur.pos = body_start + length
        first = False
    return entries


def write_crai(entries, out_path: str) -> None:
    text = "".join("\t".join(str(x) for x in e) + "\n" for e in entries)
    with open(out_path, "wb") as fh:
        fh.write(gzip.compress(text.encode()))


def is_cram(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == b"CRAM"


def open_alignment_reader(path: str, reference_fasta: str | None = None,
                          io_threads: int | None = None):
    """BamReader or CramReader by file magic (the modkit CLI accepts both
    transparently, command_utils.rs:212)."""
    if is_cram(path):
        return CramReader(path, reference_fasta)
    from .bam import BamReader

    return BamReader(path, io_threads=io_threads)
