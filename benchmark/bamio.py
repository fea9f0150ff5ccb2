"""The benchmark's own BGZF, BAM, BAI and FASTA writer, and a small BAM
reader for its tests. Standard library and numpy only.

Formats as the SAM/BAM specification (v1) sets them out: BGZF blocks of at
most 65 280 bytes of data, each a gzip member with the ``BC`` extra field,
and the 28-byte empty block at the end; a BAI with the binning index and
the 16 kb linear index; a FASTA of 60 bases a line with its ``.fai``.
"""

from __future__ import annotations

import struct
import zlib
import numpy as np

BLOCK_DATA = 65280
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
# base codes 0..3 -> BAM 4-bit codes A=1 C=2 G=4 T=8
NIBBLE = np.array([1, 2, 4, 8], dtype=np.uint8)
PSEUDO_BIN = 37450


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_record(name, pos, end, flag, mapq, cigar, seq_codes, qual, mm, ml):
    """One BAM alignment record, its block_size included."""
    l_seq = len(seq_codes)
    nib = NIBBLE[seq_codes]
    if l_seq % 2:
        nib = np.append(nib, np.uint8(0))
    packed = (nib[0::2] << 4) | nib[1::2]
    rname = name.encode() + b"\0"
    aux = (b"MMZ" + mm.encode() + b"\0"
           + b"MLBC" + struct.pack("<I", len(ml)) + ml.tobytes())
    body = (
        struct.pack("<iiBBHHHiiii", 0, pos, len(rname), mapq,
                    reg2bin(pos, end), len(cigar), flag, l_seq, -1, -1, 0)
        + rname + cigar.tobytes() + packed.tobytes() + qual.tobytes() + aux
    )
    return struct.pack("<i", len(body)) + body


def _bgzf_block(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25
    return (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
        + struct.pack("<H", bsize) + cdata
        + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    )


def bam_header(contig: str, length: int) -> bytes:
    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n".encode()
    cname = contig.encode() + b"\0"
    return (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<ii", 1, len(cname)) + cname + struct.pack("<i", length))


def bgzf_compress(data: bytes, level: int = 1) -> tuple[bytes, np.ndarray]:
    """BGZF blocks of ``data`` and each block's start within them (one
    more entry: their total size)."""
    blocks = [_bgzf_block(data[i:i + BLOCK_DATA], level)
              for i in range(0, len(data), BLOCK_DATA)]
    coff = np.zeros(len(blocks) + 1, dtype=np.int64)
    coff[1:] = np.cumsum([len(b) for b in blocks])
    return b"".join(blocks), coff


def voffsets(base: int, coff: np.ndarray, uoff: np.ndarray) -> np.ndarray:
    """Virtual offsets of uncompressed offsets ``uoff`` of data compressed
    by ``bgzf_compress`` into blocks at ``coff``, written at ``base``."""
    return ((base + coff[uoff // BLOCK_DATA]) << 16) | (uoff % BLOCK_DATA)


def write_bai(path, begs, ends, vbeg, vend) -> None:
    bins: dict = {}
    linear = np.zeros(int(ends.max() - 1 >> 14) + 1 if len(ends) else 0,
                      dtype=np.uint64)
    for beg, end, vb, ve in zip(begs.tolist(), ends.tolist(),
                                vbeg.tolist(), vend.tolist()):
        chunks = bins.setdefault(reg2bin(beg, end), [])
        if chunks and chunks[-1][1] == vb:
            chunks[-1][1] = ve
        else:
            chunks.append([vb, ve])
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            if linear[w] == 0:
                linear[w] = vb
    out = [b"BAI\x01", struct.pack("<ii", 1, len(bins) + 1)]
    for b in sorted(bins):
        out.append(struct.pack("<Ii", b, len(bins[b])))
        out.append(np.array(bins[b], dtype="<u8").tobytes())
    out.append(struct.pack("<Ii", PSEUDO_BIN, 2))
    out.append(np.array([vbeg[0], vend[-1], len(begs), 0], dtype="<u8").tobytes())
    out.append(struct.pack("<i", len(linear)))
    out.append(linear.astype("<u8").tobytes())
    out.append(struct.pack("<Q", 0))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def write_fasta(path: str, name: str, seq_ascii: np.ndarray, width: int = 60) -> None:
    n = len(seq_ascii)
    rows = -(-n // width)
    buf = np.full(rows * (width + 1), ord("\n"), dtype=np.uint8)
    grid = buf.reshape(rows, width + 1)
    flat = np.zeros(rows * width, dtype=np.uint8)
    flat[:n] = seq_ascii
    grid[:, :width] = flat.reshape(rows, width)
    body = buf.tobytes()
    if n % width:  # the last line holds n % width bases
        body = body[: (rows - 1) * (width + 1) + n % width] + b"\n"
    head = f">{name}\n".encode()
    with open(path, "wb") as fh:
        fh.write(head + body)
    with open(path + ".fai", "w") as fh:
        fh.write(f"{name}\t{n}\t{len(head)}\t{width}\t{width + 1}\n")


# ---------------------------------------------------------------- reading

def read_bgzf(path: str) -> bytes:
    with open(path, "rb") as fh:
        raw = fh.read()
    out, off = [], 0
    while off < len(raw):
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        out.append(zlib.decompress(raw[off + 18: off + bsize - 8], -15))
        off += bsize
    return b"".join(out)


def read_bam(path: str) -> list[dict]:
    """Every record of a BAM as a dict: name, pos, flag, cigar [(op, len)],
    seq (base codes 0..3 in reference orientation), qual, mm, ml."""
    data = read_bgzf(path)
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM")
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 4 + l_name + 4
    code_of = np.full(16, 255, dtype=np.uint8)
    code_of[[1, 2, 4, 8]] = [0, 1, 2, 3]
    recs = []
    while off < len(data):
        (bsize,) = struct.unpack_from("<i", data, off)
        body = data[off + 4: off + 4 + bsize]
        off += 4 + bsize
        (_, pos, l_name, mapq, _, n_cig, flag, l_seq, _, _, _) = struct.unpack_from(
            "<iiBBHHHiiii", body, 0)
        p = 32
        name = body[p:p + l_name - 1].decode()
        p += l_name
        cig = np.frombuffer(body, dtype="<u4", count=n_cig, offset=p)
        p += 4 * n_cig
        packed = np.frombuffer(body, dtype=np.uint8, count=(l_seq + 1) // 2, offset=p)
        p += (l_seq + 1) // 2
        nib = np.empty(2 * len(packed), dtype=np.uint8)
        nib[0::2] = packed >> 4
        nib[1::2] = packed & 15
        qual = np.frombuffer(body, dtype=np.uint8, count=l_seq, offset=p)
        p += l_seq
        aux = body[p:]
        if aux[:3] != b"MMZ":
            raise ValueError(f"{name}: MM is not the first tag")
        z = aux.index(b"\0", 3)
        mm = aux[3:z].decode()
        q = z + 1
        if aux[q:q + 4] != b"MLBC":
            raise ValueError(f"{name}: ML does not follow MM")
        (n_ml,) = struct.unpack_from("<I", aux, q + 4)
        ml = np.frombuffer(aux, dtype=np.uint8, count=n_ml, offset=q + 8)
        recs.append(dict(
            name=name, pos=pos, flag=flag, mapq=mapq,
            cigar=[(int(c & 15), int(c >> 4)) for c in cig],
            seq=code_of[nib[:l_seq]], qual=qual, mm=mm, ml=ml,
        ))
    return recs
