"""Write a synthetic modBAM as a CRAM 3.0 file, with its ``.crai`` index.

Input tooling for the tests and ``chip_smoke.py``: it converts a modBAM
that ``utils/synth.make_synthetic_modbam`` (or ``utils/synth_codes``)
wrote, with the FASTA its reads were drawn from, into a CRAM that the
port's ``io/cram.CramReader`` reads back to the same records. It is not a
general CRAM encoder:

- every record must be a full reference match: mapped, one ``{len}M``
  CIGAR, its bases equal to the FASTA's (so each record stores no read
  feature, ``FN = 0``, and its sequence comes from the reference,
  ``RR = 1``); anything else raises;
- each container holds records of one reference, at most
  ``records_per_container`` of them, in one slice;
- the aux tags other than ``NM``/``MD`` (which the decoder derives from
  the reference) are stored in the tag dictionary, each value as its BAM
  aux value bytes through a BYTE_ARRAY_LEN encoding; read names, flags,
  positions, qualities and the other data series go to EXTERNAL blocks;
- blocks are gzip-compressed, and every block and container carries its
  CRC32 (CRAM 3.0 §8-9); the file ends with the standard EOF container.

The wire format (ITF8/LTF8 integers, blocks, the compression header) is
that of CRAM 3.0 as ``io/cram.py`` parses it. Run as a script:

    python -m modkit_tpu_torch.utils.synth_cram in.bam ref.fa out.cram
"""

from __future__ import annotations

import gzip
import struct
import sys
import zlib

from ..io.bam import BamReader
from ..io.cram import build_crai, write_crai
from ..io.fasta import FastaReader

RAW, GZIP = 0, 1
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5

# the standard CRAM 3.0 end-of-file container (CRAM 3.0 §9)
EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe0454f46000000000100"
    "05bdd94f0001000606010001000100ee63014b"
)

# data series and the EXTERNAL content id each is written to
SERIES = (b"BF", b"CF", b"RL", b"AP", b"RG", b"RN", b"TL", b"FN", b"MQ",
          b"QS")
_CID = {k: i + 1 for i, k in enumerate(SERIES)}
# tags the decoder derives from the reference: never stored
DERIVED_TAGS = ("NM", "MD")


def itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def ltf8(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    return b"\xff" + (v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big")


def _array(vals) -> bytes:
    return itf8(len(vals)) + b"".join(itf8(v) for v in vals)


def _block(method: int, ctype: int, cid: int, raw: bytes) -> bytes:
    payload = gzip.compress(raw, 6, mtime=0) if method == GZIP else raw
    head = (bytes([method, ctype]) + itf8(cid) + itf8(len(payload))
            + itf8(len(raw)))
    body = head + payload
    return body + struct.pack("<I", zlib.crc32(body))


def _container(ref: int, start: int, span: int, nrec: int, counter: int,
               bases: int, blocks: list, landmarks: list) -> bytes:
    body = b"".join(blocks)
    head = (struct.pack("<i", len(body)) + itf8(ref) + itf8(start)
            + itf8(span) + itf8(nrec) + ltf8(counter) + ltf8(bases)
            + itf8(len(blocks)) + _array(landmarks))
    return head + struct.pack("<I", zlib.crc32(head)) + body


def _encoding(codec: int, params: bytes) -> bytes:
    return itf8(codec) + itf8(len(params)) + params


def _external(cid: int) -> bytes:
    return _encoding(1, itf8(cid))


def _compression_header(tag_lines: list, tag_cids: dict) -> bytes:
    """Preservation map (names kept, absolute positions, reference
    required, the tag dictionary), data series encodings and tag
    encodings."""
    td = b"".join(b"".join(line) + b"\x00" for line in tag_lines)
    pm = (b"RN\x01" + b"AP\x00" + b"RR\x01"
          + b"TD" + itf8(len(td)) + td)
    pm = itf8(4) + pm
    sr = b""
    for key in SERIES:
        if key == b"RN":
            sr += key + _encoding(5, b"\t" + itf8(_CID[key]))
        else:
            sr += key + _external(_CID[key])
    sr = itf8(len(SERIES)) + sr
    te = itf8(len(tag_cids))
    for key, (len_cid, val_cid) in tag_cids.items():
        num = (key[0] << 16) | (key[1] << 8) | key[2]
        te += itf8(num) + _encoding(
            4, _external(len_cid) + _external(val_cid))
    return b"".join(itf8(len(x)) + x for x in (pm, sr, te))


def _slice_container(recs: list, ref_seq: bytes, tid: int,
                     counter: int) -> bytes:
    streams = {k: bytearray() for k in SERIES}
    tag_lines: list = []
    line_index: dict = {}
    tag_vals: dict = {}
    bases = 0
    for rec in recs:
        raw = rec.raw()
        cig = rec.cigar
        n = rec.l_seq
        if (rec.is_unmapped or rec.ref_id != tid or len(cig) != 1
                or int(cig[0]) != (n << 4) or n == 0
                or rec.seq_bytes().tobytes()
                != ref_seq[rec.pos:rec.pos + n]):
            raise ValueError(
                f"record {rec.name} is not a full reference match; this "
                "writer stores no read features")
        if "\t" in rec.name:
            raise ValueError(f"read name {rec.name!r} holds a tab")
        # each value exactly as BAM stores it (a B array with its subtype
        # and count, a Z string with its NUL)
        tags = [(raw[a:a + 3], raw[a + 3:b]) for tag, a, b in rec.aux_spans()
                if tag not in DERIVED_TAGS]
        line = tuple(k for k, _ in tags)
        tl = line_index.get(line)
        if tl is None:
            tl = line_index[line] = len(tag_lines)
            tag_lines.append(line)
        s = streams
        s[b"BF"] += itf8(rec.flag)
        s[b"CF"] += itf8(1)  # qualities stored as an array
        s[b"RL"] += itf8(n)
        s[b"AP"] += itf8(rec.pos + 1)
        s[b"RG"] += itf8(-1)
        s[b"RN"] += rec.name.encode() + b"\t"
        s[b"TL"] += itf8(tl)
        s[b"FN"] += itf8(0)
        s[b"MQ"] += itf8(rec.mapq)
        s[b"QS"] += rec.quals().tobytes()
        for key, val in tags:
            lens, vals = tag_vals.setdefault(key, (bytearray(), bytearray()))
            lens += itf8(len(val))
            vals += val
        bases += n
    tag_cids = {}
    for key in tag_vals:
        base = len(SERIES) + 1 + 2 * len(tag_cids)
        tag_cids[key] = (base, base + 1)
    comp = _block(GZIP, CT_COMPRESSION_HEADER, 0,
                  _compression_header(tag_lines, tag_cids))
    ext = [(cid, bytes(streams[k])) for k, cid in _CID.items()]
    for key, (len_cid, val_cid) in tag_cids.items():
        lens, vals = tag_vals[key]
        ext += [(len_cid, bytes(lens)), (val_cid, bytes(vals))]
    start = min(r.pos for r in recs)
    span = max(r.pos + r.l_seq for r in recs) - start
    slice_head = (itf8(tid) + itf8(start + 1) + itf8(span)
                  + itf8(len(recs)) + ltf8(counter) + itf8(1 + len(ext))
                  + _array([cid for cid, _ in ext]) + itf8(-1)
                  + b"\x00" * 16)
    slice_blocks = [_block(GZIP, CT_SLICE_HEADER, 0, slice_head),
                    _block(RAW, CT_CORE, 0, b"")]
    slice_blocks += [_block(GZIP, CT_EXTERNAL, cid, data)
                     for cid, data in ext]
    return _container(tid, start + 1, span, len(recs), counter, bases,
                      [comp] + slice_blocks, [len(comp)])


def write_cram(bam_path: str, fasta_path: str, cram_path: str,
               records_per_container: int = 1000) -> dict:
    """Write the records of the coordinate-sorted ``bam_path`` as the CRAM
    3.0 file ``cram_path`` against ``fasta_path``, and its index
    ``cram_path + ".crai"``; returns summary stats."""
    reader = BamReader(bam_path)
    header = reader.header
    fasta = FastaReader(fasta_path)
    text = header.text
    hdr_block = _block(RAW, CT_FILE_HEADER, 0,
                       struct.pack("<i", len(text)) + text.encode())
    out = [b"CRAM\x03\x00" + b"\x00" * 20,
           _container(0, 0, 0, 0, 0, 0, [hdr_block], [0])]
    ref_seqs: dict = {}
    batch: list = []
    counter = n_containers = 0

    def flush():
        nonlocal counter, n_containers
        tid = batch[0].ref_id
        if tid not in ref_seqs:
            ref_seqs.clear()
            ref_seqs[tid] = bytes(
                fasta.fetch(header.tid2name(tid))).upper()
        out.append(_slice_container(batch, ref_seqs[tid], tid, counter))
        counter += len(batch)
        n_containers += 1
        batch.clear()

    for rec in reader.records():
        if batch and (rec.ref_id != batch[0].ref_id
                      or len(batch) >= records_per_container):
            flush()
        batch.append(rec)
    if batch:
        flush()
    out.append(EOF_CONTAINER)
    with open(cram_path, "wb") as fh:
        for part in out:
            fh.write(part)
    write_crai(build_crai(cram_path), cram_path + ".crai")
    return dict(n_records=counter, n_containers=n_containers)


if __name__ == "__main__":
    if len(sys.argv) != 4:
        raise SystemExit(
            "usage: python -m modkit_tpu_torch.utils.synth_cram "
            "in.bam ref.fa out.cram")
    print(write_cram(*sys.argv[1:]))
