"""`extract full` / `extract calls`: read-level mod-call tables.

Reference: src/extract/ + ReadBaseModProfile::process_record
(read_ids_to_base_mod_probs.rs:591) and PositionModCalls (:1088), with the
19-column full schema (:400-424) and 21-column calls schema
(extract/writer.rs:13-38).
"""

from __future__ import annotations

import sys

import numpy as np

from ..caller import ThresholdCaller
from ..errors import ErrorTally, ModKitError
from ..io.bam import BamReader
from ..modcodes import DNA_BASES, complement, mod_code_sort_key
from ..modtags import decode_record
from ..collapse import apply_collapse
from ..writers import format_float

FULL_HEADER = (
    "read_id\tforward_read_position\tref_position\tchrom\tmod_strand\t"
    "ref_strand\tref_mod_strand\tfw_soft_clipped_start\tfw_soft_clipped_end\t"
    "read_length\tmod_qual\tmod_code\tbase_qual\tref_kmer\tquery_kmer\t"
    "canonical_base\tmodified_primary_base\tinferred\tflag"
)
CALLS_HEADER = (
    "read_id\tforward_read_position\tref_position\tchrom\tmod_strand\t"
    "ref_strand\tref_mod_strand\tfw_soft_clipped_start\tfw_soft_clipped_end\t"
    "read_length\tcall_prob\tcall_code\tbase_qual\tref_kmer\tquery_kmer\t"
    "canonical_base\tmodified_primary_base\tfail\tinferred\twithin_alignment\t"
    "flag"
)


def kmer_at(seq: np.ndarray, pos: int, size: int, revcomp: bool) -> str:
    """util.rs:750 Kmer::new (+ reverse_complement for '-' mod strand):
    '-' pads positions outside the sequence."""
    before = size // 2 - 1 if size % 2 == 0 else size // 2
    after = size // 2
    out = []
    for off in range(pos - before, pos + after + 1):
        if 0 <= off < len(seq):
            out.append(chr(seq[off]))
        else:
            out.append("-")
    if revcomp:
        comp = {"A": "T", "C": "G", "G": "C", "T": "A", "-": "-"}
        out = [comp.get(c, c) for c in reversed(out)]
    return "".join(out)


def soft_clips(rec) -> tuple[int, int]:
    """Leading/trailing soft-clip lengths in *forward read* orientation
    (read_ids_to_base_mod_probs.rs:804 get_soft_clipped; counting stops at
    the first non-S op from either end)."""
    if rec.is_unmapped:
        return 0, 0
    cg = rec.cigar
    ops = cg & 0xF
    lens = (cg >> 4).astype(np.int64)
    start = 0
    for o, l in zip(ops, lens):
        if o == 4:
            start += int(l)
        else:
            break
    end = 0
    for o, l in zip(ops[::-1], lens[::-1]):
        if o == 4:
            end += int(l)
        else:
            break
    if rec.is_reverse:
        return end, start
    return start, end


class ReadProfile:
    """Per-read row data shared by full and calls modes."""

    def __init__(self, rec, header, collapse=(), edge_filter=None,
                 kmer_size: int = 5):
        info = decode_record(rec)
        self.rec = rec
        self.read_id = rec.name
        self.flag = rec.flag
        self.read_length = rec.l_seq
        self.clip_start, self.clip_end = soft_clips(rec)
        self.chrom = (
            header.tid2name(rec.ref_id) if not rec.is_unmapped else None
        )
        self.aln_strand = (
            None if rec.is_unmapped else ("-" if rec.is_reverse else "+")
        )
        fwd_seq = rec.forward_seq()
        quals = rec.quals()
        self.quals_f = quals[::-1] if rec.is_reverse else quals
        self.fwd_seq = fwd_seq
        self.kmer_size = kmer_size

        if rec.is_unmapped:
            self.ref_map = {}
        else:
            qf, rp = rec.aligned_pairs_forward()
            self.ref_map = dict(zip(qf.tolist(), rp.tolist()))

        # entries: (qpos, base, mod_strand, codes, prob_row, inferred)
        entries = []
        for base, strand, g in info.iter_groups():
            positions, probs, inferred = g.positions, g.probs, g.inferred
            codes = list(g.codes)
            if edge_filter is not None:
                if not edge_filter.read_can_be_trimmed(rec.l_seq):
                    continue
                keep = edge_filter.keep_mask(positions, rec.l_seq)
                if not keep.any():
                    continue
                positions, probs, inferred = (
                    positions[keep], probs[keep], inferred[keep]
                )
            for mth in collapse:
                codes, probs = apply_collapse(codes, probs, mth)
            for i in range(len(positions)):
                entries.append(
                    (int(positions[i]), base, strand, codes, probs[i],
                     bool(inferred[i]))
                )
        rev = rec.is_reverse
        entries.sort(key=lambda e: -e[0] if rev else e[0])
        self.entries = entries
        self.is_primary_or_unmapped = self.flag in (0, 16, 4)

    def within_alignment(self, qpos: int) -> bool:
        hi = self.read_length - self.clip_end
        return self.clip_start <= qpos < hi

    def common_cols(self, qpos: int, mod_strand: int, base: str):
        ref_pos = self.ref_map.get(qpos, -1)
        mod_strand_ch = "+" if mod_strand == 0 else "-"
        if self.aln_strand is None:
            ref_strand = ref_mod_strand = "."
        else:
            ref_strand = self.aln_strand
            flip = (mod_strand == 1) != (ref_strand == "-")
            ref_mod_strand = "-" if flip else "+"
        q = int(self.quals_f[qpos]) if qpos < len(self.quals_f) else 0
        kmer = kmer_at(self.fwd_seq, qpos, self.kmer_size, mod_strand == 1)
        mod_primary = complement(base) if mod_strand == 1 else base
        return ref_pos, mod_strand_ch, ref_strand, ref_mod_strand, q, kmer, mod_primary


def full_rows(
    profile: ReadProfile, ref_seqs: dict | None, keep=None
) -> list[str]:
    rows = []
    chrom = profile.chrom or "."
    for qpos, base, strand, codes, prob_row, inferred in profile.entries:
        if not profile.is_primary_or_unmapped and not profile.within_alignment(qpos):
            continue
        (ref_pos, mod_s, ref_s, ref_ms, q, kmer, mod_primary) = (
            profile.common_cols(qpos, strand, base)
        )
        if keep is not None and not keep(ref_pos, ref_ms):
            continue
        ref_kmer = "."
        if ref_seqs is not None and profile.chrom in ref_seqs and ref_pos >= 0:
            ref_kmer = kmer_at(
                ref_seqs[profile.chrom], ref_pos, profile.kmer_size, False
            )
        for j, code in enumerate(codes):
            p = prob_row[j]
            if p < 0:
                continue
            rows.append(
                f"{profile.read_id}\t{qpos}\t{ref_pos}\t{chrom}\t{mod_s}\t"
                f"{ref_s}\t{ref_ms}\t{profile.clip_start}\t{profile.clip_end}\t"
                f"{profile.read_length}\t{format_float(p)}\t{code}\t{q}\t"
                f"{ref_kmer}\t{kmer}\t{base}\t{mod_primary}\t"
                f"{str(inferred).lower()}\t{profile.flag}\n"
            )
    return rows


def calls_rows(
    profile: ReadProfile,
    caller: ThresholdCaller,
    ref_seqs: dict | None,
    pass_only: bool = False,
    keep=None,
) -> list[str]:
    """One thresholded call per (position, mod strand, base)
    (read_ids_to_base_mod_probs.rs:1088 PositionModCalls::from_profile:
    codes-per-base unioned across the read, absent codes fill 0; inferred
    positions become inferred-canonical over the union)."""
    # observed codes per base across the read's emitted rows
    codes_per_base: dict[str, list] = {}
    for qpos, base, strand, codes, prob_row, inferred in profile.entries:
        if not profile.is_primary_or_unmapped and not profile.within_alignment(qpos):
            continue
        s = codes_per_base.setdefault(base, [])
        for j, c in enumerate(codes):
            if prob_row[j] >= 0 and c not in s:
                s.append(c)
    for b in codes_per_base:
        codes_per_base[b] = sorted(codes_per_base[b], key=mod_code_sort_key)

    rows = []
    chrom = profile.chrom or "."
    for qpos, base, strand, codes, prob_row, inferred in profile.entries:
        if not profile.is_primary_or_unmapped and not profile.within_alignment(qpos):
            continue
        union = codes_per_base.get(base, [])
        # probability map over the union (insertion order = sorted union)
        probs = {}
        if inferred:
            for c in union:
                probs[c] = np.float32(0.0)
        else:
            for j, c in enumerate(codes):
                if prob_row[j] >= 0:
                    probs[c] = np.float32(prob_row[j])
            for c in union:
                if c not in probs:
                    probs[c] = np.float32(0.0)
        call = caller.call(base, probs)
        filtered = call[0] == "filtered"
        if filtered and pass_only:
            continue
        # argmax call for the reported prob/code
        canon = np.float32(1.0) - np.float32(sum(probs.values()))
        best_code, best_p = None, -np.inf
        for c, p in probs.items():
            if p >= best_p:
                best_code, best_p = c, p
        if best_code is None or not (best_p > canon):
            call_prob, call_code = canon, "-"
        else:
            call_prob, call_code = best_p, str(best_code)
        (ref_pos, mod_s, ref_s, ref_ms, q, kmer, mod_primary) = (
            profile.common_cols(qpos, strand, base)
        )
        if keep is not None and not keep(ref_pos, ref_ms):
            continue
        ref_kmer = "."
        if ref_seqs is not None and profile.chrom in ref_seqs and ref_pos >= 0:
            ref_kmer = kmer_at(
                ref_seqs[profile.chrom], ref_pos, profile.kmer_size, False
            )
        within = profile.chrom is not None and profile.within_alignment(qpos)
        rows.append(
            f"{profile.read_id}\t{qpos}\t{ref_pos}\t{chrom}\t{mod_s}\t"
            f"{ref_s}\t{ref_ms}\t{profile.clip_start}\t{profile.clip_end}\t"
            f"{profile.read_length}\t{format_float(call_prob)}\t{call_code}\t"
            f"{q}\t{ref_kmer}\t{kmer}\t{base}\t{mod_primary}\t"
            f"{str(filtered).lower()}\t{str(inferred).lower()}\t"
            f"{str(within).lower()}\t{profile.flag}\n"
        )
    return rows


def _bgzf_block_size(raw: bytes, off: int) -> int:
    """BGZF block size at ``off`` from the BC extra subfield."""
    import struct as _struct

    (xlen,) = _struct.unpack_from("<H", raw, off + 10)
    p, end = off + 12, off + 12 + xlen
    while p + 4 <= end:
        si1, si2, slen = raw[p], raw[p + 1], _struct.unpack_from(
            "<H", raw, p + 2
        )[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return _struct.unpack_from("<H", raw, p + 4)[0] + 1
        p += 4 + slen
    raise ValueError(f"no BC subfield in BGZF block at {off}")


def _shard_voffsets(reader, pcount: int) -> list[int]:
    """Record-aligned virtual offsets splitting the BAM body into
    ``pcount`` compressed-byte-balanced ranges. Split candidates are the
    index's linear-index voffsets (BAI ioffsets / CSI loffsets) — each is
    the voffset of the first record overlapping a genome window, i.e. a
    record boundary."""
    raw_len = len(reader.bam_raw)
    cands = {int(reader._body_voffset)}
    for v in reader.index.linear_voffsets():
        cands.add(int(v))
    ordered = sorted(cands)
    bounds = [int(reader._body_voffset)]
    for p in range(1, pcount):
        target = raw_len * p // pcount
        best = None
        for v in ordered:
            if v <= bounds[-1]:
                continue
            if best is None or abs((v >> 16) - target) < abs(
                (best >> 16) - target
            ):
                best = v
        bounds.append(best if best is not None else bounds[-1])
    bounds.append(raw_len << 16)
    # drop duplicate split points (tiny files): ranks with an empty range
    # produce empty shards, which concatenate harmlessly
    return bounds


def run_extract(
    in_bam: str,
    out,
    mode: str = "full",
    collapse=(),
    edge_filter=None,
    kmer_size: int = 5,
    reference_fasta: str | None = None,
    caller: ThresholdCaller | None = None,
    pass_only: bool = False,
    mapped_only: bool = False,
    num_reads: int | None = None,
    region: str | None = None,
    allow_non_primary: bool = False,
    include_header: bool = True,
    bgzf: bool = False,
    threads: int = 4,
    include_bed: str | None = None,
    exclude_bed: str | None = None,
    motifs: list | None = None,
    cpg: bool = False,
    queue_size: int = 1000,
    ignore_implicit: bool = False,
    out_threads: int = 4,
) -> dict:
    from ..io.cram import open_alignment_reader

    reader = open_alignment_reader(in_bam, reference_fasta)
    ref_seqs = None
    if reference_fasta is not None:
        from ..io.fasta import FastaReader

        fa = FastaReader(reference_fasta)
        ref_seqs = {
            name: fa.fetch(name)
            for name in fa.names()
            if name in reader.header.name_to_tid
        }
    errors = ErrorTally()
    from ..parallel.devices import maybe_init_distributed, process_info

    maybe_init_distributed()
    pidx, pcount = process_info()
    shard_mode = pcount > 1
    close = False
    if shard_mode:
        fh = None  # ranks write shards; rank 0 concatenates at the end
    elif isinstance(out, str):
        if out in ("-", "stdout"):
            fh = sys.stdout
        elif bgzf:
            # parallel-bgzf-compressed TSV (extract/subcommand.rs:270 --bgzf)
            from ..io.bgzf import BgzfTextWriter

            # --out-threads: parallel bgzf writer threads
            # (extract/subcommand.rs:98,274 out_threads)
            fh = BgzfTextWriter(out, threads=out_threads)
            close = True
        else:
            fh = open(out, "w")
            close = True
    else:
        fh = out
    # --include-bed / --exclude-bed position masks on the reference mod
    # strand (extract/util.rs:44 ReferencePositionFilter::keep); with an
    # include mask, unaligned positions drop
    include_filter = exclude_filter = None
    if include_bed or exclude_bed:
        from ..position_filter import StrandedPositionFilter

        chrom_to_tid = dict(reader.header.name_to_tid)
        if include_bed:
            include_filter = StrandedPositionFilter.from_bed_file(
                include_bed, chrom_to_tid
            )
        if exclude_bed:
            exclude_filter = StrandedPositionFilter.from_bed_file(
                exclude_bed, chrom_to_tid
            )

    # --motif/--cpg: restrict rows to reference motif focus positions
    # (extract/util.rs:126 load_regions motif-position intersection)
    motif_sets = None  # {tid: (plus_pos_set, minus_pos_set)}
    if motifs or cpg:
        from ..io.fasta import FastaReader
        from ..motifs import parse_motifs

        if reference_fasta is None:
            raise ValueError("--motif/--cpg requires --reference")
        ms = parse_motifs(list(motifs or []), cpg)
        fa = FastaReader(reference_fasta)
        motif_sets = {}
        for name in fa.names():
            tid = reader.header.name_to_tid.get(name)
            if tid is None:
                continue
            seq = fa.fetch(name)
            plus: set = set()
            minus: set = set()
            for m in ms:
                for pos, strand in m.find_hits(seq):
                    (plus if strand == 0 else minus).add(pos)
            motif_sets[tid] = (plus, minus)

    def make_keep(rec):
        if (
            include_filter is None
            and exclude_filter is None
            and motif_sets is None
        ):
            return None
        tid = rec.ref_id
        include_unaligned = include_filter is None and motif_sets is None

        def keep(ref_pos: int, ref_mod_strand: str) -> bool:
            if ref_pos < 0 or tid < 0 or ref_mod_strand == ".":
                return include_unaligned
            s = 0 if ref_mod_strand == "+" else 1
            if motif_sets is not None:
                sets = motif_sets.get(tid)
                if sets is None or ref_pos not in sets[s]:
                    return False
            if include_filter is not None and not bool(
                include_filter.contains(tid, np.array([ref_pos]), s)[0]
            ):
                return False
            if exclude_filter is not None and bool(
                exclude_filter.contains(tid, np.array([ref_pos]), s)[0]
            ):
                return False
            return True

        return keep

    # multi-host: ranks own record-aligned compressed byte ranges (split
    # points = BAI/CSI linear-index voffsets nearest the even byte splits);
    # shard outputs concatenate in rank order, byte-identical to the
    # single-host stream (SURVEY §2.5 first-class multi-host; the
    # reference's guidance is manual region sharding)
    if shard_mode:
        from .. import native as _native

        if not (
            mode in ("full", "calls")
            and num_reads is None
            and region is None
            and include_filter is None
            and exclude_filter is None
            and motif_sets is None
            and hasattr(reader, "bam_raw")
            and reader.has_index()
            and isinstance(out, str)
            and out not in ("-", "stdout")
            and _native.available()
        ):
            raise ValueError(
                "multi-host extract requires the native whole-file "
                "streaming path (no region/position filters) and a file "
                "output path"
            )

    n_reads = 0
    if not shard_mode and include_header:
        fh.write((FULL_HEADER if mode == "full" else CALLS_HEADER) + "\n")

    if shard_mode:
        import os as _os

        from ..parallel.devices import shard_path

        raw = reader.bam_raw
        bounds = _shard_voffsets(reader, pcount)
        lo, hi = bounds[pidx], bounds[pidx + 1]
        c_lo, u_lo = lo >> 16, lo & 0xFFFF
        c_hi, u_hi = hi >> 16, hi & 0xFFFF
        empty_range = hi <= lo
        spath = shard_path(out, pidx)
        if bgzf:
            from ..io.bgzf import BgzfTextWriter

            sfh = BgzfTextWriter(spath, threads=out_threads)
        else:
            sfh = open(spath, "w")
        if include_header and pidx == 0:
            sfh.write(
                (FULL_HEADER if mode == "full" else CALLS_HEADER) + "\n"
            )
        if pidx == 0:
            start_off, init_carry, parse_hdr = 0, b"", True
        else:
            bsz = _bgzf_block_size(raw, c_lo)
            blk = reader._bgzf.read_span(lo, ((c_lo + bsz) << 16))
            start_off, init_carry, parse_hdr = c_lo + bsz, bytes(blk), False
        tail = b""
        if u_hi > 0 and not empty_range:
            tail = bytes(reader._bgzf.read_span(c_hi << 16, hi))
        tid_names = [r.name for r in reader.header.refs]
        stream = () if empty_range else _native.extract_full_stream(
            raw, tid_names,
            ref_seqs=ref_seqs, kmer_size=kmer_size,
            mapped_only=mapped_only,
            allow_non_primary=allow_non_primary,
            edge_filter=edge_filter,
            collapse=list(collapse) if collapse else None,
            caller=(
                (caller or ThresholdCaller.passthrough())
                if mode == "calls"
                else None
            ),
            pass_only=pass_only,
            ignore_implicit=ignore_implicit,
            n_threads=max(1, min(threads, _os.cpu_count() or 1)),
            start_off=start_off, end_off=c_hi, init_carry=init_carry,
            parse_header=parse_hdr, tail_data=tail,
        )
        for text, nr, errs in stream:
            sfh.write(text.decode("ascii"))
            n_reads += nr
            for k, v in errs.items():
                errors[k] += v
        sfh.close()
        from ..parallel.devices import sync_processes

        sync_processes("modkit_extract_shards")
        if pidx == 0:
            with open(out, "wb") as o:
                for r_i in range(pcount):
                    sp = shard_path(out, r_i)
                    with open(sp, "rb") as src:
                        while True:
                            chunk = src.read(1 << 20)
                            if not chunk:
                                break
                            o.write(chunk)
                    _os.remove(sp)
        return dict(reads=n_reads, errors=dict(errors))

    # native streaming fast path: whole-file `extract full`/`calls` with
    # no position filters decodes + formats in C++ spans (native
    # mk_extract_span; byte-identical to full_rows/calls_rows —
    # tests/test_native_extract.py)
    if (
        mode in ("full", "calls")
        and num_reads is None
        and region is None
        and include_filter is None
        and exclude_filter is None
        and motif_sets is None
        and hasattr(reader, "bam_raw")
    ):
        from .. import native as _native

        if _native.available():
            import os as _os

            from ..logging import ProgressTicker

            def _write_bytes(b):
                buf = getattr(fh, "buffer", None)
                if buf is not None:
                    fh.flush()
                    buf.write(b)
                else:
                    fh.write(b.decode("ascii"))

            ticker = ProgressTicker(
                "processing reads:", suppress=fh is sys.stdout
            )
            tid_names = [r.name for r in reader.header.refs]
            stream = _native.extract_full_stream(
                reader.bam_raw,
                tid_names,
                ref_seqs=ref_seqs,
                kmer_size=kmer_size,
                mapped_only=mapped_only,
                allow_non_primary=allow_non_primary,
                edge_filter=edge_filter,
                collapse=list(collapse) if collapse else None,
                caller=(
                    (caller or ThresholdCaller.passthrough())
                    if mode == "calls"
                    else None
                ),
                pass_only=pass_only,
                ignore_implicit=ignore_implicit,
                n_threads=max(1, min(threads, _os.cpu_count() or 1)),
            )
            # one-slot prefetch: the next span decodes+formats natively
            # (GIL released in ctypes) while this span's ~8 MB of rows
            # stream to disk — write and compute overlap, matching the
            # reference's compute->bounded-channel->writer pipeline
            # (extract/subcommand.rs:135)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(1) as _pool:
                fut = _pool.submit(next, stream, None)
                while True:
                    item = fut.result()
                    if item is None:
                        break
                    fut = _pool.submit(next, stream, None)
                    text, nr, errs = item
                    _write_bytes(text)
                    n_reads += nr
                    for k, v in errs.items():
                        errors[k] += v
                    ticker.update(reads=n_reads)
            ticker.finish(reads=n_reads)
            if close:
                fh.close()
            return dict(reads=n_reads, errors=dict(errors))

    if region is not None:
        from ..pileup.runner import parse_region

        tid, start, end = parse_region(region, reader.header)
        records = reader.fetch(tid, start, end)
    else:
        records = reader.records()
    # each record is visited exactly once; the reference's prev_end dedup
    # exists only because its interval fan-out can fetch a record twice
    # (extract/util.rs:329). Row generation runs on a worker pool with a
    # bounded FIFO of in-flight records (the analog of the reference's
    # bounded channel + queue gauge, extract/subcommand.rs:135 and
    # util.rs:346-349 --queue-size); the writer drains in submit order so
    # output stays record-ordered.
    def produce(rec):
        try:
            profile = ReadProfile(
                rec, reader.header, collapse, edge_filter, kmer_size
            )
        except ModKitError as e:
            return e
        if ignore_implicit:
            # --ignore-implicit: drop inferred-canonical positions before
            # row/union derivation (read_ids_to_base_mod_probs.rs:765
            # remove_inferred)
            profile.entries = [e for e in profile.entries if not e[5]]
        if mode == "full":
            return full_rows(profile, ref_seqs, keep=make_keep(rec))
        return calls_rows(
            profile, caller or ThresholdCaller.passthrough(), ref_seqs,
            pass_only, keep=make_keep(rec),
        )

    def want(rec):
        if not allow_non_primary and rec.is_not_primary:
            return False
        if mapped_only and rec.is_unmapped:
            return False
        return True

    import os as _os

    from ..logging import ProgressTicker

    # reads processed + live queue depth (the reference's queue gauge,
    # extract/util.rs:346-349)
    ticker = ProgressTicker("processing reads:", suppress=fh is sys.stdout)
    n_workers = max(1, min(threads, _os.cpu_count() or 1))
    if n_workers > 1 and num_reads is None:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(n_workers)
        inflight: deque = deque()
        n_inflight = max(queue_size, n_workers + 1)

        def drain_one():
            nonlocal n_reads
            res = inflight.popleft().result()
            if isinstance(res, ModKitError):
                errors.add(res)
            else:
                fh.writelines(res)
                n_reads += 1
            ticker.update(reads=n_reads, queue=len(inflight))

        try:
            for rec in records:
                if not want(rec):
                    continue
                inflight.append(pool.submit(produce, rec))
                if len(inflight) > n_inflight:
                    drain_one()
            while inflight:
                drain_one()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
    else:
        for rec in records:
            if num_reads is not None and n_reads >= num_reads:
                break
            if not want(rec):
                continue
            res = produce(rec)
            if isinstance(res, ModKitError):
                errors.add(res)
                continue
            fh.writelines(res)
            n_reads += 1
            ticker.update(reads=n_reads)
    ticker.finish(reads=n_reads)
    if close:
        fh.close()
    return dict(reads=n_reads, errors=dict(errors))
