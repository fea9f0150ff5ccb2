"""Pass-threshold estimation: read sampling + percentile of call confidences.

Mirrors the reference pipeline (reads_sampler/mod.rs:30
get_sampled_read_ids_to_base_mod_probs -> read_ids_to_base_mod_probs.rs:67
mle_probs_per_base -> thresholds.rs:82 calc_thresholds_per_base):

1. Sample reads (count quota proportional to per-contig mapped counts from
   the index, or per-read Bernoulli for --sampling-frac; unmapped tail when
   not only_mapped).
2. Per read, per (threshold base = tag base, complemented for '-' mod
   strand), per position: the argmax call confidence — the max mod
   probability if it strictly exceeds the canonical probability, else the
   canonical probability (mod_bam.rs:489 argmax_base_mod_call).
3. Per base: sort + linear-interpolated percentile (thresholds.rs:17), all
   arithmetic in f32 to match the reference exactly.
"""

from __future__ import annotations

import numpy as np

from .errors import ModKitError
from .modcodes import DNA_BASES, DNA_IDX_COMPLEMENT, DNA_BASE_IDX
from .modtags import decode_record


def percentile_linear_interp(xs: np.ndarray, q: float) -> np.float32:
    """Sorted linear-interpolated percentile (thresholds.rs:17), f32 math."""
    n = len(xs)
    if n < 2:
        raise ModKitError(
            "percentile-not-enough-datapoints",
            f"need at least 2 data points, have {n}",
        )
    q = np.float32(q)
    if q > np.float32(1.0):
        raise ModKitError("percentile-invalid-quantile", str(q))
    if q == np.float32(1.0):
        return np.float32(xs[-1])
    l = np.float32(n - 1)
    t = l * q
    left = int(np.floor(t))
    right = int(np.ceil(t))
    g = t - np.float32(np.floor(t))
    y0 = np.float32(xs[left])
    y1 = np.float32(xs[right])
    return y0 * (np.float32(1.0) - g) + y1 * g


# threshold sorts run on a CUDA device: none, since every estimate sorts
# on the host (benchmark/run.py's launch counters read it)
CUDA_SORTS = 0


class Percentiles:
    """thresholds.rs:40 — percentile table for sample-probs."""

    def __init__(self, probs: np.ndarray, qs: list[float]):
        s = np.sort(probs.astype(np.float32))
        self.qs = [(q, float(percentile_linear_interp(s, q))) for q in qs]

    def report(self) -> str:
        out = ["q\tp"]
        for q, p in self.qs:
            out.append(f"{q:.2f}\t{p:.3f}")
        return "\n".join(out) + "\n"


def read_groups(
    rec,
    only_mapped: bool,
    collapse=None,
    edge_filter=None,
    position_filter=None,
) -> dict[int, list]:
    """Sampled probability groups for one read, keyed by threshold base.

    Returns {base_idx: [(codes, probs[n, m]), ...]}. Raises ModKitError on
    undecodable tags. ``position_filter`` keeps only positions whose
    reference position lies in the BED filter on the
    (mod_strand XOR is_reverse) strand (read_ids_to_base_mod_probs.rs:966
    filter_positions).
    """
    from .collapse import apply_collapse

    info = decode_record(rec)
    if only_mapped or position_filter is not None:
        qf, rp = rec.aligned_pairs_forward()
        order = np.argsort(qf, kind="stable")
        qf_sorted, rp_sorted = qf[order], rp[order]
    out: dict[int, list] = {}
    aln_rev = 1 if rec.is_reverse else 0
    for base, strand, g in info.iter_groups():
        positions, probs = g.positions, g.probs
        if edge_filter is not None:
            if not edge_filter.read_can_be_trimmed(rec.l_seq):
                continue
            keep = edge_filter.keep_mask(positions, rec.l_seq)
            if not keep.any():
                continue
            positions, probs = positions[keep], probs[keep]
        if only_mapped or position_filter is not None:
            idx = np.searchsorted(qf_sorted, positions)
            inb = idx < len(qf_sorted)
            idxc = np.clip(idx, 0, max(len(qf_sorted) - 1, 0))
            aligned = inb & (qf_sorted[idxc] == positions)
            if position_filter is not None:
                ref_strand = aln_rev ^ strand
                ref_pos = np.where(aligned, rp_sorted[idxc], -1)
                in_bed = np.zeros(len(positions), dtype=bool)
                if aligned.any():
                    in_bed[aligned] = position_filter.contains(
                        rec.ref_id, ref_pos[aligned], ref_strand
                    )
                # unaligned positions fail the position filter
                # (filter_positions unwrap_or(false))
                keep = aligned & in_bed
            else:
                keep = aligned
            if not keep.any():
                continue
            positions, probs = positions[keep], probs[keep]
        codes = list(g.codes)
        if collapse:
            for mth in collapse:
                codes, probs = apply_collapse(codes, probs, mth)
        b = DNA_BASE_IDX[base]
        tb = b if strand == 0 else DNA_IDX_COMPLEMENT[b]
        out.setdefault(tb, []).append((codes, probs))
    return out


def group_confidences(groups: list) -> np.ndarray:
    """argmax call confidences for [(codes, probs), ...] of one base
    (mod_bam.rs:489 argmax_base_mod_call: mod wins only if strictly greater
    than canonical)."""
    confs = []
    for _codes, probs in groups:
        live = np.where(probs >= 0, probs, np.float32(0))
        canon = np.float32(1.0) - live.sum(axis=1, dtype=np.float32)
        best_mod = (
            np.where(probs >= 0, probs, -np.inf).max(axis=1)
            if probs.shape[1]
            else np.full(len(probs), -np.inf, dtype=np.float32)
        )
        confs.append(
            np.where(best_mod > canon, best_mod, canon).astype(np.float32)
        )
    return (
        np.concatenate(confs) if confs else np.empty(0, dtype=np.float32)
    )


def _count_quota_schedule(
    num_reads: int,
    mapped_per_tid: dict[int, int],
    unmapped_count: int,
    include_unmapped: bool,
) -> dict[int, int]:
    """Per-contig read quotas proportional to index mapped counts
    (sampling_schedule.rs:171 from_num_reads): quota = min(ceil(num_reads *
    contig_frac), contig_count), then low-count contigs are pruned while the
    scheduled total exceeds 1.5x the request (:225-247 floor loop; the
    recomputed total intentionally drops the unmapped share, mirroring the
    reference)."""
    f32 = np.float32
    total = sum(mapped_per_tid.values())
    if include_unmapped:
        total += unmapped_count
    if total <= 0 or num_reads <= 0:
        return {}
    quotas: dict[int, int] = {}
    total_to_sample = 0
    for tid, n in mapped_per_tid.items():
        if n <= 0:
            continue
        q = min(int(np.ceil(f32(num_reads) * (f32(n) / f32(total)))), n)
        quotas[tid] = q
        total_to_sample += q
    if include_unmapped and unmapped_count > 0:
        total_to_sample += int(
            np.ceil(f32(num_reads) * (f32(unmapped_count) / f32(total)))
        )
    floor = 1
    while total_to_sample / num_reads > 1.5:
        for tid in quotas:
            if 0 < quotas[tid] <= floor:
                total_to_sample -= quotas[tid]
                quotas[tid] = 0
            if total_to_sample <= num_reads:
                break
        total_to_sample = sum(quotas.values())
        floor += 1
    return {t: q for t, q in quotas.items() if q > 0}


def sample_reads(
    reader,
    num_reads: int | None,
    sample_frac: float | None,
    seed: int | None,
    include_unmapped: bool,
    region: str | None = None,
    collapse=None,
    edge_filter=None,
    force_allow: bool = False,
    interval_size: int = 1_000_000,
    position_filter=None,
    only_mapped: bool | None = None,
    confidences_only: bool = False,
) -> dict:
    """Sample reads; returns {read_name: {base_idx: [(codes, probs)]}}.

    Count-quota mode allocates per-contig quotas proportional to index
    mapped-read counts (sampling_schedule.rs:171 from_num_reads) and fans
    out over genome intervals with per-batch remaining-quota accounting
    (:440 accumulate_sample_counts), so sampled reads spread evenly across
    each contig instead of clustering at its start. Fraction mode is
    per-read Bernoulli with optional seed (record_sampler.rs:29); the
    probability is ``sample_frac`` for every read — deliberately NOT the
    reference's per-interval ``sample_frac * interval_len/contig_len``
    scaling (:527,:476), which vanishes at WGS scale.
    """
    if only_mapped is None:
        only_mapped = not include_unmapped
    rng = np.random.default_rng(seed) if seed is not None else np.random.default_rng()
    sampled: dict[str, dict[int, list]] = {}
    seen: set[str] = set()

    def use_record(rec) -> bool:
        if rec.is_not_primary:
            return False
        if only_mapped and rec.is_unmapped:
            return False
        return True

    use_native = position_filter is None
    if use_native:
        from . import native as _native

        use_native = _native.available()

    # confidences-only mode (threshold estimation): records batch through
    # ONE native call per chunk that decodes and emits only the pooled
    # argmax confidences — no per-read ctypes round trips or group
    # marshalling (native mk_sample_confidences)
    conf_mode = confidences_only and use_native
    conf_parts: list = []
    pending: list = []

    def flush_pending() -> int:
        """Decode the pending chunk in one native call, applying add()'s
        seen/quota semantics record by record in order; confidences of
        duplicate-name or groupless records are dropped."""
        if not pending:
            return 0
        status, conf, tb, rec_idx = _native.sample_confidences_batch(
            [rec.raw() for rec in pending],
            [
                1 if (only_mapped and not rec.is_unmapped) else 0
                for rec in pending
            ],
            collapse=collapse,
            edge_filter=edge_filter,
        )
        consumed = 0
        keep = np.zeros(len(pending), dtype=bool)
        for i, rec in enumerate(pending):
            if rec.name in seen:
                consumed += 1
                continue
            if status[i]:
                seen.add(rec.name)
                keep[i] = True
                consumed += 1
        mask = keep[rec_idx]
        conf_parts.append((tb[mask], conf[mask]))
        pending.clear()
        return consumed

    def add(rec) -> bool:
        """Decode + stash one read; True if it consumes sampling quota.

        A read already seen (fetched again by an overlapping interval)
        still consumes quota — the reference's per-interval RecordSampler
        commits its token before the Moniod merge dedups by read id
        (record_sampler.rs:72, reads_sampler/mod.rs:246)."""
        if rec.name in seen:
            return True
        try:
            if use_native:
                per_base = _native.read_groups(
                    rec.raw(), only_mapped and not rec.is_unmapped,
                    collapse, edge_filter,
                )
            else:
                per_base = read_groups(
                    rec, only_mapped and not rec.is_unmapped, collapse,
                    edge_filter,
                    position_filter if not rec.is_unmapped else None,
                )
        except ModKitError:
            return False
        if not per_base:
            return False
        seen.add(rec.name)
        sampled[rec.name] = per_base
        return True

    # mapped phase
    if region is not None:
        from .pileup.runner import parse_region

        tid, start, end = parse_region(region, reader.header)
        spans = [(tid, start, end)]
    else:
        spans = [
            (tid, 0, r.length) for tid, r in enumerate(reader.header.refs)
        ]

    if reader.has_index():
        stats = reader.idxstats()
        mapped_per_tid = {tid: stats[tid][2] for tid, _, _ in spans}
        unmapped_tail = reader.n_no_coor()
        quotas = (
            _count_quota_schedule(
                num_reads, mapped_per_tid, unmapped_tail,
                include_unmapped=not only_mapped,
            )
            if num_reads is not None
            else None
        )
        for tid, start, end in spans:
            if mapped_per_tid.get(tid, 0) == 0:
                continue
            quota = quotas.get(tid, 0) if quotas is not None else None
            if quota == 0 and quotas is not None:
                continue  # pruned by the schedule
            # the proportional denominator is the span being sampled (the
            # full contig, or the --region slice: the reference feeder
            # passes the region's total_interval_length,
            # sampling_schedule.rs:418-431)
            contig_len = end - start
            # interval fan-out with proportional per-interval draws
            # (sampling_schedule.rs:440 accumulate_sample_counts): each
            # interval draws ceil(quota * len/contig_len) reads, and
            # consecutive intervals merge until the draw reaches the
            # min-reads-per-query floor of 50 (:447,:534-560 slack merge),
            # spreading the sample across the whole contig
            regions: list[tuple[int, int, int | None]] = []
            if quota is None:
                regions.append((start, end, None))
            else:
                pos = start
                pend_s: int | None = None
                pend_x = 0
                while pos < end:
                    e = min(pos + interval_size, end)
                    f = np.float32(e - pos) / np.float32(contig_len)
                    if pend_s is None:
                        pend_s = pos
                    pend_x += int(np.ceil(np.float32(quota) * f))
                    pos = e
                    if pend_x >= 50 or pos >= end:
                        regions.append((pend_s, pos, pend_x))
                        pend_s, pend_x = None, 0
            # fully-native region sampling: BGZF inflate + fetch walk +
            # quota/dedup + confidence pooling in one C++ call per merged
            # region (native mk_sample_region) — the Python loop below is
            # the oracle (tests/test_native_sampling.py)
            native_regions = (
                conf_mode
                and sample_frac is None
                and hasattr(reader, "bam_raw")
                and hasattr(reader, "fetch_chunk_voffsets")
            )
            for s, e, x in regions:
                if native_regions:
                    chunks = reader.fetch_chunk_voffsets(tid, s, e)
                    res = _native.sample_region(
                        reader.bam_raw,
                        chunks,
                        tid, s, e, x, only_mapped,
                        "\n".join(seen).encode() + b"\n" if seen else b"",
                        collapse=collapse, edge_filter=edge_filter,
                    )
                    _native.release_pages(reader.bam_raw, chunks)
                    if res is not None:
                        conf, tb, _consumed, new_names = res
                        conf_parts.append((tb, conf))
                        for nm in new_names.decode().split("\n"):
                            if nm:
                                seen.add(nm)
                        continue
                taken = 0
                for rec in reader.fetch(tid, s, e):
                    if x is not None and taken >= x:
                        break
                    if not use_record(rec):
                        continue
                    if sample_frac is not None and sample_frac < 1.0:
                        if rng.random() >= sample_frac:
                            continue
                    if conf_mode:
                        pending.append(rec)
                        if len(pending) >= 256 or (
                            x is not None and taken + len(pending) >= x
                        ):
                            taken += flush_pending()
                    elif add(rec):
                        taken += 1
                taken += flush_pending()
        # unmapped tail (reads_sampler/mod.rs:89-125)
        if not only_mapped and (reader.n_no_coor() > 0 or len(seen) < 100):
            quota = (
                max(num_reads - len(seen), 0) if num_reads is not None else None
            )
            taken = 0
            for rec in reader.fetch_unmapped():
                if quota is not None and taken >= quota:
                    break
                if rec.is_not_primary:
                    continue
                if sample_frac is not None and sample_frac < 1.0:
                    if rng.random() >= sample_frac:
                        continue
                if conf_mode:
                    pending.append(rec)
                    if len(pending) >= 256 or (
                        quota is not None and taken + len(pending) >= quota
                    ):
                        taken += flush_pending()
                elif add(rec):
                    taken += 1
            taken += flush_pending()
    else:
        # serial path
        taken = 0
        for rec in reader.records():
            if num_reads is not None and taken >= num_reads:
                break
            if not use_record(rec):
                continue
            if sample_frac is not None and sample_frac < 1.0:
                if rng.random() >= sample_frac:
                    continue
            if conf_mode:
                pending.append(rec)
                if len(pending) >= 256 or (
                    num_reads is not None
                    and taken + len(pending) >= num_reads
                ):
                    taken += flush_pending()
            elif add(rec):
                taken += 1
        taken += flush_pending()

    if conf_mode:
        pooled: dict[int, list] = {}
        for tb_a, cf_a in conf_parts:
            for b in np.unique(tb_a):
                pooled.setdefault(int(b), []).append(cf_a[tb_a == b])
        return {b: np.concatenate(v) for b, v in pooled.items()}
    if confidences_only:
        return confidences_per_base(sampled)
    return sampled


def confidences_per_base(sampled: dict) -> dict[int, np.ndarray]:
    """Pooled argmax confidences per threshold base over sampled reads
    (read_ids_to_base_mod_probs.rs:67 mle_probs_per_base)."""
    confs: dict[int, list] = {}
    for per_base in sampled.values():
        for b, groups in per_base.items():
            confs.setdefault(b, []).append(group_confidences(groups))
    return {b: np.concatenate(v) for b, v in confs.items()}


def thresholds_from_sampled(
    sampled: dict, filter_percentile: float
) -> dict[str, float]:
    return thresholds_from_confidences(
        confidences_per_base(sampled), filter_percentile
    )


def thresholds_from_confidences(
    confs: dict, filter_percentile: float
) -> dict[str, float]:
    """Per-base filter percentile of the confidences, sorted on the host."""
    out = {}
    for b, v in confs.items():
        s = np.sort(v.astype(np.float32))
        out[DNA_BASES[b]] = float(
            percentile_linear_interp(s, filter_percentile)
        )
    return out


def estimate_thresholds(
    reader,
    num_reads: int | None = 10042,
    sample_frac: float | None = None,
    seed: int | None = None,
    include_unmapped: bool = False,
    filter_percentile: float = 0.1,
    region: str | None = None,
    collapse=None,
    edge_filter=None,
    force_allow: bool = False,
    interval_size: int = 1_000_000,
    position_filter=None,
) -> dict[str, float]:
    """Per-base thresholds = filter-percentile of sampled call confidences
    (thresholds.rs:82 calc_thresholds_per_base)."""
    if sample_frac is not None:
        num_reads = None
    confs = sample_reads(
        reader, num_reads, sample_frac, seed, include_unmapped, region,
        collapse, edge_filter, force_allow, interval_size,
        position_filter, confidences_only=True,
    )
    return thresholds_from_confidences(confs, filter_percentile)
