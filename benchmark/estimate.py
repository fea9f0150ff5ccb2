"""modkit's default pass-threshold estimate, worked out again in NumPy from
the generator's truth: which reads ``modkit pileup`` samples when no
``--filter-threshold`` is given, and the percentile of their calls'
confidences. It imports nothing of the program under test.

What it implements, from modkit's documentation and sources
(``sampling_schedule.rs:171`` ``from_num_reads``, ``:440``
``accumulate_sample_counts``, ``thresholds.rs:17``
``percentile_linear_interp``), for a sorted, indexed BAM of one contig
whose reads are all primary and mapped:

- the contig's quota: ``min(ceil(f32(num_reads) * f32(n_contig /
  n_total)), n_contig)``;
- the contig split into intervals of the sampling size, each drawing
  ``ceil(f32(quota) * f32(len / contig_len))`` reads; consecutive
  intervals merge until their draw reaches ``MIN_READS_PER_REGION`` or the
  contig ends;
- in each merged region ``[s, e)``, the first ``x`` reads in file order of
  those that overlap it (``start < e`` and ``end > s``) and carry at least
  one call at an aligned base; a read taken in an earlier region counts
  against ``x`` but is pooled once;
- a call's confidence: the larger mod probability where it is strictly
  above the canonical one (1 - their sum), else the canonical one, with
  an ML value q standing for (q + 0.5) / 256, in float32; calls at
  inserted bases are left out (only mapped positions are sampled);
- the threshold of each primary base: the linearly interpolated percentile
  of the sampled reads' confidences of calls on that base, in float32 as
  ``thresholds.rs:17`` computes it; a read is sampled where it carries a
  call on any base.

Every confidence lies on the 1/512 grid, so the pool is kept as a
histogram of 513 bins and the sorted values are read from its cumulative
counts.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
# the smallest draw of a merged sampling region (sampling_schedule.rs:447)
MIN_READS_PER_REGION = 50
BINS = 513


def read_confidence_hists(batch) -> dict:
    """Per called base, [reads, 513] counts of each read's call confidences
    in 512ths (``gen.Calls.confidence``), over its calls at aligned bases."""
    n = len(batch.starts)
    out = {}
    for c in batch.calls:
        al = c.pos >= 0
        conf = c.confidence()[al]
        flat = np.bincount(c.read[al] * BINS + conf, minlength=n * BINS)
        out[c.base] = flat.reshape(n, BINS).astype(np.int32)
    return out


def grid_hist(values: np.ndarray, chunk: int = 1 << 20) -> tuple[np.ndarray, int]:
    """(counts of ``values`` in 512ths over the 513 bins, how many lie off
    that grid), a block of ``chunk`` values at a time."""
    hist = np.zeros(BINS, dtype=np.int64)
    off = 0
    with np.errstate(invalid="ignore"):
        for i in range(0, len(values), chunk):
            k = np.asarray(values[i:i + chunk], dtype=F32) * F32(512)
            ki = k.astype(np.int32)
            on = (ki == k) & (ki >= 0) & (ki < BINS)
            hist += np.bincount(ki[on], minlength=BINS)
            off += on.size - int(np.count_nonzero(on))
    return hist, off


def contig_quota(num_reads: int, n_contig: int, n_total: int) -> int:
    """The reads the schedule asks of one contig."""
    share = F32(n_contig) / F32(n_total)
    return min(int(np.ceil(F32(num_reads) * share)), n_contig)


def regions(contig_len: int, quota: int, interval: int) -> list:
    """The merged sampling regions ``(start, end, draw)`` of a contig."""
    out = []
    pos, first, draw = 0, None, 0
    while pos < contig_len:
        e = min(pos + interval, contig_len)
        if first is None:
            first = pos
        draw += int(np.ceil(F32(quota) * (F32(e - pos) / F32(contig_len))))
        pos = e
        if draw >= MIN_READS_PER_REGION or pos >= contig_len:
            out.append((first, pos, draw))
            first, draw = None, 0
    return out


def sample(starts: np.ndarray, spans: np.ndarray, eligible: np.ndarray,
           schedule: list) -> np.ndarray:
    """Indices, in the order they were first taken, of the reads that the
    regions of ``schedule`` sample: ``starts`` sorted, ``eligible`` the
    reads that carry a call at an aligned base."""
    ends = starts + spans
    taken = np.zeros(len(starts), dtype=bool)
    order = []
    for s, e, x in schedule:
        idx = np.arange(int(np.searchsorted(starts, e, side="left")))
        idx = idx[(ends[idx] > s) & eligible[idx]][:x]
        new = idx[~taken[idx]]
        taken[new] = True
        order.append(new)
    return np.concatenate(order) if order else np.zeros(0, dtype=np.int64)


def percentile(hist: np.ndarray, q: float) -> float:
    """The linearly interpolated ``q`` percentile of the values that the
    histogram ``hist`` (512ths) counts, in float32 (thresholds.rs:17)."""
    n = int(hist.sum())
    if n < 2:
        raise ValueError(f"estimate: {n} confidences, at least 2 are needed")
    q = F32(q)
    if q > F32(1.0):
        raise ValueError(f"estimate: percentile {q} above 1")
    cum = np.cumsum(hist)

    def at(k: int) -> np.float32:
        return F32(int(np.searchsorted(cum, k, side="right")) / 512)

    if q == F32(1.0):
        return float(at(n - 1))
    t = F32(n - 1) * q
    g = t - F32(np.floor(t))
    y0, y1 = at(int(np.floor(t))), at(int(np.ceil(t)))
    return float(y0 * (F32(1.0) - g) + y1 * g)


def estimate(starts: np.ndarray, spans: np.ndarray, hists: dict,
             contig_len: int, num_reads: int, filter_percentile: float,
             interval: int) -> dict:
    """The schedule's reads, their pooled confidences and the thresholds,
    for one contig that holds every read of the file; ``hists`` is
    ``read_confidence_hists`` of every read, in file order. A read is
    eligible where it carries a call of any base; the pool and the
    percentile are taken per base (thresholds.rs:82
    ``calc_thresholds_per_base``)."""
    quota = contig_quota(num_reads, len(starts), len(starts))
    schedule = regions(contig_len, quota, interval)
    eligible = sum(h.sum(axis=1) for h in hists.values()) > 0
    reads = sample(starts, spans, eligible, schedule)
    pooled = {b: h[reads].sum(axis=0, dtype=np.int64) for b, h in hists.items()}
    return {"quota": quota, "regions": len(schedule), "reads": reads,
            "pooled": pooled, "confidences": {b: int(p.sum()) for b, p in pooled.items()},
            "thresholds": {b: percentile(p, filter_percentile) for b, p in pooled.items()}}
