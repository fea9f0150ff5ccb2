"""Seeded generator of the benchmark's input: a reference contig, nanopore
reads aligned to it with base-modification calls, written as a sorted,
indexed modBAM (and the contig as an indexed FASTA).

The generator and the plain reference share one definition of the truth:
``iter_batches`` yields the reads of a run in fixed batches, every batch
from its own random stream of ``(seed, batch)``, so the parent process can
regenerate the truth after the measured window without reading the BAM.
Every size comes from the configuration's ``data`` block; the multiset of
read lengths and the read count are fixed by the configuration, and the
seed draws the contig, where the reads lie, their errors and their calls.

The calls are the configuration's call set, a list of groups in model
order (``call_groups``), each one basecaller model's calls on one primary
base. A configuration gives either ``"model"`` (``"allc"`` or ``"cpg"``:
one C group whose truth keys are the ``data`` keys of the same meaning,
see ``model_groups``) or ``"call_groups"``, a list of objects with the keys

- ``base``: the primary base, ``"C"`` or ``"A"`` (at most one group each);
- ``codes``: its mod codes in the model's order, one or two
  (``["h", "m"]``, ``["a"]``);
- ``context``: ``"all"`` (every such base of the read) or ``"cpg"`` (read
  CpGs, C only);
- ``modified_bases_threshold``: dorado's ``--modified-bases-threshold``, or
  null (none): a base is written only where its ML values sum to at least
  floor(256 t), the bases it skips are unknown (the ``?`` mode);
- ``sites``: which aligned bases are sites, ``"cpg"`` (read CpGs) or
  ``"all"``; ``site_share``, ``site_level_high``, ``site_level_low``: a
  reference position's modified share is the high level with probability
  ``site_share``, else the low one; ``background``: the modified share of
  calls off the sites (inserted bases, and a C group's non-CpG C's);
- ``code_shares``: the share of the modified calls that each code but the
  last takes (the last takes the rest);
- ``miscall_rate``, ``conf_spread``, ``conf_beta_b``: how often the top
  class is wrong, and the spread of its probability, 1 - spread * Beta(1, b).

Random streams: ``(seed, 0)`` draws the contig, the C sites' levels and
where the reads lie; ``(seed, 1, b)`` batch ``b``'s errors, qualities and
its C calls, in that order; an A group draws its sites from ``(seed, 2)``
and batch ``b``'s calls from ``(seed, 3, b)``, so a C group draws the same
with or without one.

Run as a script it writes ``reads.bam`` (+ ``.bai``), ``ref.fa`` (+
``.fai``) and ``meta.json`` into ``--out``:

    python benchmark/gen.py --config benchmark/configs/<config>.json \\
        --seed 7 --out DIR

It imports numpy and the standard library only (never torch), so it can
run beside the parent's set-up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import bamio  # noqa: E402

# base codes 0..3 = A C G T
A, C, G, T = 0, 1, 2, 3
ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
# the primary bases a group may call, and each one's complement
BASES = {"A": A, "C": C}
COMPLEMENT = {A: T, C: G}
GROUP_KEYS = ("base", "codes", "context", "modified_bases_threshold", "sites",
              "site_share", "site_level_high", "site_level_low", "background",
              "code_shares", "miscall_rate", "conf_spread", "conf_beta_b")


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


def model_groups(model: str, data: dict) -> list:
    """The call set of a configuration that names a ``model``: one C group,
    its truth from the ``data`` keys of the same meaning."""
    if model not in ("allc", "cpg"):
        raise ValueError(f"unknown model {model!r}")
    allc = model == "allc"
    return [{
        "base": "C", "codes": ["h", "m"], "context": "all" if allc else "cpg",
        "modified_bases_threshold": data["modified_bases_threshold"] if allc else None,
        "sites": "cpg", "site_share": data["cpg_methylated_share"],
        "site_level_high": data["cpg_beta_high"], "site_level_low": data["cpg_beta_low"],
        "background": data["non_cpg_methylated"],
        "code_shares": [data["hmc_share_of_methylated"]],
        "miscall_rate": data["miscall_rate"], "conf_spread": data["conf_spread"],
        "conf_beta_b": data["conf_beta_b"],
    }]


def call_groups(config: dict) -> list:
    """The configuration's call set in model order (module docstring):
    its ``call_groups``, or its ``model`` spelled out."""
    if "model" in config:
        if "call_groups" in config:
            raise ValueError("a configuration gives a model or call groups, not both")
        return model_groups(config["model"], config["data"])
    groups = config["call_groups"]
    if not groups or len({g["base"] for g in groups}) != len(groups):
        raise ValueError("call groups: at least one, and one a base")
    for g in groups:
        if set(g) != set(GROUP_KEYS):
            raise ValueError(f"call group keys {sorted(set(g) ^ set(GROUP_KEYS))}")
        if (g["base"] not in BASES or not 1 <= len(g["codes"]) <= 2
                or len(g["code_shares"]) != len(g["codes"]) - 1
                or g["context"] not in ("all", "cpg") or g["sites"] not in ("all", "cpg")
                or ("cpg" in (g["context"], g["sites"]) and g["base"] != "C")):
            raise ValueError(f"call group {g}: not one the generator makes")
    return groups


@dataclass
class Layout:
    """What is fixed for the whole run: the contig and where each read lies."""

    contig: np.ndarray  # uint8 base codes, [L]
    site_level: dict  # called base (str) -> float32 [L]: modified share at a site
    starts: np.ndarray  # int64 [n], sorted
    spans: np.ndarray  # int64 [n]: reference bases each read covers
    reverse: np.ndarray  # bool [n]


def _site_levels(u: np.ndarray, g: dict) -> np.ndarray:
    return np.where(u < float(g["site_share"]), np.float32(g["site_level_high"]),
                    np.float32(g["site_level_low"])).astype(np.float32)


def make_layout(config: dict, seed: int) -> Layout:
    data = config["data"]
    groups = {g["base"]: g for g in call_groups(config)}
    length = int(data["contig_length"])
    rng = rng_for(seed, 0)
    gc = float(data["gc_before_cpg_depletion"])
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    contig = rng.choice(4, size=length, p=p).astype(np.uint8)
    # CpG depletion: most CG dinucleotides lose the G (as CpA)
    cg = np.flatnonzero((contig[:-1] == C) & (contig[1:] == G))
    lose = cg[rng.random(len(cg)) >= float(data["cpg_kept"])]
    contig[lose + 1] = A
    # the C sites' draw is made with or without a C group, so that the
    # reads lie where they do
    u = rng.random(length)
    site_level = {"C": _site_levels(u, groups["C"])} if "C" in groups else {}
    if "A" in groups:
        site_level["A"] = _site_levels(rng_for(seed, 2).random(length), groups["A"])

    spans = read_spans(data)
    n = len(spans)
    spans = spans[rng.permutation(n)]
    starts = (rng.random(n) * (length - spans + 1)).astype(np.int64)
    order = np.argsort(starts, kind="stable")
    reverse = rng.random(n) < float(data["reverse_share"])
    return Layout(contig, site_level, starts[order], spans[order], reverse)


def read_spans(data: dict) -> np.ndarray:
    """The fixed multiset of read lengths: log-normal quantiles with the
    configured N50 and sigma, enough reads for the configured depth. The
    same for every seed, so every seed does the same amount of work."""
    from statistics import NormalDist

    length = int(data["contig_length"])
    sigma = float(data["read_length_sigma"])
    # N50 of a log-normal = exp(mu + sigma^2)
    mu = np.log(float(data["read_n50"])) - sigma * sigma
    n = int(round(float(data["depth"]) * length / np.exp(mu + sigma * sigma / 2)))
    nd = NormalDist()
    z = np.array([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    lo, hi = int(data["read_length_min"]), min(int(data["read_length_max"]), length)
    return np.clip(np.rint(np.exp(mu + sigma * z)), lo, hi).astype(np.int64)


def batch_of(layout: Layout, config: dict, seed: int, b: int) -> Batch:
    """Batch ``b`` of the run's reads (``batch_reads`` each, file order)."""
    size = int(config["data"]["batch_reads"])
    r0 = b * size
    return make_batch(layout, config, seed, b, r0, min(r0 + size, len(layout.starts)))


@dataclass
class Calls:
    """One call group's calls over a batch, in query order."""

    base: str  # primary base, "A" or "C"
    codes: list  # mod codes in model order
    q: np.ndarray  # int64, sorted: query index of each call
    read: np.ndarray  # int64: its read
    pos: np.ndarray  # int64: its reference position, -1 if inserted
    ml: np.ndarray  # uint8 [codes, calls]: each code's ML value

    def confidence(self) -> np.ndarray:
        """Each call's confidence in 512ths: the largest class probability,
        an ML value q standing for (q + 0.5) / 256 and the canonical class
        for 1 - their sum."""
        x = 2 * self.ml.astype(np.int32) + 1
        best, total = x[0], x[0]
        for row in x[1:]:
            best, total = np.maximum(best, row), total + row
        return np.maximum(best, 512 - total)


@dataclass
class Batch:
    """The truth of reads ``r0 .. r0 + n - 1``, flat over the batch.

    Columns are the reference bases the reads cover, read after read
    (``col_off``); the query is the reads' bases in reference orientation,
    read after read (``q_off``). Each column is a match (M) unless it is a
    deletion; an insertion follows a match column."""

    r0: int
    starts: np.ndarray  # int64 [n]
    spans: np.ndarray  # int64 [n]: reference bases each read covers
    reverse: np.ndarray  # bool [n]
    col_off: np.ndarray  # int64 [n]
    q_off: np.ndarray  # int64 [n]
    q_len: np.ndarray  # int64 [n]
    del_col: np.ndarray  # int64, sorted: deleted columns
    ins_col: np.ndarray  # int64, sorted: columns an insertion follows
    ins_len: np.ndarray  # int64
    sub_col: np.ndarray  # int64, sorted: substituted match columns
    sub_base: np.ndarray  # uint8: the read's base there (reference orientation)
    seq: np.ndarray  # uint8 [Q]: base codes in reference orientation
    qual: np.ndarray  # uint8 [Q]
    calls: list  # Calls of each group, in model order

    def read_of_col(self, col: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.col_off, col, side="right") - 1


def quality_table(data: dict) -> np.ndarray:
    """256 quality values whose spread is a normal of the configured mean
    and sd, clipped to the configured range: a uniform byte indexes it."""
    from statistics import NormalDist

    nd = NormalDist(float(data["qual_mean"]), float(data["qual_sd"]))
    q = np.array([nd.inv_cdf((k + 0.5) / 256) for k in range(256)])
    return np.clip(np.rint(q), int(data["qual_min"]), int(data["qual_max"])).astype(np.uint8)


def _sorted_unique_draw(rng, total: int, rate: float) -> np.ndarray:
    n = rng.binomial(total, rate)
    return np.unique(rng.integers(0, total, n))


def make_batch(layout, config, seed, b, r0, r1) -> Batch:
    data = config["data"]
    groups = call_groups(config)
    rng = rng_for(seed, 1, b)
    starts = layout.starts[r0:r1]
    spans = layout.spans[r0:r1]
    reverse = layout.reverse[r0:r1]
    n = len(starts)
    total = int(spans.sum())
    col_off = np.cumsum(spans) - spans
    ref_cat = np.concatenate(
        [layout.contig[s:s + ln] for s, ln in zip(starts.tolist(), spans.tolist())])

    # errors: positions first, then their kind (no indel at a read's ends)
    p_del, p_ins = float(data["deletion_rate"]), float(data["insertion_rate"])
    p_sub = float(data["substitution_rate"])
    err = _sorted_unique_draw(rng, total, p_del + p_ins + p_sub)
    kind = rng.random(len(err)) * (p_del + p_ins + p_sub)
    rid = np.searchsorted(col_off, err, side="right") - 1
    within = err - col_off[rid]
    edge = (within == 0) | (within == spans[rid] - 1)
    del_col = err[(kind < p_del) & ~edge]
    ins_sel = (kind >= p_del) & (kind < p_del + p_ins) & ~edge
    ins_col = err[ins_sel]
    sub_col = err[kind >= p_del + p_ins]
    ins_len = rng.geometric(float(data["insertion_length_p"]), len(ins_col)).astype(np.int64)
    sub_base = ((ref_cat[sub_col] + rng.integers(1, 4, len(sub_col))) % 4).astype(np.uint8)

    seq = ref_cat
    seq[sub_col] = sub_base
    keep = np.ones(total, dtype=bool)
    keep[del_col] = False
    seq = seq[keep]
    # kept index of an insertion's column; the bases go right after it
    ins_kept = ins_col - np.searchsorted(del_col, ins_col)
    ins_at = np.repeat(ins_kept + 1, ins_len)
    seq = np.insert(seq, ins_at, rng.integers(0, 4, len(ins_at), dtype=np.uint8))
    q_len = (spans - np.bincount(np.searchsorted(col_off, del_col, side="right") - 1,
                                 minlength=n)
             + np.bincount(np.searchsorted(col_off, ins_col, side="right") - 1,
                           weights=ins_len, minlength=n).astype(np.int64))
    q_off = np.cumsum(q_len) - q_len
    q_total = len(seq)
    qual = quality_table(data)[rng.integers(0, 256, q_total, dtype=np.uint8)]

    reads = dict(starts=starts, col_off=col_off, q_off=q_off, q_len=q_len,
                 rev_q=np.repeat(reverse, q_len), seq=seq, del_col=del_col,
                 ins_final=ins_at + np.arange(len(ins_at)))
    calls = [_group_calls(g, layout, reads,
                          rng if g["base"] == "C" else rng_for(seed, 3, b))
             for g in groups]
    return Batch(r0, starts, spans, reverse, col_off, q_off, q_len,
                 del_col, ins_col, ins_len, sub_col, sub_base, seq, qual, calls)


def _group_calls(g: dict, layout: Layout, reads: dict, rng) -> Calls:
    """One group's calls on a batch's reads (``reads``: their query in
    reference orientation and where it lies), drawn from ``rng``."""
    seq, rev_q, q_off, q_len = reads["seq"], reads["rev_q"], reads["q_off"], reads["q_len"]
    base = BASES[g["base"]]
    q_total = len(seq)
    # the read's own orientation: a reverse read's base is the complement
    # here, and its next base is the one before
    is_b = np.where(rev_q, seq == COMPLEMENT[base], seq == base)
    if "cpg" in (g["context"], g["sites"]):
        first = np.zeros(q_total, dtype=bool)
        first[q_off] = True
        last = np.zeros(q_total, dtype=bool)
        last[q_off + q_len - 1] = True
        nxt_g = np.zeros(q_total, dtype=bool)
        nxt_g[:-1] = seq[1:] == G
        prv_c = np.zeros(q_total, dtype=bool)
        prv_c[1:] = seq[:-1] == C
        cpg = np.where(rev_q, prv_c & ~first, nxt_g & ~last) & is_b
    call_q = np.flatnonzero(cpg if g["context"] == "cpg" else is_b)

    # each call's reference position: through the inserted bases, the
    # deleted columns and the read's start
    del_col, ins_final = reads["del_col"], reads["ins_final"]
    inserted = np.zeros(q_total, dtype=bool)
    inserted[ins_final] = True
    cq_aligned = ~inserted[call_q]
    kept_idx = call_q - np.searchsorted(ins_final, call_q)
    col = kept_idx + np.searchsorted(del_col - np.arange(len(del_col)), kept_idx, side="right")
    call_read = np.searchsorted(q_off, call_q, side="right") - 1
    call_pos = np.where(cq_aligned, reads["starts"][call_read] + col
                        - reads["col_off"][call_read], -1)

    # the true state at a site follows the site's modified share, elsewhere
    # the background
    nc = len(call_q)
    site = (cpg[call_q] if g["sites"] == "cpg" else True) & cq_aligned
    beta = np.where(site, layout.site_level[g["base"]][np.maximum(call_pos, 0)],
                    np.float32(g["background"]))
    u = rng.random(nc, dtype=np.float32)
    # classes 0 canonical, 1 + j code j: with two codes the first takes
    # its share of the modified calls, the second the rest
    k = len(g["codes"]) + 1
    true = np.where(u < beta, k - 1, 0)
    if k == 3:
        true = np.where(u < beta * np.float32(g["code_shares"][0]), 1, true)
    true = true.astype(np.int8)
    wrong = rng.random(nc, dtype=np.float32) < np.float32(g["miscall_rate"])
    top = np.where(wrong, (true + rng.integers(1, k, nc, dtype=np.int8)) % k, true)
    # the top class's probability 1 - spread * Beta(1, b), by inversion;
    # the rest goes to the other class, or splits at random between the
    # other two
    bb = np.float32(1.0 / float(g["conf_beta_b"]))
    conf = np.float32(1.0) - np.float32(g["conf_spread"]) * (
        np.float32(1.0) - rng.random(nc, dtype=np.float32) ** bb)
    rest = np.float32(1.0) - conf
    if k == 2:
        ml = np.minimum(np.where(top == 1, conf, rest) * np.float32(256),
                        np.float32(255)).astype(np.uint8)[None]
    else:
        split = rng.random(nc, dtype=np.float32)
        second = (top + rng.integers(1, 3, nc, dtype=np.int8)) % 3
        a_, b_ = rest * split, rest * (np.float32(1.0) - split)
        ph = np.where(top == 1, conf, np.where(second == 1, a_, b_))
        pm = np.where(top == 2, conf, np.where(second == 2, a_, b_))
        qh = np.minimum(ph * np.float32(256), np.float32(255)).astype(np.int16)
        qm = np.minimum(pm * np.float32(256), np.float32(255)).astype(np.int16)
        # keep the two ML values summing to at most 255 (a probability <= 1)
        over = np.maximum(qh + qm - 255, 0)
        lower_h = qh <= qm
        ml = np.stack([np.where(lower_h, qh - over, qh).astype(np.uint8),
                       np.where(lower_h, qm, qm - over).astype(np.uint8)])
    t = g["modified_bases_threshold"]
    if t is not None:
        # an all-context model writes a base only where the modified
        # classes' ML values reach --modified-bases-threshold on the ML
        # grid; the bases it skips are unknown (the `?` mode)
        emit = ml.astype(np.int32).sum(axis=0) >= int(np.floor(float(t) * 256))
        call_q, call_read, call_pos = call_q[emit], call_read[emit], call_pos[emit]
        ml = np.ascontiguousarray(ml[:, emit])
    return Calls(g["base"], list(g["codes"]), call_q, call_read, call_pos, ml)


def confidence_hist(batch: Batch) -> dict:
    """Per called base, counts of each call's confidence in 512ths
    (``Calls.confidence``)."""
    return {c.base: np.bincount(c.confidence(), minlength=513) for c in batch.calls}


def threshold_from_hist(hist: np.ndarray, percentile: float) -> float:
    """The confidence at rank floor(percentile * (n - 1)) of the sorted
    calls, exact in float32 (a multiple of 1/512)."""
    n = int(hist.sum())
    rank = int(np.floor(percentile * (n - 1)))
    k = int(np.searchsorted(np.cumsum(hist), rank + 1))
    return k / 512.0


def cigar_runs(batch: Batch):
    """(ops, lens, read offsets) of every read's CIGAR, built from its
    deletions and insertions: M runs between them, runs merged."""
    n = len(batch.starts)
    ev_col = np.concatenate([batch.del_col, batch.ins_col])
    ev_op = np.concatenate([np.full(len(batch.del_col), 2), np.full(len(batch.ins_col), 1)])
    ev_len = np.concatenate([np.ones(len(batch.del_col), dtype=np.int64), batch.ins_len])
    order = np.argsort(ev_col, kind="stable")
    ev_col, ev_op, ev_len = ev_col[order], ev_op[order], ev_len[order]
    ev_read = batch.read_of_col(ev_col)
    lc = ev_col - batch.col_off[ev_read]
    # the M run before each event ends at its column (a deletion) or
    # takes the column in (an insertion follows it)
    end = lc + (ev_op == 1)
    same = np.zeros(len(lc), dtype=bool)
    same[1:] = ev_read[1:] == ev_read[:-1]
    cur = np.where(same, np.concatenate([[0], lc[:-1] + 1]), 0)
    last_cur = np.zeros(n, dtype=np.int64)
    last_cur[ev_read] = lc + 1  # the last event of a read wins
    ne = len(lc)
    op = np.concatenate([np.zeros(ne, dtype=np.int64), ev_op, np.zeros(n, dtype=np.int64)])
    ln = np.concatenate([end - cur, ev_len, batch.spans - last_cur])
    rd = np.concatenate([ev_read, ev_read, np.arange(n)])
    step = np.concatenate([2 * np.arange(ne), 2 * np.arange(ne) + 1,
                           np.full(n, 2 * ne + 1)])
    order = np.lexsort((step, rd))
    op, ln, rd = op[order], ln[order], rd[order]
    nz = ln > 0
    op, ln, rd = op[nz], ln[nz], rd[nz]
    brk = np.ones(len(op), dtype=bool)
    brk[1:] = (op[1:] != op[:-1]) | (rd[1:] != rd[:-1])
    run = np.cumsum(brk) - 1
    run_len = np.bincount(run, weights=ln).astype(np.int64)
    run_op = op[brk]
    run_off = np.searchsorted(rd[brk], np.arange(n + 1))
    return run_op, run_len, run_off


def encode_batch(batch: Batch, mapq: int) -> list:
    """BAM records (bytes) of the batch's reads: MM holds one group for
    each (base, code) in model order, ML their values in the same order."""
    run_op, run_len, run_off = cigar_runs(batch)
    cig_all = ((run_len << 4) | run_op).astype("<u4")
    n = len(batch.starts)
    call_off = [np.searchsorted(c.read, np.arange(n + 1)) for c in batch.calls]
    records = []
    for i in range(n):
        a, b = int(batch.q_off[i]), int(batch.q_off[i] + batch.q_len[i])
        rev = bool(batch.reverse[i])
        seq = batch.seq[a:b]
        mm, ml = [], []
        for c, off in zip(batch.calls, call_off):
            c0, c1 = int(off[i]), int(off[i + 1])
            base = BASES[c.base]
            # bases skipped since the previous call, in the read's orientation
            is_b = seq == (COMPLEMENT[base] if rev else base)
            rank = np.cumsum(is_b) - 1
            r = rank[c.q[c0:c1] - a]
            if rev:
                r = (int(is_b.sum()) - 1 - r)[::-1]
            d = np.diff(r, prepend=-1) - 1
            deltas = "".join("," + str(x) for x in d.tolist())
            q = c.ml[:, c0:c1]
            if rev:  # MM/ML list calls in the read's own orientation
                q = q[:, ::-1]
            for code, values in zip(c.codes, q):
                mm.append(f"{c.base}+{code}?{deltas};")
                ml.append(values)
        records.append(bamio.encode_record(
            name=f"read{batch.r0 + i}", pos=int(batch.starts[i]),
            end=int(batch.starts[i] + batch.spans[i]), flag=16 if rev else 0,
            mapq=mapq, cigar=cig_all[run_off[i]:run_off[i + 1]],
            seq_codes=seq, qual=batch.qual[a:b], mm="".join(mm),
            ml=np.concatenate(ml),
        ))
    return records


_WORKER: dict = {}


def _worker_init(config: dict, seed: int) -> None:
    _WORKER.update(config=config, seed=seed, layout=make_layout(config, seed))


def _encode_worker(b: int):
    """One batch as BGZF blocks (records start in the batch's own blocks),
    with what the index and the thresholds need."""
    cfg, seed, layout = _WORKER["config"], _WORKER["seed"], _WORKER["layout"]
    batch = batch_of(layout, cfg, seed, b)
    records = encode_batch(batch, int(cfg["data"]["mapq"]))
    lens = np.array([len(r) for r in records], dtype=np.int64)
    uoff = np.concatenate([[0], np.cumsum(lens)])
    blob, coff = bamio.bgzf_compress(b"".join(records))
    return dict(blob=blob, coff=coff, uoff=uoff, beg=batch.starts,
                end=batch.starts + batch.spans, hist=confidence_hist(batch),
                calls={c.base: len(c.q) for c in batch.calls})


def batch_count(config: dict) -> int:
    data = config["data"]
    return -(-len(read_spans(data)) // int(data["batch_reads"]))


def generate(config: dict, seed: int, out_dir: str, workers: int = 1) -> dict:
    """Write the run's modBAM, its index, the FASTA and ``meta.json``;
    batches encode on ``workers`` processes. ``meta.json`` holds, for each
    called base, its calls and its threshold (``threshold_from_hist`` at
    the configuration's ``filter_percentile``); ``threshold`` is C's."""
    import multiprocessing as mp

    data = config["data"]
    name = data["contig_name"]
    layout = make_layout(config, seed)
    bases = [g["base"] for g in call_groups(config)]
    hist = {b: np.zeros(513, dtype=np.int64) for b in bases}
    calls = dict.fromkeys(bases, 0)
    vb, ve, begs, ends = [], [], [], []
    path = os.path.join(out_dir, "reads.bam")
    with open(path, "wb") as fh, mp.get_context("spawn").Pool(
            workers, initializer=_worker_init, initargs=(config, seed)) as pool:
        head, _ = bamio.bgzf_compress(bamio.bam_header(name, len(layout.contig)))
        fh.write(head)
        base = len(head)
        for part in pool.imap(_encode_worker, range(batch_count(config))):
            v = bamio.voffsets(base, part["coff"], part["uoff"])
            vb.append(v[:-1])
            ve.append(v[1:])
            begs.append(part["beg"])
            ends.append(part["end"])
            for b in bases:
                hist[b] += part["hist"][b]
                calls[b] += part["calls"][b]
            fh.write(part["blob"])
            base += len(part["blob"])
        fh.write(bamio.EOF_BLOCK)
    bamio.write_bai(path + ".bai", np.concatenate(begs), np.concatenate(ends),
                    np.concatenate(vb), np.concatenate(ve))
    bamio.write_fasta(os.path.join(out_dir, "ref.fa"), name, ASCII[layout.contig])
    pct = float(config["filter_percentile"])
    thresholds = {b: threshold_from_hist(hist[b], pct) for b in bases}
    meta = {
        "reads": int(len(layout.starts)),
        "read_bases": int(layout.spans.sum()),
        "calls": sum(calls.values()),
    }
    if "C" in thresholds:
        meta["threshold"] = thresholds["C"]
    meta.update(contig=name, thresholds=thresholds, calls_per_base=calls)
    with open(os.path.join(out_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)
    with open(args.config) as fh:
        config = json.load(fh)
    generate(config, args.seed, args.out, args.workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
