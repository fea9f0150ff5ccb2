"""The plain reference: the bedMethyl of a cell worked out again from the
generator's truth, in NumPy.

It regenerates the reads of the run from the seed (``gen.batch_of``),
calls every aligned modification call against its base's threshold,
counts per reference position and strand, and renders the rows as modkit's
bedMethyl (18 columns, tab-separated). It imports nothing of the program
under test.

What it implements, from modkit's documentation of ``pileup``, for a call
set of one or more groups, each on its own primary base (``gen.py``):

- a call: each class whose probability reaches the threshold of the
  call's primary base is a candidate, the canonical class (1 - the sum of
  the mod probabilities) too; the highest candidate wins, on a tie the
  canonical class, then the later mod class; no candidate is a failed call;
- ``--ignore h`` (``--preset traditional``): 5hmC's probability is spread
  evenly over the remaining classes of its base (5mC and canonical);
- per position, strand and primary base ``b``, in the reads' own
  orientation: ``N_mod``, ``N_canonical``, ``N_other_mod`` from the calls at
  a read ``b``; ``N_nocall``, reads with a ``b`` there and no call;
  ``N_diff``, reads with another base there and no failed call (modkit
  tallies ``N_fail`` once a position and strand, over every base, and
  ``N_diff`` takes the reads of other bases that are not in it, so the
  five counts partition the reads); per position and strand ``N_fail``
  and ``N_delete``; a row per mod code of ``b`` for every position and
  strand where ``b`` has ``N_valid_cov`` > 0 and a read that carries calls
  covers, ordered by position, strand and code (modkit sorts codes by
  character);
- ``--cpg --combine-strands`` (a call set on C alone): rows only at
  reference CpGs, the + strand at the C and the - strand at the G summed
  into one row with strand ``.``.

Thresholds are handed in as ``--filter-threshold BASE:value``, one for each
called base. Without them each base's threshold is modkit's default
estimate (``estimate.py``): the reads that its sampling schedule takes,
and the percentile of their calls' confidences on that base. The rows then
take two passes over the truth: the reads' confidences first, then the
counts at those thresholds.

``precision="bf16"`` (or ``"fp8"``) computes every call in bfloat16 (fp8
e4m3) instead of float32: the controls that a sound comparison has to
reject.
"""

from __future__ import annotations

import numpy as np

from benchmark import estimate, gen

FILTERED, CANONICAL = 0, 1


class Flags:
    """The pileup flags the reference implements; any other flag that
    changes the rows is refused."""

    # flags that change how the work is split, never the rows
    NEUTRAL = {"--interval-size": 1, "-t": 1, "--threads": 1}
    # the estimate's settings, where no threshold is handed in
    SAMPLING = {"--num-reads": ("num_reads", int), "-n": ("num_reads", int),
                "--filter-percentile": ("filter_percentile", float),
                "-p": ("filter_percentile", float),
                "--sampling-interval-size": ("sampling_interval", int)}

    def __init__(self, flags: list):
        self.thresholds = {}  # primary base -> the threshold handed in
        self.num_reads, self.filter_percentile = 10042, 0.1
        self.sampling_interval = 1_000_000
        self.cpg = self.combine = False
        self.ignore = None
        i = 0
        while i < len(flags):
            f = flags[i]
            if f in self.NEUTRAL:
                i += 1 + self.NEUTRAL[f]
                continue
            if f in self.SAMPLING:
                name, kind = self.SAMPLING[f]
                setattr(self, name, kind(flags[i + 1]))
                i += 2
            elif f == "--filter-threshold":
                base, sep, v = flags[i + 1].partition(":")
                if not sep or base not in gen.BASES or base in self.thresholds:
                    raise ValueError(f"reference: threshold {flags[i + 1]!r}")
                self.thresholds[base] = float(v)
                i += 2
            elif f == "--cpg":
                self.cpg = True
                i += 1
            elif f == "--combine-strands":
                self.combine = True
                i += 1
            elif f == "--ref":
                i += 2
            elif f == "--ignore":
                self.ignore = flags[i + 1]
                i += 2
            elif f == "--preset" and flags[i + 1] == "traditional":
                self.cpg = self.combine = True
                self.ignore = "h"
                i += 2
            else:
                raise ValueError(f"reference: flag {f!r} is not implemented")
        if self.combine and not self.cpg:
            raise ValueError("reference: --combine-strands needs --cpg")
        if self.ignore not in (None, "h"):
            raise ValueError(f"reference: --ignore {self.ignore!r}")
        if not self.thresholds and (self.cpg or self.ignore):
            raise ValueError("reference: the estimate is implemented without "
                             "--cpg and --ignore only")

    def codes(self, codes: list) -> list:
        """Of a group's ``codes``, those its rows carry."""
        return [c for c in codes if c != self.ignore]


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def to_fp8_e4m3(x: np.ndarray) -> np.ndarray:
    """float32 values in [0, 448] rounded to the nearest fp8 e4m3 value
    (3 mantissa bits, ties to even, subnormals below 2**-6), as float32."""
    x = np.asarray(x, dtype=np.float32)
    _, e = np.frexp(x)  # x = m * 2**e with m in [0.5, 1)
    step = np.exp2(np.maximum(e - 1, -6) - 3).astype(np.float32)
    return (np.rint(x / step) * step).astype(np.float32)


ROUNDING = {"f32": lambda v: np.asarray(v, dtype=np.float32),
            "bf16": to_bf16, "fp8": to_fp8_e4m3}


def call_states(cols: list, t: float, precision: str = "f32") -> np.ndarray:
    """0 failed, 1 canonical, 2 + j mod class j, for class probabilities
    ``cols`` (float32 arrays) in the read's class order, every value and
    every sum rounded to ``precision``."""
    rnd = ROUNDING[precision]
    t = rnd(np.array([t], dtype=np.float32))[0]
    n = len(cols[0])
    total = np.zeros(n, dtype=np.float32)
    best_p = np.full(n, -np.inf, dtype=np.float32)
    best_j = np.zeros(n, dtype=np.int64)
    any_mod = np.zeros(n, dtype=bool)
    for j, p in enumerate(cols):
        p = rnd(p)
        total = rnd(total + p)
        ok = p >= t
        mp = np.where(ok, p, np.float32(-np.inf))
        take = mp >= best_p
        best_p = np.where(take, mp, best_p)
        best_j = np.where(take, j, best_j)
        any_mod |= ok
    canon = rnd(np.float32(1.0) - total)
    can = (canon >= t) & (~any_mod | (canon >= best_p))
    return np.where(can, CANONICAL, np.where(any_mod, 2 + best_j, FILTERED))


def class_probs(ml: np.ndarray, codes: list, flags: Flags) -> list:
    """Each call's class probabilities in the group's code order, float32,
    from its ML values ``ml`` [codes, calls]: an ML value q stands for
    (q + 0.5) / 256."""
    p = [(q.astype(np.float32) + np.float32(0.5)) / np.float32(256) for q in ml]
    if flags.ignore in codes:
        # the ignored code's mass spread evenly over the remaining classes
        i = codes.index(flags.ignore)
        share = p[i] / np.float32(len(codes))
        return [pj + share for j, pj in enumerate(p) if j != i]
    return p


class Counts:
    """Per (position, strand) counts over the whole contig, per called base
    where they are kept apart; a flat key is position * 2 + strand (0
    forward, 1 reverse)."""

    def __init__(self, contig: np.ndarray, groups: list):
        """``groups``: (primary base, the codes its rows carry) of each
        group."""
        self.contig = contig
        self.length = n = len(contig)
        self.bases = [b for b, _ in groups]
        self.codes = [list(c) for _, c in groups]
        self.states = [np.zeros((n * 2, 2 + len(c)), dtype=np.int32) for _, c in groups]
        self.delete = np.zeros(n * 2, dtype=np.int32)
        self.subs = np.zeros(n * 2, dtype=np.int32)
        # substitutions whose read base is the group's base, in the read's
        # orientation
        self.subs_to = [np.zeros(n * 2, dtype=np.int32) for _ in groups]
        # coverage edges per strand: every read, and reads that carry calls
        self.cover = np.zeros((2, n + 1), dtype=np.int32)
        self.cover_reg = np.zeros((2, n + 1), dtype=np.int32)

    def merge(self, part: dict) -> None:
        """Add one batch's counts (``batch_counts``)."""
        sl = slice(part["lo"] * 2, part["hi"] * 2)
        for name in ("delete", "subs"):
            getattr(self, name)[sl] += part[name]
        for name in ("states", "subs_to"):
            for mine, theirs in zip(getattr(self, name), part[name]):
                mine[sl] += theirs
        for name in ("cover", "cover_reg"):
            s, pos, d = part[name]
            np.add.at(getattr(self, name), (s, pos), d)

    def finish(self) -> None:
        n = self.length
        flat = lambda c: np.cumsum(c, axis=1)[:, :n].T.reshape(-1)  # noqa: E731
        # reads with a match column there
        self.depth = flat(self.cover) - self.delete
        self.registered = flat(self.cover_reg)
        # reads whose base there is the group's base in their own orientation
        self.read_b = []
        for base, to_b in zip(self.bases, self.subs_to):
            b = gen.BASES[base]
            ref_b = np.stack([self.contig == b, self.contig == gen.COMPLEMENT[b]],
                             axis=1).reshape(-1)
            self.read_b.append(ref_b * (self.depth - self.subs) + to_b)
        # failed calls, over every base
        self.failed = sum(st[:, FILTERED] for st in self.states)

    def fields(self, keys: np.ndarray, g: int, j: int) -> dict:
        """Row fields of code ``j`` of group ``g`` at flat (position,
        strand) keys."""
        st = self.states[g][keys].astype(np.int64)
        mods = st[:, 2:]
        valid = st[:, CANONICAL] + mods.sum(axis=1)
        read_b = self.read_b[g][keys].astype(np.int64)
        failed = self.failed[keys].astype(np.int64)
        return dict(
            valid=valid, n_mod=mods[:, j], n_can=st[:, CANONICAL],
            n_other=mods.sum(axis=1) - mods[:, j],
            n_del=self.delete[keys].astype(np.int64), n_fail=failed,
            n_diff=self.depth[keys] - read_b - (failed - st[:, FILTERED]),
            n_nocall=read_b - st.sum(axis=1),
        )

    def present(self, keys: np.ndarray, g: int) -> np.ndarray:
        st = self.states[g][keys]
        valid = st[:, CANONICAL] + st[:, 2:].sum(axis=1)
        return (valid > 0) & (self.registered[keys] > 0)


def batch_counts(batch: gen.Batch, flags: Flags, precision: str) -> dict:
    """One batch's counts over the reference span its reads cover."""
    lo = int(batch.starts.min())
    hi = int((batch.starts + batch.spans).max())
    rev = batch.reverse.astype(np.int64)

    def hist(keys, k=1, minor=None):
        rel = keys - lo * 2
        idx = rel * k + minor if minor is not None else rel
        h = np.bincount(idx, minlength=(hi - lo) * 2 * k).astype(np.int32)
        return h.reshape(-1, k) if k > 1 else h

    def ref_key(cols):
        r = batch.read_of_col(cols)
        return (batch.starts[r] + cols - batch.col_off[r]) * 2 + rev[r], r

    out = dict(lo=lo, hi=hi, states=[], subs_to=[])
    # deletions and substitutions at their reference positions
    out["delete"] = hist(ref_key(batch.del_col)[0])
    keys, r = ref_key(batch.sub_col)
    out["subs"] = hist(keys)
    reg = np.zeros(len(rev), dtype=bool)
    for c in batch.calls:
        # calls at aligned read bases
        al = c.pos >= 0
        st = call_states(class_probs(c.ml[:, al], c.codes, flags),
                         flags.thresholds[c.base], precision)
        k = 2 + len(flags.codes(c.codes))
        out["states"].append(hist(c.pos[al] * 2 + rev[c.read[al]], k, st))
        b = gen.BASES[c.base]
        to_b = batch.sub_base == np.where(rev[r] == 1, gen.COMPLEMENT[b], b)
        out["subs_to"].append(hist(keys[to_b]))
        reg |= np.bincount(c.read, minlength=len(rev)) > 0
    # every read covers its span; a read that carries calls registers its
    # codes over it: (strand, position, +1/-1) edges
    ends = batch.starts + batch.spans
    one = np.ones(len(rev), dtype=np.int32)
    out["cover"] = (np.concatenate([rev, rev]), np.concatenate([batch.starts, ends]),
                    np.concatenate([one, -one]))
    rr, sr, er = rev[reg], batch.starts[reg], ends[reg]
    out["cover_reg"] = (np.concatenate([rr, rr]), np.concatenate([sr, er]),
                        np.concatenate([one[reg], -one[reg]]))
    out["hist"] = gen.confidence_hist(batch)
    return out


FIELDS = ("valid", "n_mod", "n_can", "n_other", "n_del", "n_fail", "n_diff", "n_nocall")


def rows(counts: Counts, flags: Flags, contig: np.ndarray) -> dict:
    """Row columns in output order: pos, strand (0 +, 1 -, 2 .), code
    index into ``codes`` (modkit's order, by character) and the count
    fields."""
    order = sorted((code, g, j) for g, codes in enumerate(counts.codes)
                   for j, code in enumerate(codes))
    codes = [code for code, _, _ in order]
    if not flags.cpg:
        keys = np.arange(counts.length * 2)
        present = [counts.present(keys, g) for g in range(len(counts.codes))]
        # (key, code) pairs in key order, then code order
        at = np.flatnonzero(np.stack([present[g] for _, g, _ in order], axis=1))
        key, code = at // len(order), at % len(order)
        res = {f: np.zeros(len(at), dtype=np.int64) for f in FIELDS}
        for ci, (_, g, j) in enumerate(order):
            idx = np.flatnonzero(code == ci)
            for f, v in counts.fields(key[idx], g, j).items():
                res[f][idx] = v
        res["pos"] = key // 2
        res["strand"] = key % 2
        res["code"] = code
        res["codes"] = codes
        return res
    if not flags.combine:
        raise ValueError("reference: --cpg without --combine-strands")
    cpg = np.flatnonzero((contig[:-1] == gen.C) & (contig[1:] == gen.G))
    kp, kn = cpg * 2, (cpg + 1) * 2 + 1
    pp, pn = counts.present(kp, 0), counts.present(kn, 0)
    res = {f: [] for f in FIELDS}
    pos, code = [], []
    for ci, (_, g, j) in enumerate(order):
        fp, fn = counts.fields(kp, g, j), counts.fields(kn, g, j)
        any_ = pp | pn
        for f in FIELDS:
            res[f].append((np.where(pp, fp[f], 0) + np.where(pn, fn[f], 0))[any_])
        pos.append(cpg[any_])
        code.append(np.full(int(any_.sum()), ci))
    pos = np.concatenate(pos)
    code = np.concatenate(code)
    order = np.lexsort((code, pos))
    out = {f: np.concatenate(v)[order] for f, v in res.items()}
    out["pos"] = pos[order]
    out["code"] = code[order]
    out["strand"] = np.full(len(pos), 2)
    out["codes"] = codes
    return out


def percent_hundredths(n_mod: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The percent column in hundredths: float32 n_mod / valid * 100,
    rounded to two places half to even on its exact value."""
    v = (n_mod.astype(np.float32) / valid.astype(np.float32)) * np.float32(100)
    return np.rint(v.astype(np.float64) * 100).astype(np.int64)


def _chunk_table() -> np.ndarray:
    """ASCII of 0..999 in three bytes: rows 0-999 zero-padded, 1000-1999
    without leading zeros ("0" for 0), 2000-2999 the same with 0 blank; a
    blank byte is 0."""
    t = np.zeros((3000, 3), dtype=np.uint8)
    for v in range(1000):
        s = str(v).encode()
        t[v] = np.frombuffer(b"%03d" % v, dtype=np.uint8)
        t[1000 + v, 3 - len(s):] = np.frombuffer(s, dtype=np.uint8)
        if v:
            t[2000 + v] = t[1000 + v]
    return t


CHUNKS = _chunk_table()


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """[3 * ceil(width / 3), n] ASCII digits of ``v``, right-aligned, 0
    where a leading zero would be (0 is never part of the text)."""
    k = max(1, -(-width // 3))
    parts = []
    x = v.astype(np.int64)
    for _ in range(k):
        parts.append(x % 1000)
        x = x // 1000
    lead = np.ones(len(v), dtype=bool)
    out = []
    for i, part in enumerate(reversed(parts)):
        last = i == k - 1
        idx = part + np.where(lead, 1000 if last else 2000, 0)
        out.append(CHUNKS_T[:, idx])
        lead &= part == 0
    return np.concatenate(out, axis=0)


CHUNKS_T = np.ascontiguousarray(CHUNKS.T)


def _render_block(r: dict, chrom: bytes, codes: list) -> bytes:
    """modkit's bedMethyl text of a block of rows: every field in a fixed
    width, one text column a row of a [width, rows] matrix, then the
    unused bytes (0) dropped."""
    pos = r["pos"].astype(np.int64)
    n = len(pos)
    pct = percent_hundredths(r["n_mod"], r["valid"])
    code_b = np.frombuffer(b"".join(codes), dtype=np.uint8)[r["code"]]
    strand_b = np.frombuffer(b"+-.", dtype=np.uint8)[r["strand"]]

    def lit(b: bytes):
        return np.broadcast_to(np.frombuffer(b, dtype=np.uint8)[:, None], (len(b), n))

    def num(v):
        return _digits(v, len(str(int(v.max()))) if n else 1)

    p0, p1, valid = num(pos), num(pos + 1), num(r["valid"])
    pieces = [
        lit(chrom + b"\t"), p0, lit(b"\t"), p1, lit(b"\t"), code_b[None, :],
        lit(b"\t"), valid, lit(b"\t"), strand_b[None, :], lit(b"\t"), p0,
        lit(b"\t"), p1, lit(b"\t255,0,0\t"), valid, lit(b"\t"), num(pct // 100),
        lit(b"."), CHUNKS_T[1:, pct % 100],
    ]
    for f in FIELDS[1:]:
        pieces += [lit(b"\t"), num(r[f])]
    pieces.append(lit(b"\n"))
    mat = np.ascontiguousarray(np.concatenate(pieces, axis=0).T)
    return mat[mat != 0].tobytes()


_WORKER: dict = {}


def _worker_init(config, seed, flags, precision) -> None:
    _WORKER.update(config=config, seed=seed, flags=Flags(flags),
                   precision=precision, layout=gen.make_layout(config, seed))


def _batch(b: int) -> gen.Batch:
    w = _WORKER
    return gen.batch_of(w["layout"], w["config"], w["seed"], b)


def _confidence_worker(b: int) -> dict:
    return estimate.read_confidence_hists(_batch(b))


def _count_worker(args) -> dict:
    b, thresholds = args
    w = _WORKER
    w["flags"].thresholds = thresholds
    return batch_counts(_batch(b), w["flags"], w["precision"])


def _render_worker(args) -> bytes:
    block, chrom = args
    return _render_block(block, chrom.encode(), [c.encode() for c in block["codes"]])


def reference_bedmethyl(config: dict, seed: int, flags: list,
                        precision: str = "f32", workers: int = 1,
                        block: int = 1 << 19,
                        sampled: dict | None = None) -> tuple[bytes, int, dict]:
    """(bedMethyl bytes, rows, the threshold of each called base) of a
    cell's pileup, worked out from the truth of ``seed`` on ``workers``
    processes. Checks that the thresholds handed to the program are the
    ones the truth gives (``gen.generate``'s); without them, estimates
    them as modkit does, and puts what ``estimate.estimate`` found (the
    sampled reads, their pooled confidences, the thresholds) into
    ``sampled`` where that is given."""
    import multiprocessing as mp

    fl = Flags(flags)
    data = config["data"]
    groups = gen.call_groups(config)
    bases = [g["base"] for g in groups]
    if fl.thresholds and set(fl.thresholds) != set(bases):
        raise ValueError(f"reference: thresholds for {sorted(fl.thresholds)} "
                         f"where the calls are on {sorted(bases)}")
    if fl.cpg and bases != ["C"]:
        raise ValueError("reference: --cpg is implemented for calls on C alone")
    layout = gen.make_layout(config, seed)
    counts = Counts(layout.contig, [(g["base"], fl.codes(g["codes"])) for g in groups])
    hist = {b: np.zeros(513, dtype=np.int64) for b in bases}
    batches = range(gen.batch_count(config))
    with mp.get_context("spawn").Pool(
            workers, initializer=_worker_init,
            initargs=(config, seed, flags, precision)) as pool:
        t = fl.thresholds
        if not t:
            hists = list(pool.imap(_confidence_worker, batches))
            est = estimate.estimate(
                layout.starts, layout.spans,
                {b: np.concatenate([h[b] for h in hists]) for b in bases},
                len(layout.contig), fl.num_reads, fl.filter_percentile,
                fl.sampling_interval)
            t = est["thresholds"]
            if sampled is not None:
                sampled.update(est)
        for part in pool.imap_unordered(_count_worker, [(b, t) for b in batches]):
            for b in bases:
                hist[b] += part["hist"][b]
            counts.merge(part)
        counts.finish()
        if fl.thresholds:
            pct = float(config["filter_percentile"])
            truth = {b: gen.threshold_from_hist(hist[b], pct) for b in bases}
            if truth != fl.thresholds:
                raise ValueError(
                    f"reference: thresholds {fl.thresholds} are not the truth's {truth}")
        res = rows(counts, fl, layout.contig)
        n = len(res["pos"])
        blocks = [({k: (v[a:a + block] if isinstance(v, np.ndarray) else v)
                    for k, v in res.items()}, data["contig_name"])
                  for a in range(0, n, block)]
        text = b"".join(pool.imap(_render_worker, blocks))
    return text, n, dict(t)
