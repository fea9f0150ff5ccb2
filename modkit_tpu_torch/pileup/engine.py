"""Pileup tile engine: reads -> events -> device calls -> bedMethyl rows.

Replaces the reference's per-column htslib pileup loop (pileup/mod.rs:718
process_region) with a tiled host-batch + device-aggregate design: reads are
fetched per genome tile and decoded to flat event arrays (natively in C++,
or by events.py on the Python route), the per-event threshold call runs on
the CUDA device (ops/state.py, or the fused call + count of ops/counts.py on
the Python route), and the counts decode into bedMethyl rows per (position,
strand, primary base, observed mod code).

The port of modkit_tpu/pileup/engine.py. On a CUDA device every kernel
launches or raises; on the CPU device the kernels' plain PyTorch versions
run, which is what the CPU tests compare with modkit_tpu.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from itertools import chain
from operator import itemgetter

import numpy as np
import torch

from .. import tracing
from ..caller import ThresholdCaller
from ..errors import ErrorTally, ModKitError
from ..modcodes import DNA_BASES, any_mod_code, mod_code_sort_key
from ..motifs import STRAND_BOTH
from ..ops.counts import counts_layout, modcall_counts, round_up_codes
from ..ops.state import (
    threshold_state_f32, threshold_state_quals_t, thresholds_to_tensors,
)
from .events import EdgeFilter, read_to_events, skipped_read_events


@dataclass(slots=True)
class PileupRow:
    """One bedMethyl row (pileup/mod.rs:55 PileupFeatureCounts)."""

    pos: int
    strand: str  # '+', '-', '.'
    mod_code: object
    valid_coverage: int
    fraction_modified: float  # computed in f32
    n_modified: int
    n_canonical: int
    n_other_modified: int
    n_delete: int
    n_filtered: int
    n_diff: int
    n_nocall: int
    motif_idx: int | None = None


@dataclass(slots=True)
class ColumnarRows:
    """bedMethyl rows in columnar (struct-of-arrays) form, already in
    output order. Vectorized form of decode_counts (and, strands combined,
    of combine_strand_rows); consumed by BedMethylWriter.write_columnar."""

    pos: np.ndarray  # int64 absolute genome positions
    strand: np.ndarray  # int8 0 '+', 1 '-', 2 '.'
    code_idx: np.ndarray  # int32 index into labels
    labels: list  # code label strings per index
    valid: np.ndarray
    n_mod: np.ndarray
    n_can: np.ndarray
    n_other: np.ndarray
    n_del: np.ndarray
    n_filt: np.ndarray
    n_diff: np.ndarray
    n_nocall: np.ndarray
    motif_idx: np.ndarray  # int32 motif id of the row's label, -1 none

    def __len__(self) -> int:
        return len(self.pos)

    def percent_strings(self) -> list:
        """``{:.2}`` of f32 fraction*100 per row (writers.rs:140)."""
        f32 = np.float32
        pv = (
            self.n_mod.astype(f32) / self.valid.astype(f32)
        ) * f32(100.0)
        return [format(v, ".2f") for v in pv.astype(np.float64).tolist()]


@dataclass(slots=True)
class FormattedRows:
    """bedMethyl rows already rendered to text (native fast path)."""

    text: bytes
    n_rows: int

    def __len__(self) -> int:
        return self.n_rows


@dataclass
class PileupOptions:
    combine_mods: bool = False  # PileupNumericOptions::Combine
    collapse: list = field(default_factory=list)  # CollapseMethod list
    edge_filter: EdgeFilter | None = None
    force_allow: bool = False
    combine_strands: bool = False
    max_depth: int = 8000
    # SAM tags whose joined values partition the output (--partition-tag,
    # pileup/mod.rs:607 PartitionKey + :795 parse_tags_from_record)
    partition_tags: list | None = None
    # focus positions / motifs are handled by the caller (engine processes
    # every covered position when focus is None)
    # use the native C++ tile decoder when available (None = auto)
    use_native: bool | None = None
    # native inflate/decode threads per tile (None = min(cpus, 8)); the
    # runner divides cores across its launch workers so concurrent tiles
    # don't oversubscribe the host
    decode_threads: int | None = None
    # the run's device ("cuda", "cuda:N" or "cpu"); tiles round-robin over
    # parallel.devices.compute_devices(device)
    device: object = "cuda"


@dataclass
class TilePending:
    """A launched tile: in-flight device counts + host-side context needed
    to decode rows once the kernel result lands (finish_tile)."""

    modc: object  # [p, 2, Km] counts: numpy, or a host tensor in flight
    nc_counts: np.ndarray | None  # [p, 2, 4] host nocall bincount
    del_counts: np.ndarray | None  # [p, 2] host delete bincount
    observed: np.ndarray | None  # [p, 2, 4, m] mask (None with native tile)
    vocab: list
    start: int
    p: int
    focus: object
    native: object = None  # NativeTile keeping the decoded tile alive
    states: object = None  # u8 per-event states (native path): numpy, or
    # a host tensor in flight
    m_pad: int = 0
    # CUDA event that completes when the in-flight host copy of modc or
    # states has landed (None: already on the host)
    ready: object = None
    # partition mode: tile-local key list (None entry = the NoKey group);
    # the position axis is folded as pos + part_idx * base_p
    parts: list | None = None
    base_p: int = 0


class TileProcessor:
    """Processes genome tiles; caches read decode across tiles of a contig.

    The reference re-decodes reads per interval fetch (ReadCache is per
    region); we cache by read name+pos since event extraction is read-global.
    """

    def __init__(self, caller: ThresholdCaller, opts: PileupOptions):
        self.caller = caller
        self.opts = opts
        self.errors = ErrorTally()
        self._cache: dict = {}
        self._cache_tid: int | None = None
        self.n_used = 0
        self.n_skipped = 0
        # the run's native.BlockCache of the reader's BAM (run_pileup sets
        # it): a tile copies the blocks that another tile already inflated
        self.block_cache = None
        self._dev_rr = 0  # round-robin tile -> device assignment
        # guards counters when tiles launch from parallel host workers
        self._stats_lock = threading.Lock()
        from ..parallel.devices import compute_devices

        self.devices = compute_devices(opts.device)
        # each launching thread owns one CUDA stream per device
        self._tls = threading.local()

    def _next_device(self) -> torch.device:
        """Next local device for this tile's kernel dispatch (tiles-axis
        data parallelism across cards, SURVEY §2.5 row 1)."""
        if len(self.devices) == 1:
            return self.devices[0]
        with self._stats_lock:
            d = self.devices[self._dev_rr % len(self.devices)]
            self._dev_rr += 1
        return d

    def _on_device(self, dev: torch.device):
        """Context for one tile's device work: on CUDA the device and this
        thread's own stream on it, so tiles launched from parallel workers
        overlap; nothing on the CPU."""
        if dev.type != "cuda":
            return nullcontext()
        streams = getattr(self._tls, "streams", None)
        if streams is None:
            streams = self._tls.streams = {}
        stream = streams.get(dev.index)
        if stream is None:
            stream = streams[dev.index] = torch.cuda.Stream(device=dev)
        return _cuda_stream_context(dev, stream)

    def _events_for(self, rec, tid):
        if tid != self._cache_tid:
            self._cache.clear()
            self._cache_tid = tid
        key = (rec.name, rec.pos, rec.flag)
        ev = self._cache.get(key)
        if ev is None:
            try:
                ev = read_to_events(
                    rec,
                    collapse_methods=self.opts.collapse,
                    edge_filter=self.opts.edge_filter,
                    force_allow=self.opts.force_allow,
                )
                self.n_used += 1
            except ModKitError as e:
                self.errors.add(e)
                ev = skipped_read_events(rec)
                self.n_skipped += 1
            if len(self._cache) > 4096:
                self._cache.clear()
            self._cache[key] = ev
        return ev

    def process_tile(
        self, reader, tid: int, start: int, end: int, focus=None
    ) -> list[tuple[int, list[PileupRow]]]:
        """Blocking launch+finish of one tile (see launch_tile)."""
        return self.finish_tile(
            self.launch_tile(reader, tid, start, end, focus)
        )

    def _use_native(self) -> bool:
        if self.opts.use_native is False:
            return False
        from .. import native

        return native.available()

    def launch_tile(
        self, reader, tid: int, start: int, end: int, focus=None
    ) -> "TilePending":
        """Fetch + decode a tile's reads and dispatch the device kernel
        without blocking; host-side coverage bincounts and observed-code
        painting run while the device computes. ``finish_tile`` materializes
        the counts and decodes rows, so a caller can keep the next tile's
        launch overlapped with this tile's device work.

        ``focus`` (motifs.FocusPositions or a rule array wrapper) restricts
        counted columns to focus positions with strand-rule routing
        (pileup/mod.rs:580-603 PileupIter + FeatureVector strand rules).

        Tile event assembly runs in the native C++ decoder when available
        (modkit_tpu.native), with this Python path as oracle/fallback.
        """
        focus_rule = focus.rule if focus is not None else None
        if self._use_native() and hasattr(reader, "bam_raw"):
            from .. import native

            # BGZF blocks inflate inside the native thread pool with early
            # stop past the tile end (feed-ceiling fix — the Python fetch
            # inflated whole BAI chunks, ~2x the tile's share on WGS data)
            chunks = reader.fetch_chunk_voffsets(tid, start, end)
            with tracing.span("decode"):
                res = native.decode_tile_bgzf(
                    reader.bam_raw,
                    chunks,
                    tid, start, end,
                    max_depth=self.opts.max_depth or 0,
                    force_allow=self.opts.force_allow,
                    edge_filter=self.opts.edge_filter,
                    collapse=self.opts.collapse,
                    focus_rule=focus_rule,
                    partition_tags=self.opts.partition_tags,
                    n_threads=self.opts.decode_threads,
                    block_cache=self.block_cache,
                )
                native.release_pages(reader.bam_raw, chunks)
            if res is not None:
                tracing.count("reads_decoded", res.n_used + res.n_skipped)
                tracing.count("events", res.n_events)
                tracing.count("aligned_columns", res.aligned_columns)
                tracing.count("walked_columns", res.walked_columns)
                tracing.count("bgzf_blocks", res.bgzf_blocks)
                tracing.count("bgzf_blocks_reused", res.bgzf_blocks_reused)
                with self._stats_lock:
                    self.n_used += res.n_used
                    self.n_skipped += res.n_skipped
                    for kind, n in res.errors.items():
                        self.errors[kind] += n
                if res.n_used + res.n_skipped == 0 and res.n_events == 0:
                    return None
                return self._dispatch_native_tile(
                    res, start, end - start, focus
                )  # partition fold handled inside via res.n_parts

        ptags = self.opts.partition_tags
        reads = []
        pkeys: list[int] = []  # per-read partition slot
        parts: list = []  # tile-local key list (None = NoKey/"ungrouped")
        pindex: dict = {}
        decoded = self.n_used + self.n_skipped
        with tracing.span("decode"):
            for rec in reader.fetch(tid, start, end):
                if rec.is_not_primary or rec.l_seq == 0:
                    continue
                reads.append(self._events_for(rec, tid))
                if ptags:
                    key = partition_key_for(rec, ptags)
                    pidx = pindex.get(key)
                    if pidx is None:
                        pidx = pindex[key] = len(parts)
                        parts.append(key)
                    pkeys.append(pidx)
        # this route launches from one thread: the decoder's counts are the
        # tile's alone (a read decodes once, for its first tile)
        tracing.count("reads_decoded", self.n_used + self.n_skipped - decoded)
        if not reads:
            return None
        n_parts = max(len(parts), 1) if ptags else 1

        # tile-wide code vocabulary, insertion order across reads
        vocab: list = []
        vindex: dict = {}
        for ev in reads:
            for c in ev.codes:
                if c not in vindex:
                    vindex[c] = len(vocab)
                    vocab.append(c)
        m = max(len(vocab), 1)
        p = end - start

        # --max-depth: cap reads contributing per column at max_depth,
        # keeping the first reads in file (position) order per column
        # (pileup/mod.rs:755-758 htslib set_max_depth semantics); no column
        # can exceed the cap when the tile holds <= max_depth reads
        depth_masks = None
        if self.opts.max_depth and len(reads) > self.opts.max_depth:
            depth_masks = []
            cov = np.zeros(p, dtype=np.int32)
            for ev in reads:
                adm = np.zeros(p, dtype=bool)
                if ev.cover is not None:
                    for a, b_ in ev.cover:
                        a2 = max(int(a) - start, 0)
                        b2 = min(int(b_) - start, p)
                        if a2 < b2:
                            sl = cov[a2:b2] < self.opts.max_depth
                            adm[a2:b2] = sl
                            cov[a2:b2] += sl
                depth_masks.append(adm)

        # assemble sparse mod-call event arrays clipped to the tile; dense
        # nocall/delete features are plain histograms counted host-side
        rpos_l, strand_l, base_l, probs_l = [], [], [], []
        nc_keys, del_keys = [], []
        focus_rule = focus.rule if focus is not None else None
        for ri, ev in enumerate(reads):
            s = ev.aln_strand
            adm = depth_masks[ri] if depth_masks is not None else None
            off = pkeys[ri] * p if ptags else 0
            if len(ev.mod_rpos):
                sel = (ev.mod_rpos >= start) & (ev.mod_rpos < end)
                if sel.any() and (focus_rule is not None or adm is not None):
                    li = (ev.mod_rpos - start)[sel]
                    keep = np.ones(len(li), dtype=bool)
                    if focus_rule is not None:
                        r = focus_rule[li]
                        keep &= (r == 2) | (r == ev.mod_out[sel])
                    if adm is not None:
                        keep &= adm[li]
                    s2 = np.zeros(len(ev.mod_rpos), dtype=bool)
                    s2[np.flatnonzero(sel)[keep]] = True
                    sel = s2
                if sel.any():
                    rpos_l.append(ev.mod_rpos[sel] - start + off)
                    strand_l.append(ev.mod_out[sel])
                    base_l.append(ev.mod_base[sel])
                    pr = np.full(
                        (int(sel.sum()), m), -1.0, dtype=np.float32
                    )
                    if ev.mod_probs.shape[1]:
                        cols = [vindex[c] for c in ev.codes]
                        pr[:, cols] = ev.mod_probs[sel]
                    probs_l.append(pr)
            if len(ev.nc_rpos):
                li = ev.nc_rpos - start
                sel = (li >= 0) & (li < p)
                if focus_rule is not None:
                    r = focus_rule[np.clip(li, 0, p - 1)]
                    sel &= (r == 2) | (r == s)
                if adm is not None:
                    sel &= adm[np.clip(li, 0, p - 1)]
                if sel.any():
                    nc_keys.append(
                        ((li[sel] + off) * 2 + s) * 4 + ev.nc_base[sel]
                    )
            if len(ev.del_rpos):
                li = ev.del_rpos - start
                sel = (li >= 0) & (li < p)
                if focus_rule is not None:
                    r = focus_rule[np.clip(li, 0, p - 1)]
                    sel &= (r == 2) | (r == s)
                if adm is not None:
                    sel &= adm[np.clip(li, 0, p - 1)]
                if sel.any():
                    del_keys.append((li[sel] + off) * 2 + s)

        # partition mode folds the key into the position axis so one kernel
        # dispatch covers every partition: pos' = pos + part_idx * p
        p_total = n_parts * p

        # dispatch the device kernel FIRST so coverage bincounts + observed
        # painting below overlap device compute / D2H transfer
        ready = None
        if rpos_l:
            with tracing.span("export"):
                rpos = np.concatenate(rpos_l).astype(np.int32)
                strand = np.concatenate(strand_l).astype(np.int32)
                base_idx = np.concatenate(base_l).astype(np.int32)
                probs = np.concatenate(probs_l, axis=0)
            tracing.count("events", len(rpos))
            thr_mod, thr_can = self.caller.threshold_arrays(vocab or ["m"])
            # probs pad to m_pad classes (-1 = absent), so the counts come
            # back as Km(m_pad), the layout assemble_counts reads
            m_pad = round_up_codes(m)
            probs_p = np.pad(
                probs, ((0, 0), (0, m_pad - m)), constant_values=-1.0
            ).astype(np.float32)
            thr_mod_t, thr_can_t = thresholds_to_tensors(
                thr_mod[:m], thr_can, m_pad
            )
            dev = self._next_device()
            with self._on_device(dev):
                with tracing.span("upload"):
                    probs_d, rpos_d, strand_d, base_d = _upload(
                        [probs_p, rpos, strand, base_idx], dev
                    )
                with tracing.span("dispatch"):
                    modc, ready = _to_host_async(
                        modcall_counts(
                            rpos_d, strand_d, base_d, probs_d,
                            thr_mod_t, thr_can_t, p_total,
                        )
                    )
        else:
            modc = np.zeros((p_total, 2, 1 + 4 * (m + 1)), dtype=np.int32)

        nc_counts = del_counts = None
        if nc_keys:
            nc_counts = np.bincount(
                np.concatenate(nc_keys), minlength=p_total * 2 * 4
            ).astype(np.int32).reshape(p_total, 2, 4)
        if del_keys:
            del_counts = np.bincount(
                np.concatenate(del_keys), minlength=p_total * 2
            ).astype(np.int32).reshape(p_total, 2)

        # observed codes per (pos, strand, base): painted over each read's
        # covered intervals (read_cache.rs:298 add_mod_codes_for_record)
        observed = np.zeros((p_total, 2, 4, m), dtype=bool)
        for ri, ev in enumerate(reads):
            if not ev.registered or ev.cover is None or not len(ev.cover):
                continue
            adm = depth_masks[ri] if depth_masks is not None else None
            off = pkeys[ri] * p if ptags else 0
            for (sk, tb), codes in ev.registered.items():
                cols = [vindex[c] for c in codes]
                if not cols:
                    continue
                for a, b_ in ev.cover:
                    a2, b2 = max(a - start, 0), min(b_ - start, p)
                    if a2 >= b2:
                        continue
                    if adm is not None:
                        rows = np.flatnonzero(adm[a2:b2]) + (a2 + off)
                        for c in cols:
                            observed[rows, sk, tb, c] = True
                    else:
                        for c in cols:
                            observed[a2 + off : b2 + off, sk, tb, c] = True

        return TilePending(
            modc, nc_counts, del_counts, observed, vocab, start, p_total,
            focus, parts=(parts if ptags else None), base_p=p, ready=ready,
        )

    def _dispatch_native_tile(
        self, res, start, p, focus
    ) -> "TilePending":
        """Launch the device threshold-state kernel over a NativeTile's
        events. Only one u8 per event returns over the device link; the
        count histogram runs natively at finish time (mk_bincount_full).
        The tile's events upload at their own count n (no padding) in the
        compact class-major u8 encoding when probabilities are exact ML
        values, f32 otherwise (collapse / merged codes)."""
        vocab = res.vocab
        m = max(len(vocab), 1)
        n = res.n_events
        modc = None
        states = None
        ready = None
        m_pad = round_up_codes(m)
        route = "none"
        if n:
            thr_mod, thr_can = self.caller.threshold_arrays(vocab or ["m"])
            thr_mod_p = np.pad(thr_mod[:m], ((0, m_pad - m), (0, 0)))
            thr_mod_p = thr_mod_p.astype(np.float32)
            thr_can = thr_can.astype(np.float32)
            thr_mod_t, thr_can_t = thresholds_to_tensors(
                thr_mod_p, thr_can, m_pad
            )
            dev = self._next_device()
            with tracing.span("export"):
                route, q = "quals", res.export_quals_t(n, m_pad)
                if q is None:
                    _, _, base_idx, probs = res.export_events(n, m_pad)
                    route, q = "f32", (probs, base_idx.astype(np.uint8))
            with self._on_device(dev):
                with tracing.span("upload"):
                    up = _upload(list(q), dev)
                with tracing.span("dispatch"):
                    if route == "quals":
                        st = threshold_state_quals_t(
                            *up, thr_mod_t, thr_can_t
                        )
                    else:
                        st = threshold_state_f32(
                            *up, thr_mod_t, thr_can_t
                        )
                    states, ready = _to_host_async(st)
        else:
            modc = np.zeros((res._p, 2, 1 + 4 * (m_pad + 1)), dtype=np.int32)
        tracing.count("m_pad", m_pad)
        tracing.count("route", tracing.ROUTES.index(route))
        # with per-event states the nc/del channels come out of
        # bincount_full directly — skip the host copies at launch
        nc = res.nc_counts if states is None else None
        dl = res.del_counts if states is None else None
        # partition mode: the native tile folded the key into the position
        # axis (p_total = n_parts * p); expose the key list for finish
        parts = res.part_keys if self.opts.partition_tags else None
        return TilePending(
            modc, nc, dl, None, vocab, start, res._p,
            focus, native=res, states=states, m_pad=m_pad,
            parts=parts, base_p=p, ready=ready,
        )

    def assemble_counts(self, pending: "TilePending") -> np.ndarray:
        """Merge in-flight device mod-call counts with the host coverage
        histograms into the full count tensor [p, 2, 6 + 4*(m_pad+1)]."""
        with tracing.span("device_wait"):
            if pending.ready is not None:
                # the tile's D2H copy into pinned host memory has landed
                pending.ready.synchronize()
        with tracing.span("histogram"):
            return self._histogram(pending)

    def _histogram(self, pending: "TilePending") -> np.ndarray:
        p = pending.p
        if pending.states is not None:
            # per-event states from kernel A (or its plain version on the
            # CPU): one native pass histograms them straight into the full
            # count layout, including the nocall/delete channels
            states = _host_numpy(pending.states)
            return pending.native.bincount_full(states, pending.m_pad)
        modc = _host_numpy(pending.modc)[:p]
        m_pad = (modc.shape[2] - 1) // 4 - 1
        k = 6 + 4 * (m_pad + 1)
        counts = np.zeros((p, 2, k), dtype=np.int32)
        counts[:, :, 1] = modc[:, :, 0]
        counts[:, :, 6:] = modc[:, :, 1:]
        if pending.nc_counts is not None:
            counts[:, :, 2:6] = pending.nc_counts
        if pending.del_counts is not None:
            counts[:, :, 0] = pending.del_counts
        return counts

    def _observed(self, pending: "TilePending") -> np.ndarray:
        if pending.observed is not None:
            return pending.observed
        return pending.native.observed

    def finish_tile(
        self, pending: "TilePending | None", chrom: str | None = None,
        space: str = "\t",
    ):
        """Materialize a launched tile's device counts and decode rows.

        With ``chrom`` given and the no-focus fast path applicable, returns
        FormattedRows (bedMethyl text bytes rendered natively); otherwise
        ColumnarRows or a list of (pos, rows).
        """
        if pending is None:
            return []
        counts = self.assemble_counts(pending)
        with tracing.span("format"):
            return self._rows(pending, counts, chrom, space)

    def _rows(self, pending: "TilePending", counts: np.ndarray, chrom, space):
        if pending.parts is not None:
            # partition mode: slice the folded position axis back into one
            # count tensor per partition key and decode each independently
            # (the per-key FeatureVector maps of pileup/mod.rs:821-828)
            p0 = pending.base_p
            obs = self._observed(pending)
            out = []
            for pidx, key in enumerate(pending.parts):
                c = counts[pidx * p0 : (pidx + 1) * p0]
                o = obs[pidx * p0 : (pidx + 1) * p0]
                if pending.focus is None and not self.opts.combine_strands:
                    res = decode_counts_columnar(
                        c, o, pending.vocab, pending.start,
                        combine_mods=self.opts.combine_mods,
                    )
                else:
                    res = decode_counts(
                        c, o, pending.vocab, pending.start,
                        combine_mods=self.opts.combine_mods,
                        focus=pending.focus,
                    )
                    if self.opts.combine_strands and pending.focus is not None:
                        res = combine_strand_rows(res, pending.focus)
                out.append((key, res))
            _count_format_route("rows")
            return out

        plain = pending.focus is None and not self.opts.combine_strands
        if plain:
            if (
                pending.native is not None
                and chrom is not None
                and (pending.vocab or self.opts.combine_mods)
            ):
                from .. import native

                order = np.asarray(
                    sorted(
                        range(len(pending.vocab)),
                        key=lambda i: mod_code_sort_key(pending.vocab[i]),
                    ),
                    dtype=np.int32,
                )
                out = native.format_rows(
                    counts, pending.native.observed_raw(), pending.vocab,
                    order, pending.start, chrom, self.opts.combine_mods,
                    space,
                )
                if out is not None:
                    _count_format_route("text")
                    return FormattedRows(out[0], out[1])
        if plain or chrom is not None:
            # ``chrom`` comes with a bedMethyl writer, which renders the
            # motif route's columns too (labels, strand '.')
            _count_format_route(
                "columnar" if pending.focus is None else "columnar_motif"
            )
            return decode_counts_columnar(
                counts, self._observed(pending), pending.vocab,
                pending.start, combine_mods=self.opts.combine_mods,
                focus=pending.focus,
                combine_strands=self.opts.combine_strands,
            )
        _count_format_route("rows")
        decoded = decode_counts(
            counts, self._observed(pending), pending.vocab, pending.start,
            combine_mods=self.opts.combine_mods,
            focus=pending.focus,
        )
        if self.opts.combine_strands and pending.focus is not None:
            decoded = combine_strand_rows(decoded, pending.focus)
        return decoded


def _count_format_route(route: str) -> None:
    tracing.count("format_route", tracing.FORMAT_ROUTES.index(route))


@contextmanager
def _cuda_stream_context(dev: torch.device, stream):
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _upload(arrays: list, dev: torch.device) -> list:
    """Numpy arrays as tensors on ``dev``. On CUDA they pack into one
    pinned staging buffer (16-byte aligned slots) and cross in one
    non-blocking copy on the current stream; the caching host allocator
    keeps the buffer until that copy has run."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets = []
    total = 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 16) * 16
    # on the CPU nothing crosses: the count is what would
    tracing.count("bytes_up", total)
    if dev.type != "cuda":
        return [torch.from_numpy(a) for a in arrays]
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    hv = host.numpy()
    for a, off in zip(arrays, offsets):
        hv[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(dev, non_blocking=True)
    return [
        buf[off : off + a.nbytes]
        .view(torch.from_numpy(a[:0].reshape(-1)).dtype)
        .view(a.shape)
        for a, off in zip(arrays, offsets)
    ]


def _to_host_async(t: torch.Tensor):
    """(host tensor, event): on CUDA a non-blocking copy into pinned host
    memory on the current stream and an event recorded after it; on the
    CPU the tensor itself and no event."""
    tracing.count("bytes_down", t.numel() * t.element_size())
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _host_numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def partition_key_for(rec, tags) -> str | None:
    """Join the record's stringable values for ``tags`` with '_', using
    'missing' for absent tags; None when no tag matches (NoKey)
    (pileup/mod.rs:626 parse_tags_from_record + util.rs:670
    get_stringable_aux: strings/chars/ints/floats stringify, arrays don't).
    """
    vals = []
    got = False
    for t in tags:
        item = rec.get_aux(t)
        if item is None or item[0].startswith("B"):
            vals.append("missing")  # absent or array-valued: not stringable
            continue
        typ, v = item
        if typ == "f":
            from ..writers import format_float

            vals.append(format_float(v))
        else:
            vals.append(str(v))
        got = True
    return "_".join(vals) if got else None


def decode_counts_columnar(
    counts: np.ndarray,
    observed: np.ndarray,
    vocab: list,
    tile_start: int,
    combine_mods: bool = False,
    focus=None,
    combine_strands: bool = False,
) -> ColumnarRows:
    """Vectorized count tensor -> columnar bedMethyl rows.

    Emits exactly the rows of ``decode_counts`` — one row per (position,
    strand, primary base, observed mod code), sorted within a position by
    (strand, mod-code order) — but as flat numpy columns built with a
    handful of array ops instead of a Python row loop (pileup/mod.rs:412
    FeatureVector::decode equivalence unchanged).

    With ``focus`` only the focus positions are read, each row repeats
    once per motif id of its position and strand, and with
    ``combine_strands`` the rows are those of ``combine_strand_rows``
    (pileup/mod.rs:469): each '+' focus position summed with its motif's
    '-' partner into strand '.'.
    """
    p, _, k = counts.shape
    m = len(vocab)
    if focus is None:
        r, j, labels, cols = _decode_cells(
            counts.reshape(2 * p, k), observed.reshape(2 * p, 4, m), vocab,
            combine_mods,
        )
        order = np.lexsort((_label_rank(labels)[j], r))
        return ColumnarRows(
            tile_start + (r[order] >> 1).astype(np.int64),
            (r[order] & 1).astype(np.int8), j[order], labels,
            *(c[order] for c in cols),
            np.full(len(order), -1, dtype=np.int32),
        )
    if combine_strands:
        return _combined_columnar(
            counts, observed, vocab, tile_start, combine_mods, focus,
        )
    # the focus positions' count rows, one per (position, strand) that
    # the strand rule admits; no other position is read
    fi = np.flatnonzero(focus.rule[:p] >= 0)
    rule = focus.rule[fi, None]
    strand_ok = (rule == STRAND_BOTH) | (rule == np.arange(2))
    r, j, labels, cols = _decode_cells(
        counts[fi].reshape(-1, k), observed[fi].reshape(-1, 4, m),
        vocab, combine_mods, strand_ok.reshape(-1),
    )
    # one row per motif id of the row's position and strand, in the id
    # list's order; none (-1) where the list is empty
    n_ids, first, ids = _motif_id_table(focus, fi, tile_start)
    n = np.maximum(n_ids[r], 1)
    rep = np.repeat(np.arange(len(r)), n)
    k_in = np.arange(len(rep)) - np.repeat(np.cumsum(n) - n, n)
    rr = r[rep]
    at = np.where(n_ids[rr] > 0, first[rr] + k_in, len(ids))
    motif = np.append(ids, -1).astype(np.int32)[at]
    j = j[rep]
    order = np.lexsort((_label_rank(labels)[j], rr))
    return ColumnarRows(
        tile_start + fi[rr[order] >> 1].astype(np.int64),
        (rr[order] & 1).astype(np.int8), j[order], labels,
        *(c[rep][order] for c in cols), motif[order],
    )


def _combined_columnar(counts, observed, vocab, tile_start, combine_mods,
                       focus) -> ColumnarRows:
    """The rows of ``combine_strand_rows``: for each (positive focus
    position, motif id) of a palindromic motif, its '+' rows and its
    partner's '-' rows summed per mod code, at the positive position with
    strand '.', ordered by (position, the motif's place in the position's
    list, mod-code order)."""
    p = counts.shape[0]
    pm = focus.positive_motifs
    entries = list(chain.from_iterable(pm.values()))
    ppos, mid = _id_entries(pm, map(itemgetter(1), entries))
    # the '-' partner lies a fixed distance from the '+' focus position
    # (Motif.negative_strand_position); non-palindromes have none
    n_motifs = int(mid.max()) + 1 if len(mid) else 1
    shift = np.zeros(n_motifs, dtype=np.int64)
    palindrome = np.zeros(n_motifs, dtype=bool)
    for i in np.unique(mid, return_index=True)[1].tolist():
        motif, idx = entries[i]
        palindrome[idx] = motif.is_palindrome
        shift[idx] = motif.reverse_offset - motif.forward_offset
    npos = ppos + shift[mid]
    # pairs in (position, place in the position's list) order
    order = np.argsort(ppos, kind="stable")
    order = order[palindrome[mid[order]] & (npos[order] >= 0)]
    ppos, npos, mid = ppos[order], npos[order], mid[order]
    # the '-' side counts where its position is in the tile and carries
    # the motif id
    neg_pos, neg_mid = _id_entries(focus.neg_motif_ids)
    lp, ln = ppos - tile_start, npos - tile_start
    has_neg = (ln >= 0) & (ln < p) & np.isin(
        npos * n_motifs + mid, neg_pos * n_motifs + neg_mid
    )
    ln[~has_neg] = 0
    n_pairs = len(lp)
    r, j, labels, cols = _decode_cells(
        np.concatenate((counts[lp, 0], counts[ln, 1])),
        np.concatenate((observed[lp, 0], observed[ln, 1])), vocab,
        combine_mods, np.concatenate((np.ones(n_pairs, dtype=bool), has_neg)),
    )
    # one row per (pair, mod code): its '+' and '-' cells summed
    n_lab = max(len(labels), 1)
    key = r % max(n_pairs, 1) * n_lab + _label_rank(labels)[j]
    by_key = np.argsort(key, kind="stable")
    key = key[by_key]
    starts = np.flatnonzero(np.diff(key, prepend=-1))
    pi = key[starts] // n_lab
    return ColumnarRows(
        ppos[pi], np.full(len(pi), 2, dtype=np.int8), j[by_key[starts]],
        labels,
        *(np.add.reduceat(c[by_key], starts) if len(starts) else c
          for c in cols),
        mid[pi].astype(np.int32),
    )


def _decode_cells(rows, observed, vocab, combine_mods, keep=None):
    """The cells of count rows ``rows`` [R, K] (each one position's one
    strand; ``observed`` [R, 4, m]) that decode to a bedMethyl row
    (pileup/mod.rs:412): each primary base with valid calls and, on it,
    each observed code, or with ``combine_mods`` one any-mod code.
    ``keep`` [R] drops rows. Returns (row, label index, labels, columns)
    in (row, base, code) order, the columns being valid, n_mod, n_can,
    n_other, n_del, n_filt, n_diff and n_nocall."""
    n_rows, k = rows.shape
    m_pad = (k - 6) // 4 - 1
    body = rows[:, 6:].reshape(n_rows, 4, m_pad + 1)
    can_nd = body[..., 0]  # [R, 4]
    mods_nd = body[..., 1:]  # [R, 4, m_pad]
    nocall_nd = rows[:, 2:6]
    mods_sum = mods_nd.sum(axis=2, dtype=np.int64)
    valid_nd = can_nd + mods_sum
    total_valid = valid_nd.sum(axis=1)
    total_nocall = nocall_nd.sum(axis=1, dtype=np.int64)
    has = valid_nd > 0
    if keep is not None:
        has &= keep[:, None]

    if combine_mods:
        r, b = np.nonzero(has)
        j = b.astype(np.int32)  # one any-mod row per base
        labels = [any_mod_code(bb) for bb in DNA_BASES]
        n_can = can_nd[r, b]
        n_mod = valid_nd[r, b] - n_can
        n_other = np.zeros(len(r), dtype=np.int64)
    else:
        if not vocab:
            e = np.empty(0, dtype=np.int64)
            return e, e.astype(np.int32), [], (e,) * 8
        r, b, j = np.nonzero(observed & has[..., None])
        j = j.astype(np.int32)
        labels = list(vocab)
        n_mod = mods_nd[r, b, j]
        n_other = mods_sum[r, b] - n_mod
        n_can = can_nd[r, b]

    valid = valid_nd[r, b]
    n_nocall = nocall_nd[r, b]
    n_diff = (total_valid[r] - valid) + (total_nocall[r] - n_nocall)
    return r, j, labels, (
        valid, n_mod, n_can, n_other, rows[r, 0], rows[r, 1], n_diff, n_nocall,
    )


def _motif_id_table(focus, fi, tile_start):
    """The motif ids of each focus row (focus index * 2 + strand), from
    ``focus.pos_motif_ids`` / ``neg_motif_ids``: (ids a row, the row's
    first index into ids, ids), each position's ids in its list's order."""
    slot = np.full(len(focus.rule), -1, dtype=np.int64)
    slot[fi] = np.arange(len(fi))
    rows, ids = [], []
    for s, id_map in enumerate((focus.pos_motif_ids, focus.neg_motif_ids)):
        pos, mid = _id_entries(id_map)
        rows.append(slot[pos - tile_start] * 2 + s)
        ids.append(mid)
    rows, ids = np.concatenate(rows), np.concatenate(ids)
    n_ids = np.bincount(rows, minlength=2 * len(fi))
    ids = ids[np.argsort(rows, kind="stable")]
    return n_ids, np.cumsum(n_ids) - n_ids, ids


def _id_entries(id_map: dict, ids=None):
    """A {position: [ids]} map flattened, without a Python loop:
    (position, id) arrays, each position's ids in its list's order.
    ``ids`` iterates the ids where the lists hold more than the id."""
    n = np.fromiter(map(len, id_map.values()), dtype=np.int64,
                    count=len(id_map))
    pos = np.repeat(np.fromiter(id_map, dtype=np.int64, count=len(id_map)), n)
    if ids is None:
        ids = chain.from_iterable(id_map.values())
    return pos, np.fromiter(ids, dtype=np.int64, count=len(pos))


def _label_rank(labels: list) -> np.ndarray:
    """Each label's place in mod-code order (ChEBI < char)."""
    rank = np.empty(max(len(labels), 1), dtype=np.int32)
    for r, li in enumerate(
        sorted(range(len(labels)), key=lambda i: mod_code_sort_key(labels[i]))
    ):
        rank[li] = r
    return rank


def decode_counts(
    counts: np.ndarray,
    observed: np.ndarray,
    vocab: list,
    tile_start: int,
    combine_mods: bool = False,
    focus=None,
) -> list[tuple[int, list[PileupRow]]]:
    """Count tensor -> bedMethyl rows (pileup/mod.rs:412 FeatureVector::decode).

    Rows per (pos, strand): for each primary base with >= 1 valid call, one
    row per observed mod code for that base (or a single any-mod row with
    --combine-mods), sorted by (strand, mod code).
    """
    p, _, k = counts.shape
    m = len(vocab)
    m_pad = (k - 6) // 4 - 1  # counts may carry padded code columns
    lay = counts_layout(m_pad)
    can_cols = np.array([lay["CANONICAL"](b) for b in range(4)])
    # valid per (pos, strand, base); padded code columns are always zero
    mods_nd = np.stack(
        [
            counts[:, :, lay["CANONICAL"](b) + 1 : lay["CANONICAL"](b) + 1 + m_pad]
            for b in range(4)
        ],
        axis=2,
    )  # [p, 2, 4, m_pad]
    can_nd = counts[:, :, can_cols]  # [p, 2, 4]
    nocall_nd = counts[:, :, 2:6]  # [p, 2, 4]
    valid_nd = can_nd + mods_nd.sum(axis=3)  # [p, 2, 4]
    total_valid = valid_nd.sum(axis=2)  # [p, 2]
    total_nocall = nocall_nd.sum(axis=2)

    active = np.flatnonzero(valid_nd.any(axis=(1, 2)))
    out = []
    # batch-convert the active slices to nested Python lists: one C-level
    # pass instead of per-element numpy scalar extraction in the hot loop
    can_l = can_nd[active].tolist()
    mods_l = mods_nd[active].tolist()
    mods_sum_l = mods_nd[active].sum(axis=3).tolist()
    nocall_l = nocall_nd[active].tolist()
    valid_l = valid_nd[active].tolist()
    total_valid_l = total_valid[active].tolist()
    total_nocall_l = total_nocall[active].tolist()
    delfilt_l = counts[active][:, :, :2].tolist()
    observed_l = observed[active].tolist() if not combine_mods else None
    f32 = np.float32
    strand_chars = ("+", "-")
    for ai, pi in enumerate(active.tolist()):
        abs_pos = tile_start + pi
        rows: list[PileupRow] = []
        for s in (0, 1):
            strand_ch = strand_chars[s]
            if focus is not None:
                ids = (
                    focus.pos_motif_ids.get(abs_pos)
                    if s == 0
                    else focus.neg_motif_ids.get(abs_pos)
                )
                id_list = ids if ids else [None]
            else:
                id_list = [None]
            n_del, n_filt = delfilt_l[ai][s]
            tv = total_valid_l[ai][s]
            tn = total_nocall_l[ai][s]
            for b in range(4):
                valid = valid_l[ai][s][b]
                if valid == 0:
                    continue
                n_can = can_l[ai][s][b]
                n_nocall = nocall_l[ai][s][b]
                n_diff = (tv - valid) + (tn - n_nocall)
                if combine_mods:
                    n_mod_total = valid - n_can
                    frac = f32(n_mod_total) / f32(valid)
                    for idx in id_list:
                        rows.append(
                            PileupRow(
                                abs_pos, strand_ch,
                                any_mod_code(DNA_BASES[b]), valid, float(frac),
                                n_mod_total, n_can, 0, n_del, n_filt, n_diff,
                                n_nocall, idx,
                            )
                        )
                else:
                    mrow = mods_l[ai][s][b]
                    msum = mods_sum_l[ai][s][b]
                    orow = observed_l[ai][s][b]
                    for j in range(m):
                        if not orow[j]:
                            continue
                        n_mod = mrow[j]
                        n_other = msum - n_mod
                        frac = f32(n_mod) / f32(valid)
                        for idx in id_list:
                            rows.append(
                                PileupRow(
                                    abs_pos, strand_ch, vocab[j],
                                    valid, float(frac), n_mod, n_can, n_other,
                                    n_del, n_filt, n_diff, n_nocall, idx,
                                )
                            )
        rows.sort(
            key=lambda r: (0 if r.strand == "+" else 1, mod_code_sort_key(r.mod_code))
        )
        if rows:
            out.append((abs_pos, rows))
    return out


def combine_strand_rows(
    decoded: list[tuple[int, list[PileupRow]]], focus
) -> list[tuple[int, list[PileupRow]]]:
    """Merge +/- rows of palindromic motif pairs into strand '.' rows at the
    positive focus position (pileup/mod.rs:469 combine_strand_features)."""
    by_pos = dict(decoded)
    out: dict[int, list[PileupRow]] = {}
    for ppos in sorted(focus.positive_motifs):
        for motif, idx in focus.positive_motifs[ppos]:
            npos = motif.negative_strand_position(ppos)
            if npos is None:
                continue
            pos_rows = [
                r for r in by_pos.get(ppos, [])
                if r.strand == "+" and r.motif_idx == idx
            ]
            neg_rows = [
                r for r in by_pos.get(npos, [])
                if r.strand == "-" and r.motif_idx == idx
            ]
            groups: dict = {}
            for r in pos_rows + neg_rows:
                groups.setdefault(r.mod_code, []).append(r)
            combined = []
            for code in sorted(groups, key=mod_code_sort_key):
                rs = groups[code]
                valid = sum(r.valid_coverage for r in rs)
                n_mod = sum(r.n_modified for r in rs)
                frac = np.float32(n_mod) / np.float32(valid) if valid else 0.0
                combined.append(
                    PileupRow(
                        ppos, ".", code, valid, float(frac), n_mod,
                        sum(r.n_canonical for r in rs),
                        sum(r.n_other_modified for r in rs),
                        sum(r.n_delete for r in rs),
                        sum(r.n_filtered for r in rs),
                        sum(r.n_diff for r in rs),
                        sum(r.n_nocall for r in rs),
                        idx,
                    )
                )
            if combined:
                out.setdefault(ppos, []).extend(combined)
    return sorted(out.items())
