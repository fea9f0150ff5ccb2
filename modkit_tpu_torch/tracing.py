"""Spans and counters of the pileup pipeline, on the clock of the device
trace.

The pipeline (``pileup/runner.py``, ``pileup/engine.py``,
``thresholds.py``'s estimate through ``runner.resolve_caller``) marks each
stage of each tile with a span and each tile's sizes with a counter. Both
go through one function, ``emit(kind, name, tile, start, end, value)``:
``kind`` is ``"span"`` or ``"count"``, ``tile`` the tile's index in the
run's tile order (-1 outside a tile), ``start`` and ``end`` are
``time.perf_counter_ns()`` readings (a counter's are equal), and ``value``
is a counter's number (0 for a span). The pipeline calls ``emit`` through
this module's attribute, so a caller may wrap it there.

With no sink, ``emit`` returns at once: a span costs two clock readings
and one call, and nothing is kept. ``set_sink(Records())`` keeps every
record; ``MODKIT_TPU_PROFILE=<dir>`` does so for a run (``profiled``),
and writes the records beside the card's activity in ``<dir>/trace.json``.

Spans, per tile unless marked (``WORKER_STAGES`` run on a tile worker,
the rest on the thread that writes):

- ``tile``: from the submission of the tile to the end of its write;
- ``queued``: from the submission to the worker's start on the tile;
- ``decode``: the native decode of the tile's reads, with the release of
  the BAM pages it read;
- ``export``: the tile's events into the upload layout;
- ``upload``: the pinned staging buffer, its packing and the enqueue of
  the host-to-device copy;
- ``dispatch``: kernel A's call and the enqueue of the states' copy back
  (on the Python event route kernel B's);
- ``device_wait``: the wait for the states' copy to land;
- ``histogram``: the states into the tile's count tensor;
- ``format``: the counts into rows;
- ``held``: from the worker's return to the writer taking the tile;
- ``writer_wait``: the writer blocked on the tile's result;
- ``write``: the rows into the output;
- ``estimate``: the threshold estimate before the first tile (tile -1);
- ``focus_scan``: the tile's focus positions found in the reference
  (``--cpg``, ``--motif``, with ``--combine-strands`` the extension of
  the tile's end past a motif on its boundary) or read from
  ``--include-bed``, on the main thread before the tile is submitted, so
  it ends before the tile's ``tile`` span starts.

A stage that a tile's route skips still gets its span, at the tile's end
and of zero length, so each tile has one of each; a tile with no focus
gets a ``focus_scan`` of zero length where its scan would have been.

Counters, per tile: ``reads_decoded`` (reads the tile's decode went
through, used and skipped), ``events``, ``m_pad``, ``route`` (an index
into ``ROUTES``), ``bytes_up`` (the staging buffer), ``bytes_down`` (the
states), ``rows``, ``out_bytes`` (the text of natively formatted rows;
the writer renders the other routes' rows itself) and ``format_route``
(an index into ``FORMAT_ROUTES``: how the tile's counts became rows,
``none`` where nothing was launched), ``focus_positions`` (the positions
in the tile's focus, 0 without one) and ``tile_extend_bp`` (how far
``--combine-strands`` moved the tile's end past its start plus the
interval size, 0 elsewhere); on the native decode's route
``aligned_columns`` (the aligned columns of the tile's decoded reads, each
read whole) and ``walked_columns`` (the columns its walk visited, each
read clipped to the tile and, with a focus, to the focus positions): their
ratio is the share of a per-base walk the decode still does; and
``bgzf_blocks`` (the BGZF blocks the tile's chunks needed) and
``bgzf_blocks_reused`` (those the run's block cache served, inflated by
another tile): their ratio is the share of inflate the cache saved.

In ``trace.json`` a span's ``ts`` is, as torch (2.11) exports its own
events, the wall clock less the trace's ``baseTimeNanoseconds``, in µs:
``(start + (time_ns() - perf_counter_ns()) - baseTimeNanoseconds) / 1000``,
the clocks' difference read when the trace is written.
"""

from __future__ import annotations

import json
import os
import threading
import time
from array import array
from contextlib import contextmanager

SPANS = ("tile", "queued", "decode", "export", "upload", "dispatch",
         "device_wait", "histogram", "format", "held", "writer_wait", "write",
         "estimate", "focus_scan")
COUNTERS = ("reads_decoded", "events", "m_pad", "route", "bytes_up",
            "bytes_down", "rows", "out_bytes", "format_route",
            "focus_positions", "tile_extend_bp", "aligned_columns",
            "walked_columns", "bgzf_blocks", "bgzf_blocks_reused")
ROUTES = ("none", "quals", "f32")
FORMAT_ROUTES = ("none", "text", "columnar", "columnar_motif", "rows")
# the stages that launch a tile and those that finish it, both on a tile
# worker unless the writer's thread finishes tiles
LAUNCH_STAGES = ("decode", "export", "upload", "dispatch")
FINISH_STAGES = ("device_wait", "histogram", "format")
WORKER_STAGES = LAUNCH_STAGES + FINISH_STAGES
# spans that start on one thread and end on another
CROSS_THREAD = ("tile", "queued", "held")

_NAMES = SPANS + COUNTERS
_ID = {n: i for i, n in enumerate(_NAMES)}
_BIT = {n: 1 << i for i, n in enumerate(SPANS)}
# a record: four int64 words (name | thread << 8 | (tile + 1) << 24, start,
# end, value); a genome at 100 kb tiles (about 31 000 tiles, 24 records a
# tile) keeps about 24 MB
RECORD_BYTES = 32
# process ids of the program's rows in a trace, clear of any real pid
_PID = 1 << 30

_sink = None


def emit(kind: str, name: str, tile: int, start: int, end: int, value: int) -> None:
    """One finished span or one counter; to the sink, if one is set."""
    sink = _sink
    if sink is not None:
        sink.add(kind, name, tile, start, end, value)


def set_sink(sink) -> None:
    """Send every record to ``sink.add`` (a ``Records``); None stops."""
    global _sink
    _sink = sink


class _Tile(threading.local):
    tile = -1  # the tile this thread works on
    seen = 0  # the spans it has emitted for that tile, one bit each


_current = _Tile()


def begin_tile(tile: int) -> None:
    """Spans and counters of this thread without a tile id belong to
    ``tile`` until ``end_tile``."""
    _current.tile = tile
    _current.seen = 0


def end_tile(stages: tuple) -> None:
    """Give each of ``stages`` that the current tile skipped a span of
    zero length now, and leave the tile."""
    cur = _current
    now = time.perf_counter_ns()
    for name in stages:
        if not cur.seen & _BIT[name]:
            emit("span", name, cur.tile, now, now, 0)
    cur.tile = -1
    cur.seen = 0


class span:
    """``with span(name, tile):`` emits the span of the block; ``tile``
    defaults to the thread's current tile (``begin_tile``)."""

    __slots__ = ("name", "tile", "start")

    def __init__(self, name: str, tile: int | None = None):
        self.name = name
        self.tile = tile

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tile = self.tile
        if tile is None:
            cur = _current
            tile = cur.tile
            cur.seen |= _BIT[self.name]
        emit("span", self.name, tile, self.start, end, 0)


def count(name: str, n: int, tile: int | None = None) -> None:
    """The counter ``name`` of ``tile`` (default: the thread's current
    tile) is ``n``."""
    t = time.perf_counter_ns()
    emit("count", name, _current.tile if tile is None else tile, t, t, int(n))


class Records:
    """Every span and counter of a run, ``RECORD_BYTES`` a record; safe to
    add to from any thread."""

    def __init__(self):
        self._words = array("q")
        self._lock = threading.Lock()
        self._slot: dict = {}  # thread ident -> index into thread_names
        self.thread_names: list = []

    def add(self, kind, name, tile, start, end, value) -> None:
        ident = threading.get_ident()
        with self._lock:
            slot = self._slot.get(ident)
            if slot is None:
                slot = self._slot[ident] = len(self.thread_names)
                self.thread_names.append(threading.current_thread().name)
            self._words.extend(
                (_ID[name] | slot << 8 | (tile + 1) << 24, start, end, value))

    def __len__(self) -> int:
        return len(self._words) // 4

    @property
    def nbytes(self) -> int:
        return len(self._words) * 8

    def __iter__(self):
        """(name, thread name, tile, start_ns, end_ns, value) a record."""
        with self._lock:
            words = self._words[:]
            threads = list(self.thread_names)
        for i in range(0, len(words), 4):
            w = words[i]
            yield (_NAMES[w & 0xFF], threads[(w >> 8) & 0xFFFF], (w >> 24) - 1,
                   words[i + 1], words[i + 2], words[i + 3])

    def chrome_events(self, base_ns: int) -> list:
        """The spans as Chrome trace ``X`` events on a trace's clock:
        ``ts`` in µs since ``base_ns`` on the wall clock (torch's
        ``baseTimeNanoseconds``). One process row per thread, and one for
        the tiles, whose spans (``CROSS_THREAD``) cross threads and take
        one lane each while in flight; each span carries its tile id, a
        tile's ``tile`` span its counters too."""
        off = wall_minus_perf_ns() - base_ns
        counters: dict = {}
        spans = []
        for name, thread, tile, start, end, value in self:
            if name in _BIT:
                spans.append((name, thread, tile, start, end))
            else:
                counters.setdefault(tile, {})[name] = (
                    ROUTES[value] if name == "route"
                    else FORMAT_ROUTES[value] if name == "format_route"
                    else value)
        pids = {t: _PID + 1 + i for i, t in enumerate(dict.fromkeys(
            s[1] for s in spans))}
        events = [{"ph": "M", "name": "process_name", "pid": _PID,
                   "args": {"name": "modkit_tpu_torch tiles"}}]
        events += [{"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": f"modkit_tpu_torch {t}"}}
                   for t, pid in pids.items()]
        lanes: list = []  # end of the last tile on each lane
        lane_of: dict = {}
        for name, thread, tile, start, end in sorted(
                (s for s in spans if s[0] == "tile"), key=lambda s: s[3]):
            lane = next((i for i, e in enumerate(lanes) if e <= start), len(lanes))
            lanes[lane:lane + 1] = [end]
            lane_of[tile] = lane
        for name, thread, tile, start, end in spans:
            ev = {"ph": "X", "cat": "modkit_tpu_torch", "name": name,
                  "ts": (start + off) / 1e3, "dur": (end - start) / 1e3}
            if name in CROSS_THREAD:
                ev["pid"], ev["tid"] = _PID, lane_of.get(tile, 0)
            else:
                ev["pid"], ev["tid"] = pids[thread], 0
            if tile >= 0:
                ev["args"] = {"tile": tile}
                if name == "tile":
                    ev["args"].update(counters.get(tile, {}))
            events.append(ev)
        return events


def wall_minus_perf_ns() -> int:
    """The wall clock (``time.time_ns``) less ``time.perf_counter_ns``,
    read from the closest of a few paired readings."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


@contextmanager
def profiled(out_dir: str, device):
    """Record the block's spans and counters and, on a CUDA ``device``,
    the card's activity (``torch.profiler``, CUDA only), and write both
    into ``<out_dir>/trace.json`` on the trace's clock."""
    records = Records()
    base_ns = time.time_ns() // 10**9 * 10**9  # where torch leaves none
    prof = None
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    set_sink(records)
    try:
        yield records
    finally:
        set_sink(None)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(path)
            with open(path) as fh:
                doc = json.load(fh)
        else:
            doc = {"traceEvents": [], "baseTimeNanoseconds": base_ns}
        doc["traceEvents"] += records.chrome_events(doc.get("baseTimeNanoseconds", 0))
        with open(path, "w") as fh:
            json.dump(doc, fh)
