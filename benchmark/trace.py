"""Spans, counters and device activity of a traced run.

Host spans and counters come from timing wrappers that the harness puts on
the program's module and class attributes for the traced stretch; the
program's files are not touched. Each per-layer metric's reader
(``metrics/<name>.py``) names the attributes it reads:

- ``SPANS = {label: ["module:attr.path", ...]}``: every call of a target
  is a span ``(label, start, end)``;
- ``COUNTS = {label: {"module:attr.path": fn}}``: every call of a target
  adds ``fn(args)`` to the counter ``label`` (one a call where ``fn`` is
  None).

``Recorder.install`` wraps what the metrics of a run name, each (label,
target) once, and fails where a target is gone. Device activity comes from
``torch.profiler`` over the same stretch, read from its Chrome trace. Two
markers on the main thread tie the host clock to the trace's clock.
"""

from __future__ import annotations

import importlib
import json
import threading
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _resolve(target: str):
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    if not hasattr(owner, parts[-1]):
        raise AttributeError(f"trace target {target} no longer exists")
    return owner, parts[-1]


@dataclass
class Recorder:
    """Spans [(label, start_ns, end_ns)] and counters {label: n}, while
    installed."""

    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    _saved: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def install(self, metrics: list) -> None:
        """Wrap the targets that the metric modules ``metrics`` name."""
        spans, counts = {}, {}
        for m in metrics:
            for label, targets in getattr(m, "SPANS", {}).items():
                for t in targets:
                    spans.setdefault((label, t), None)
            for label, targets in getattr(m, "COUNTS", {}).items():
                for t, fn in targets.items():
                    counts.setdefault((label, t), fn)
        for label, t in spans:
            self._wrap(t, self._span(label))
        for (label, t), fn in counts.items():
            self.counts.setdefault(label, 0)
            self._wrap(t, self._counter(label, fn))

    def remove(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    def _wrap(self, target: str, make) -> None:
        owner, name = _resolve(target)
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._saved.append((owner, name, orig))

    def _span(self, label: str):
        spans = self.spans

        def make(orig):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter_ns()
                try:
                    return orig(*args, **kwargs)
                finally:
                    spans.append((label, t0, time.perf_counter_ns()))
            return wrapper
        return make

    def _counter(self, label: str, fn):
        def make(orig):
            def wrapper(*args, **kwargs):
                n = 1 if fn is None else fn(args)
                with self._lock:
                    self.counts[label] += n
                return orig(*args, **kwargs)
            return wrapper
        return make


@dataclass
class Trace:
    """What the per-layer metric readers read (``metrics/<name>.py``)."""

    spans: list  # (label, start_s, end_s) on the trace's clock
    counts: dict  # label -> counter
    device: list  # (name, start_s, end_s) of device activity
    window: tuple  # (start_s, end_s) of the traced stretch
    device_kind: str  # torch.cuda.get_device_name()
    host: dict = field(default_factory=dict)  # the run's own host-clock readings

    def layer_seconds(self, label: str) -> float | None:
        d = [e - s for name, s, e in self.spans if name == label]
        return sum(d) if d else None

    def ms_per_tile(self, label: str) -> float | None:
        """Span seconds of ``label`` in ms per tile of the counter
        ``tiles``; nothing where either is missing."""
        s, tiles = self.layer_seconds(label), self.counts.get("tiles")
        return None if s is None or not tiles else 1e3 * s / tiles

    def busy(self) -> list:
        """Merged device intervals inside the window."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device
                    if e > w0 and s < w1)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out


def device_events(trace_path: str, marks: tuple):
    """(device events, window) from a Chrome trace: events of
    ``DEVICE_CATS`` as (name, start_s, end_s), and the window between the
    two main-thread markers ``marks``, on the trace's clock."""
    with open(trace_path) as fh:
        doc = json.load(fh)
    dev, at = [], {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") in DEVICE_CATS:
            s = float(ev["ts"]) * 1e-6
            dev.append((ev.get("name", "?"), s, s + float(ev.get("dur", 0)) * 1e-6))
        elif ev.get("cat") == "user_annotation" and ev.get("name") in marks:
            at[ev["name"]] = float(ev["ts"]) * 1e-6
    if set(at) != set(marks):
        raise ValueError(f"trace: markers {sorted(set(marks) - set(at))} missing")
    return dev, (at[marks[0]], at[marks[1]])


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by the host spans that cover their middle."""
    w0, w1 = tr.window
    by_name: dict = {}
    for name, s, e in tr.device:
        if e > w0 and s < w1:
            by_name[name] = by_name.get(name, 0.0) + (min(e, w1) - max(s, w0))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = tr.busy()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        layers = sorted({n for n, a, b in tr.spans if a <= mid <= b})
        out.append(["+".join(layers) if layers else "other host work", e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}
