"""The count-kernel lab on the card: every formulation of the grouped
128 x 128 count histogram, checked against an oracle and timed.

Port of ``tools/kernel_lab.py``. Usage:

    python -m modkit_tpu_torch.tools.kernel_lab [variant ...] [--device cpu]

Variants, as in the original: ``bf16x2 bf16x4 int8x1 int8x4`` (run_variant
with a one-hot dtype and an accumulator count), ``bigk-bf16 bigk-int8``
(run_bigk), ``group[-int8][x<n_acc>]`` (run_group), ``bigkh[-int8]``
(run_bigk_host), ``rep8[-int8][-c<chunk>]`` (run_rep8), and the diagnostics
``empty onehot-only matmul-only a-only`` (run_diag). Without variants it
runs the first six. The kernels are those of ``ops/lab_counts.py``
(``csrc/lab_counts.cu``); with ``--device cpu`` their plain PyTorch
versions run instead, and without a CUDA device a run that did not ask for
the CPU raises.

Data as in the original: ``numpy.random.default_rng(7)``, 64 * 65536
events over 100 000 positions with M = 2 mod codes, planned by
``count_layout.prepare_events`` with a deterministic per-event counter.
``--events`` and ``--positions`` shrink it (the CPU tests use them). The
reference is ``count_call`` (the counterpart of ``_count_call``), which must
equal the numpy ``bincount`` oracle. Each variant prints its rate in Geps
(events per second, padding slots not counted) and ``[equal]`` when it
equals its plain version and, for the histogram, the oracle, else
``[MISMATCH]``; a diagnostic computes another function and is held against
its plain version alone. The exit code is 1 if any variant mismatched or
failed.

Timing: CUDA events around ``LAB_REPS`` (default 10) back-to-back launches
(``true_bench.cuda_time_ms``); the original's enqueue-only timing worked
around its TPU backend and has no counterpart here. On the CPU the host
clock times the plain versions, and the line says so. ``LAB_NO_DOT=1`` and
``LAB_NO_CONSTRUCT=1`` switch the rep8 variants to the original's
ablations (``lab_counts.ablation_plain``), held against their plain
versions.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import lab_counts as lc
from ..ops.count_layout import (
    CHUNK, LANES, P2, check_c2g, pack_events_u8, prepare_events, rep8,
)
from ..parallel.devices import resolve_device
from .true_bench import cuda_time_ms

SEED = 7
EVENTS = 64 * 65536
POSITIONS = 100_000
CODES = 2
DEFAULT_VARIANTS = ("bf16x2", "bf16x4", "int8x1", "int8x4", "bigk-bf16",
                    "bigk-int8")


def lab_events(n: int, p: int, m: int = CODES, seed: int = SEED):
    """(rpos, strand, base, probs) drawn as the original lab draws them."""
    rng = np.random.default_rng(seed)
    rpos = rng.integers(0, p, n).astype(np.int32)
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.int32)
    probs = rng.random((n, m), dtype=np.float32)
    return rpos, strand, base, probs


def one_position_events(n: int, p: int, m: int = CODES, seed: int = SEED):
    """``lab_events`` with every event at position ``p // 2`` on the +
    strand: every slot of a chunk lands on one cell, the worst case for
    atomics to one address."""
    rpos, strand, base, probs = lab_events(n, p, m, seed)
    return np.full_like(rpos, p // 2), np.zeros_like(strand), base, probs


def counters_for(p2, colb, kc: int, km: int):
    """The original's deterministic per-event counter (a function of the
    event's planes, so every chunking agrees), with its u8 arithmetic."""
    return ((p2 * 13 + colb // kc) % km).astype(np.int32)


@dataclass
class LabInputs:
    """One chunking of the lab's events, on the host and on ``dev``."""

    n_events: int
    chunk: int
    n_groups: int
    c2g: np.ndarray  # int32 [n_chunks]
    p2: np.ndarray  # u8 [n_chunks * chunk]
    col: np.ndarray  # int32 [n_chunks * chunk]
    valid: np.ndarray  # u8 [n_chunks * chunk]
    dev: torch.device

    @classmethod
    def build(cls, events, n_positions: int, dev, chunk: int = CHUNK,
              m: int = CODES):
        plan, c2g, p2, colb, valid, *_ = prepare_events(
            *events, n_positions, m, chunk=chunk)
        check_c2g(c2g, plan["n_groups"])
        col = colb + counters_for(p2, colb, plan["kc"], 1 + 4 * (m + 1))
        return cls(len(events[0]), chunk, plan["n_groups"], c2g, p2, col,
                   valid, torch.device(dev))

    def _t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    @property
    def n_chunks(self) -> int:
        return len(self.c2g)

    @functools.cached_property
    def planes(self):
        """(c2g, p2 u8, col int32, valid int32) tensors of run_variant."""
        return (self._t(self.c2g), self._t(self.p2), self._t(self.col),
                self._t(self.valid.astype(np.int32)))

    @functools.cached_property
    def rows(self):
        """u8 [n_chunks, chunk] rows of run_bigk_host, col 255 = invalid."""
        col = np.where(self.valid != 0, self.col, 255)
        return (self._t(self.p2.astype(np.uint8).reshape(self.n_chunks, -1)),
                self._t(col.astype(np.uint8).reshape(self.n_chunks, -1)))

    @functools.cached_property
    def rep8(self):
        """u8 [n_chunks * 8, chunk] replicated rows of run_rep8."""
        return (self._t(rep8(self.p2, self.n_chunks, self.chunk)),
                self._t(rep8(self.col, self.n_chunks, self.chunk,
                             valid=self.valid)))

    @functools.cached_property
    def packed(self):
        """(gmeta, packed) of run_group."""
        gmeta, packed, _ = pack_events_u8(self.c2g, self.p2, self.col,
                                          self.valid, self.n_groups)
        return self._t(gmeta), self._t(packed)

    def oracle(self) -> np.ndarray:
        """int32 [n_groups, 128, 128]: numpy bincount of the valid slots."""
        grp = np.repeat(self.c2g.astype(np.int64), self.chunk)
        v = self.valid != 0
        key = (grp[v] * (P2 * LANES) + self.p2[v].astype(np.int64) * LANES
               + self.col[v].astype(np.int64))
        return np.bincount(key, minlength=self.n_groups * P2 * LANES).astype(
            np.int32).reshape(self.n_groups, P2, LANES)


def _dtypes(name: str):
    """(one-hot dtype, accumulator dtype) a variant name selects."""
    if "int8" in name:
        return torch.int8, torch.int32
    return torch.bfloat16, torch.float32


def variant_call(name: str, lab: LabInputs, ablation: str | None = None):
    """(kernel, plain, histogram) of a variant over ``lab``: the wrapper's
    call, the same function's plain PyTorch version on the same tensors,
    and whether the function is the histogram (else a diagnostic or an
    ablation). Rep8 variants read ``lab.chunk``; the others take 2048."""
    oh, acc = _dtypes(name)
    g = lab.n_groups
    c2g = lab.planes[0]
    if name.startswith("bigkh"):
        return (lambda: lc.run_bigk_host(c2g, *lab.rows, n_groups=g, oh=oh,
                                         acc=acc),
                lambda: lc.hist_plain(c2g, *lab.rows, None, g), True)
    if name.startswith("group"):
        n_acc = int(name.split("x")[1]) if "x" in name else 1
        return (lambda: lc.run_group(*lab.packed, n_groups=g, oh=oh, acc=acc,
                                     n_acc=n_acc),
                lambda: lc.group_plain(*lab.packed, g), True)
    if name in lc.DIAG_MODES:
        return (lambda: lc.run_diag(*lab.planes, n_groups=g, mode=name),
                lambda: lc.diag_plain(*lab.planes, g, name), False)
    if name.startswith("rep8"):
        if ablation is None:
            plain = lambda: lc.rep8_plain(c2g, *lab.rep8, g, lab.chunk)
        else:
            plain = lambda: lc.ablation_plain(c2g, *lab.rep8, g, lab.chunk,
                                              ablation)
        return (lambda: lc.run_rep8(c2g, *lab.rep8, n_groups=g, oh=oh,
                                    acc=acc, chunk=lab.chunk,
                                    ablation=ablation),
                plain, ablation is None)
    plain = lambda: lc.hist_plain(*lab.planes, g)
    if name.startswith("bigk"):
        oh, acc = ((torch.bfloat16, torch.float32) if "bf16" in name
                   else (torch.int8, torch.int32))
        return (lambda: lc.run_bigk(*lab.planes, n_groups=g, oh=oh,
                                    acc=acc), plain, True)
    if "x" not in name:
        raise ValueError(f"unknown variant {name!r}")
    n_acc = int(name.split("x")[1])
    return (lambda: lc.run_variant(*lab.planes, n_groups=g, acc=acc, oh=oh,
                                   n_acc=n_acc), plain, True)


def _time_ms(fn, dev, reps: int) -> float:
    if dev.type == "cuda":
        return cuda_time_ms(fn, reps, warmup=1)[0]
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run_lab(variants, device="cuda", n_events: int = EVENTS,
            n_positions: int = POSITIONS, reps: int = 10,
            ablation: str | None = None, log=print) -> dict:
    """Run ``variants``; returns {line name: dict(ok, ms, geps)}. Raises
    if the reference disagrees with the oracle, as the original does."""
    dev = resolve_device(device)
    clock = "CUDA events" if dev.type == "cuda" else "host clock, CPU plain versions"
    events = lab_events(n_events, n_positions)
    labs = {CHUNK: LabInputs.build(events, n_positions, dev)}
    base = labs[CHUNK]
    oracle = base.oracle()
    ref = lambda: lc.count_call(base.planes[0], *base.rep8,
                                n_groups=base.n_groups)
    if not np.array_equal(ref().cpu().numpy(), oracle):
        raise RuntimeError("count_call differs from the bincount oracle")
    results = {}
    ms = _time_ms(ref, dev, reps)
    results["current rep8-int8"] = dict(ok=True, ms=ms,
                                        geps=n_events / ms / 1e6)
    log(f"{'current rep8-int8':22s}: {n_events / ms / 1e6:.2f} Geps "
        f"({ms:.5f} ms, {clock})")
    for name in variants:
        try:
            lab = base
            if name.startswith("rep8"):
                chunk = int(name.rsplit("-c", 1)[1]) if "-c" in name else CHUNK
                if chunk not in labs:
                    labs[chunk] = LabInputs.build(events, n_positions, dev,
                                                  chunk=chunk)
                lab = labs[chunk]
            fn, plain, histogram = variant_call(name, lab, ablation)
            got = fn().cpu().numpy()
            ok = bool(np.array_equal(got, plain().cpu().numpy()))
            if histogram:
                ok &= bool(np.array_equal(
                    got, oracle if lab is base else lab.oracle()))
                note = ""
            elif name in lc.DIAG_MODES:
                note = " (diag: held against its plain version)"
            else:
                note = f" ({ablation}: held against its plain version)"
            ms = _time_ms(fn, dev, reps)
            geps = n_events / ms / 1e6
            pad = ""
            if name.startswith("rep8"):
                pad = f" (padded {lab.n_chunks * lab.chunk / n_events:.2f}x)"
            log(f"{name:22s}: {geps:.2f} Geps  "
                f"[{'equal' if ok else 'MISMATCH'}]{pad}{note} ({ms:.5f} ms)")
            results[name] = dict(ok=ok, ms=ms, geps=geps)
        except Exception as e:  # report the variant and go on, as the original
            traceback.print_exc(file=sys.stderr)
            log(f"{name:22s}: FAILED {type(e).__name__}: {str(e)[:200]}")
            results[name] = dict(ok=False, ms=None, geps=None)
    return results


def ablation_from_env() -> str | None:
    """The rep8 ablation that LAB_NO_DOT / LAB_NO_CONSTRUCT select."""
    if os.environ.get("LAB_NO_DOT") == "1":
        return "no-dot"
    if os.environ.get("LAB_NO_CONSTRUCT") == "1":
        return "no-construct"
    return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m modkit_tpu_torch.tools.kernel_lab",
        description="Count-kernel lab: every histogram formulation against "
                    "the oracle, timed on the card.")
    p.add_argument("variants", nargs="*", default=list(DEFAULT_VARIANTS))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--events", type=int, default=EVENTS,
                   help="events to draw (a reduced run for tests)")
    p.add_argument("--positions", type=int, default=POSITIONS,
                   help="reference positions the events fall on")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    results = run_lab(
        args.variants or list(DEFAULT_VARIANTS), args.device, args.events,
        args.positions, int(os.environ.get("LAB_REPS", "10")),
        ablation_from_env())
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
