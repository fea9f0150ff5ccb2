"""The benchmark of ``modkit_tpu_torch pileup`` on one NVIDIA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process. It makes the cell's modBAM from the seed in a
child process (``gen.py``) while this one imports torch, starts CUDA and
loads the program's kernels; runs one warm-up job; then runs pileup jobs
back to back for ``--seconds`` (one client, closed loop); judges every
job's output against the plain reference (``reference.py``), and where the
cell hands no ``--filter-threshold`` in, every job's estimated threshold of
each called base against the reference's estimate (``estimate.py``); and
prints one JSON line last on stdout. A job is the user's ``modkit pileup`` over
the whole contig: ``run_pileup`` with the ``PileupConfig`` that the
program's CLI builds from the cell's flags, on ``cuda``.

Each job writes its bedMethyl into a FIFO that a harness thread drains and
checksums (CRC-32 and length), so the jobs do not fill the disk; the first
timed job's bytes are kept for the row-by-row comparison. With ``--trace 1`` the first half of
the window runs as usual and the second half under the span wrappers and
``torch.profiler`` (``trace.py``); the per-layer metrics are read from that
half by ``metrics/<name>.py``, which also name the program's attributes
that their spans and counters wrap.

``setup_s`` runs from the process's start to the end of the warm-up job,
less ``build_s``: the build of the program's native library and kernels,
which only the first run in a checkout makes (later runs find them built
in the checkout). ``build_s`` is a key of its own in the result line.

Cells, configurations and metrics are data: ``workloads/<cell>.json``,
``configs/<config>.json`` and the entries of ``BENCHMARK.json``. A
configuration's call set (``gen.call_groups``) may hold calls on A beside
C; a workload's flags name ``{threshold}`` (C's), ``{threshold_A}``,
``{threshold_C}`` and ``{ref}``, which ``workload_flags`` fills in from the
generator's ``meta.json``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import zlib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "modkit_tpu")
RSS_PERIOD_S = 0.05
# the program's per-base pools of confidences are keyed by the base's index
BASE_INDEX = {"A": 0, "C": 1, "G": 2, "T": 3}
DRAIN_TIMEOUT_S = 120.0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(workload: str, data_override: dict | None = None) -> tuple[dict, dict]:
    """The cell's workload and configuration; ``data_override`` replaces
    keys of the configuration's ``data`` (the tests' small sizes)."""
    wl = load_json(os.path.join(BENCH, "workloads", workload + ".json"))
    config = load_json(os.path.join(BENCH, "configs", wl["config"] + ".json"))
    if data_override:
        config = {**config, "data": {**config["data"], **data_override}}
    return wl, config


def workload_flags(wl: dict, thresholds: dict, ref: str) -> list:
    """The workload's flags with the thresholds of each called base
    (``{threshold_A}``, ``{threshold_C}``; ``{threshold}`` is C's) and the
    FASTA's path (``{ref}``) filled in."""
    named = {f"threshold_{b}": repr(t) for b, t in thresholds.items()}
    if "C" in thresholds:
        named["threshold"] = named["threshold_C"]
    return [f.format(ref=ref, **named) for f in wl["flags"]]


def digest(data: bytes) -> tuple[int, int]:
    """What a job's output is judged by: its CRC-32 and its length."""
    return zlib.crc32(data), len(data)


class Drain(threading.Thread):
    """Reads each job's bedMethyl from the FIFO and takes its digest; keeps
    the bytes of a job asked to be kept in a file."""

    def __init__(self, fifo: str):
        super().__init__(daemon=True)
        self.fifo = fifo
        self.jobs: queue.Queue = queue.Queue()
        self.results: queue.Queue = queue.Queue()
        self.cpu_s = 0.0  # this thread's CPU time, once it has ended

    def run(self) -> None:
        try:
            self._drain()
        finally:
            self.cpu_s = time.thread_time()

    def _drain(self) -> None:
        while True:
            keep = self.jobs.get()
            if keep is False:
                return
            crc = n = 0
            out = open(keep, "wb") if keep else None
            try:
                with open(self.fifo, "rb", buffering=0) as fh:
                    try:  # a larger pipe: fewer switches between the sides
                        import fcntl

                        fcntl.fcntl(fh.fileno(), 1031, 1 << 20)  # F_SETPIPE_SZ
                    except OSError:
                        pass
                    while True:
                        chunk = fh.read(1 << 20)
                        if not chunk:
                            break
                        crc = zlib.crc32(chunk, crc)
                        n += len(chunk)
                        if out is not None:
                            out.write(chunk)
            finally:
                if out is not None:
                    out.close()
            self.results.put((crc, n))

    def release(self) -> None:
        """End a job that may never have opened the FIFO for writing."""
        try:
            fd = os.open(self.fifo, os.O_WRONLY | os.O_NONBLOCK)
        except OSError:
            return  # no reader waiting: the job's writer closed already
        os.close(fd)


class RssSampler(threading.Thread):
    """The highest VmRSS of this process, sampled every ``RSS_PERIOD_S``
    (50 ms: a read of /proc/self/status costs 0.8-5 ms of CPU on the card's
    machine, more the more the process has mapped)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.peak = 0
        self.peak_at = 0.0  # perf_counter() of the highest sample
        self.reads = 0
        self.cpu_s = 0.0  # this thread's CPU time, once it has ended
        self._halt = threading.Event()

    @staticmethod
    def vmrss() -> int:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("/proc/self/status has no VmRSS")

    def run(self) -> None:
        try:
            while not self._halt.is_set():
                v = self.vmrss()
                if v > self.peak:
                    self.peak, self.peak_at = v, time.perf_counter()
                self.reads += 1
                self._halt.wait(RSS_PERIOD_S)
        finally:
            self.cpu_s = time.thread_time()

    def stop(self) -> int:
        self._halt.set()
        self.join()
        return max(self.peak, self.vmrss())


class PoolProbe:
    """The confidences that the program's estimate pools, caught on the
    timed path where it hands them to the percentile (``TARGET``: a dict
    of base index -> confidences) while installed. ``take`` gives, for
    each base, the 513-bin histogram of what was handed over since the
    last take and how many values lay off the 1/512 grid; None where
    nothing was handed over."""

    TARGET = "modkit_tpu_torch.thresholds:thresholds_from_confidences"

    def __init__(self):
        self._pools: dict = {}
        self._saved = None

    def install(self) -> None:
        from benchmark import estimate
        from benchmark.trace import _resolve

        owner, name = _resolve(self.TARGET)
        real = getattr(owner, name)

        def probed(confs, *a, **k):
            out = real(confs, *a, **k)
            for b, v in confs.items():
                hist, off = estimate.grid_hist(v)
                h0, o0 = self._pools.get(int(b), (0, 0))
                self._pools[int(b)] = (h0 + hist, o0 + off)
            return out
        setattr(owner, name, probed)
        self._saved = (owner, name, real)

    def remove(self) -> None:
        if self._saved is not None:
            setattr(*self._saved)
            self._saved = None

    def take(self) -> dict | None:
        pools, self._pools = self._pools, {}
        return pools or None


def pileup_config(argv: list):
    """The PileupConfig that ``python -m modkit_tpu_torch pileup <argv>``
    builds: the CLI's own parser and ``cmd_pileup``, with ``run_pileup``
    held back."""
    from modkit_tpu_torch import cli
    from modkit_tpu_torch.pileup import runner

    args = cli.build_parser().parse_args(["pileup", *argv])
    got = []
    real = runner.run_pileup
    runner.run_pileup = lambda cfg: got.append(cfg) or {"errors": {}}
    try:
        args.func(args)
    finally:
        runner.run_pileup = real
    return got[0]


def cpu_time() -> float:
    """The CPU seconds of this process, every thread's, user and system."""
    t = os.times()
    return t.user + t.system


def run_job(cfg, drain: Drain, keep: str | None) -> tuple:
    """One pileup job: (seconds, digest, error, CPU seconds, the threshold
    of each base that the job called with)."""
    from modkit_tpu_torch.pileup import runner

    drain.jobs.put(keep)
    c = cpu_time()
    t = time.perf_counter()
    err = thresholds = None
    try:
        out = runner.run_pileup(dataclasses.replace(cfg))
        thresholds = dict(out["thresholds"]["per_base"])
    except Exception as e:  # a failed job is counted, and the run goes on to judge
        err = f"{type(e).__name__}: {e}"
        gc.collect()
        drain.release()
    try:
        res = drain.results.get(timeout=DRAIN_TIMEOUT_S)
    except queue.Empty:
        res, err = None, err or "the job's output never closed"
    return time.perf_counter() - t, res, err, cpu_time() - c, thresholds


def device_info(device: str) -> dict:
    import torch

    info = {"platform": "gpu" if device == "cuda" else "cpu", "kind": "", "count": 1,
            "torch": torch.__version__, "cpu_count": os.cpu_count()}
    if device == "cuda":
        info["kind"] = torch.cuda.get_device_name(0)
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=20)
            info["power_limit"] = out.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            info["power_limit"] = "not read"
    return info


def per_layer_metrics(workload: str) -> list:
    """The per-layer entries of BENCHMARK.json that this cell reports."""
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload])]


def load_metric(name: str):
    """The reader ``metrics/<stem>.py``, ``<stem>`` the name up to its first
    dot (``x.rss`` is ``x`` in cells where it moves another end-to-end
    metric): ``read(trace)`` and the spans and counters it reads
    (``SPANS``, ``COUNTS``, see ``trace.py``)."""
    path = os.path.join(BENCH, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_counters() -> dict:
    from modkit_tpu_torch.ops import counts, state

    return {
        "state_quals_launches": state.STATE_KERNEL_LAUNCHES,
        "state_f32_launches": state.STATE_F32_KERNEL_LAUNCHES,
        "state_f32_copies": state.STATE_F32_COPIES,
        "count_kernel_launches": counts.COUNT_KERNEL_LAUNCHES,
    }


def rows_differing(got: bytes, ref: bytes) -> int:
    """Rows in one of the two outputs and not in the other, counted with
    their multiplicity."""
    from collections import Counter

    a, b = Counter(got.split(b"\n")), Counter(ref.split(b"\n"))
    return sum(((a - b) + (b - a)).values())


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", data_override: dict | None = None,
             cell_spec: tuple | None = None) -> dict:
    """One run of a cell; returns the result line's object. ``cell_spec``,
    a (workload, configuration) pair, stands in for the files that
    ``workload`` names."""
    wl, config = cell_spec or cell(workload, data_override)
    work = tempfile.mkdtemp(prefix="modkit-bench-")
    gen_proc = None
    try:
        cfg_path = os.path.join(work, "config.json")
        with open(cfg_path, "w") as fh:
            json.dump(config, fh)
        gen_proc = subprocess.Popen([
            sys.executable, os.path.join(BENCH, "gen.py"), "--config", cfg_path,
            "--seed", str(seed), "--out", work,
            "--workers", str(max(1, (os.cpu_count() or 2) - 1))],
            start_new_session=True)
        return _run(workload, wl, config, seed, seconds, trace, device, work,
                    gen_proc)
    finally:
        if gen_proc is not None and gen_proc.poll() is None:
            # the generator and its worker processes share one group
            os.killpg(gen_proc.pid, signal.SIGKILL)
            gen_proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def _run(workload, wl, config, seed, seconds, trace, device, work, gen_proc):
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise SystemExit("no CUDA device: this benchmark runs on the card only")
        torch.zeros(1, device="cuda")
    from modkit_tpu_torch import native
    from modkit_tpu_torch.ops import kernels

    # built once in a checkout: its first run's build is kept out of setup_s
    tb = time.perf_counter()
    if native.load() is None:
        raise RuntimeError("the program's native library did not load")
    if device == "cuda":
        kernels.kernel_lib("state")
    build_s = time.perf_counter() - tb

    tw = time.perf_counter()
    if gen_proc.wait() != 0:
        raise RuntimeError(f"the generator failed with {gen_proc.returncode}")
    log(f"set-up: the program loaded {tw - T0:.3f} s into the run, the data "
        f"{time.perf_counter() - tw:.3f} s later")
    meta = load_json(os.path.join(work, "meta.json"))
    bam, ref = os.path.join(work, "reads.bam"), os.path.join(work, "ref.fa")
    flags = workload_flags(wl, meta["thresholds"], ref)
    fifo = os.path.join(work, "out.bed")
    os.mkfifo(fifo)
    cfg = pileup_config([bam, fifo, *flags, "--device", device])
    drain = Drain(fifo)
    drain.start()
    rss = RssSampler()
    rss.start()
    jobs = []  # (seconds, digest, error, CPU seconds, thresholds, traced)
    peaks = []  # the highest VmRSS sampled by each job's end
    # where the program estimates the thresholds, what its estimate pools in
    # the warm-up and the first timed job is caught, to be judged after the
    # window
    probe = PoolProbe() if "--filter-threshold" not in flags else None
    pools = []
    kept = os.path.join(work, "kept.bed")
    metrics = [load_metric(m["name"]) for m in per_layer_metrics(workload)] if trace else []
    try:
        if probe is not None:
            probe.install()
        jobs.append(run_job(cfg, drain, None) + (False,))  # warm-up
        peaks.append(rss.peak)
        if probe is not None:
            pools.append(probe.take())
        setup_s = time.perf_counter() - T0 - build_s
        recorder = prof = None
        marks = ("bench_traced_start", "bench_traced_end")
        c_start = cpu_time()
        t_start = time.perf_counter()
        halves = [(seconds / 2, False), (seconds / 2, True)] if trace else [(seconds, False)]
        edges = []
        for length, traced in halves:
            if traced:
                from benchmark.trace import Recorder

                recorder = Recorder()
                recorder.install(metrics)
                if device == "cuda":
                    from torch.profiler import ProfilerActivity, profile, record_function

                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.start()
                    with record_function(marks[0]):
                        pass
                host_start = time.perf_counter_ns()
            h0 = time.perf_counter()
            while True:
                first = len(jobs) == 1
                jobs.append(run_job(cfg, drain, kept if first else None) + (traced,))
                peaks.append(rss.peak)
                if first and probe is not None:
                    pools.append(probe.take())
                    probe.remove()
                if jobs[-1][2] is not None or time.perf_counter() - h0 >= length:
                    break
            edges.append((h0, time.perf_counter()))
            if traced:
                if prof is not None:
                    with record_function(marks[1]):
                        pass
                    prof.stop()
                host_end = time.perf_counter_ns()
                recorder.remove()
            if jobs[-1][2] is not None:
                break
        t_end = time.perf_counter()
        c_end = cpu_time()
        peak_rss = rss.stop()
        mem_peak = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
    finally:
        if probe is not None:
            probe.remove()
        if rss.is_alive():
            rss.stop()
        drain.jobs.put(False)
        drain.release()
        drain.join(timeout=DRAIN_TIMEOUT_S)
    counters = launch_counters()
    timed = jobs[1:]
    n_reads = int(meta["reads"])
    rate = n_reads * len(timed) / (t_end - t_start)
    log(f"job seconds: {[round(j[0], 3) for j in jobs]} (the first warms up)")
    log(f"job CPU seconds: {[round(j[3], 3) for j in jobs]}; over the window "
        f"{c_end - c_start:.3f} s, {1e6 * (c_end - c_start) / (n_reads * len(timed)):.3f} us a read")
    log(f"jobs {len(timed)} in {t_end - t_start:.3f} s, {n_reads} reads a job, "
        f"calls a job by base {meta['calls_per_base']}; "
        f"set-up {setup_s:.3f} s, build {build_s:.3f} s apart; launch counters {counters}")
    log(f"harness threads' CPU over the run: drain {drain.cpu_s:.3f} s, "
        f"RSS sampler {rss.cpu_s:.3f} s ({rss.reads} reads); peak VmRSS sampled "
        f"{rss.peak_at - t_start:.3f} s into the window (before 0: the warm-up); "
        f"the peak by each job's end, MB: {[round(p / 1e6, 1) for p in peaks]}")

    # the reference, once the window has closed and the program's state is gone
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    from benchmark import reference

    tr0 = time.perf_counter()
    sampled = {}
    ref_bytes, ref_rows, ref_thresholds = reference.reference_bedmethyl(
        config, seed, flags, workers=os.cpu_count() or 1, sampled=sampled)
    ref_digest = digest(ref_bytes)
    failed = sum(1 for j in timed if j[2] is not None)
    jobs_differing = sum(1 for j in jobs if j[1] != ref_digest)
    if timed and timed[0][1] == ref_digest:
        differing = 0
    else:
        got = b""
        if os.path.exists(kept):
            with open(kept, "rb") as fh:
                got = fh.read()
        differing = rows_differing(got, ref_bytes)
    log(f"reference: {ref_rows} rows in {time.perf_counter() - tr0:.3f} s")
    if sampled:
        # the program estimated the thresholds: each job's, base for base,
        # against the reference's in float32
        import numpy as np

        def same(got: dict | None) -> bool:
            return got is not None and set(got) == set(ref_thresholds) and all(
                np.float32(got[b]) == np.float32(t) for b, t in ref_thresholds.items())

        threshold_differing = sum(1 for j in jobs if not same(j[4]))
        # and what the warm-up and the first timed job pooled, against the
        # reference's sampled reads' confidences, bin for bin and base for
        # base; a base outside the call set, or no pool, differs
        want = {BASE_INDEX[b]: h for b, h in sampled["pooled"].items()}
        pool_differing = sum(
            1 for p in pools
            if p is None or set(p) != set(want)
            or any(p[i][1] != 0 or not np.array_equal(p[i][0], h) for i, h in want.items()))
        log(f"reference estimate: {len(sampled['reads'])} reads sampled (quota "
            f"{sampled['quota']}, {sampled['regions']} regions), "
            f"{sampled['confidences']} confidences pooled, thresholds "
            f"{ref_thresholds!r}; the jobs' thresholds "
            f"{sorted({tuple(sorted((j[4] or {}).items())) for j in jobs})}; "
            f"the probed jobs' pools (confidences, off the grid) "
            f"{[None if p is None else {b: (int(h.sum()), o) for b, (h, o) in p.items()} for p in pools]}")
    for j in jobs:
        if j[2] is not None:
            log(f"job failed: {j[2]}")

    info = device_info(device)
    result = {
        "correct": (failed == 0 and jobs_differing == 0 and differing == 0
                    and (not sampled or threshold_differing == pool_differing == 0)),
        "attempted": len(timed), "failed": failed, "metrics": {},
        "device": {**info, "memory_peak_bytes": int(mem_peak)},
    }
    e2e = {"pileup_reads_per_s": rate, "peak_rss_mb": peak_rss / 1e6, "setup_s": setup_s}
    if trace:
        half = [j for j in timed if j[5]]
        if half:
            h0, h1 = edges[-1]
            log(f"traced half: {n_reads * len(half) / (h1 - h0):.3f} reads/s; "
                f"untraced half: "
                f"{n_reads * (len(timed) - len(half)) / (edges[0][1] - edges[0][0]):.3f} reads/s")
        tr = _trace(recorder, prof, marks, host_start, host_end, info["kind"], work)
        tr.host.update(e2e)
        for m, mod in zip(per_layer_metrics(workload), metrics):
            v = mod.read(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if tr.device:
            result["device"]["busy_s"] = sum(e - s for s, e in tr.busy())
            result["device"]["window_s"] = tr.window[1] - tr.window[0]
            from benchmark.trace import breakdown

            result["breakdown"] = breakdown(tr)
    else:
        spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        for m in spec["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                # ``x.cell`` reads the run's ``x``, under a bound of its own
                # in the cells it lists
                result["metrics"][m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                                "unit": m["unit"]}
    checks = {
        "jobs_differing": {"value": jobs_differing, "limit": 0},
        "rows_differing": {"value": differing, "limit": 0},
        "jobs_failed": {"value": failed, "limit": 0},
    }
    if sampled:
        checks["threshold_differing"] = {"value": threshold_differing, "limit": 0}
        checks["pool_differing"] = {"value": pool_differing, "limit": 0}
    result["build_s"] = build_s
    result["checks"] = checks
    return result


def _trace(recorder, prof, marks, host_start, host_end, kind, work):
    """The Trace of the traced half, on the profiler's clock (or on the
    host clock where no profiler ran)."""
    from benchmark.trace import Trace, device_events

    dev, window = [], (host_start * 1e-9, host_end * 1e-9)
    offset = 0.0
    if prof is not None:
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        dev, window = device_events(path, marks)
        offset = window[0] - host_start * 1e-9
    spans = [(n, a * 1e-9 + offset, b * 1e-9 + offset) for n, a, b in recorder.spans]
    return Trace(spans, dict(recorder.counts), dev, window, kind)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="modkit_tpu_torch pileup benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's own switches (profiling, native route, multi-host) stay
    # at what a user gets by default
    for k in [k for k in os.environ if k.startswith("MODKIT_TPU_")]:
        del os.environ[k]
    for d in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.environ[d] = os.path.join(ROOT, ".bench_cache", d.lower())
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
