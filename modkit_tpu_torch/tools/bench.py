"""User-level benchmark of modkit_tpu_torch: pileup reads/s end to end, the
host tools against their ceilings, and the kernels' rooflines on the card.

Port of ``bench.py``. Usage:

    python -m modkit_tpu_torch.tools.bench [--device cuda|cpu]

``cuda`` is the default; without a CUDA device a run that did not ask for
the CPU raises. The workload and knobs are the original's:
``MODKIT_BENCH_READS`` (50 000) reads of ``MODKIT_BENCH_READ_LEN`` (5 000)
bases at ``MODKIT_BENCH_COVERAGE`` (25x) over a 10 Mbp contig, seed 1;
``MODKIT_BENCH_REPS`` (3) timed runs (the original's
``MODKIT_BENCH_DEV_REPS`` timed its forced-device runs, which the port has
not);
entropy, extract and dmr over ``MODKIT_BENCH_ENTROPY_READS`` (5 000) reads,
seed 2. It times, on the run's device:

- pileup with no filtering (the headline ``value``; the run's device does
  every tile's call, as in every pileup) and the all-C++ CPU baseline
  (``cpu_baseline.run_pileup_cpu``, ``vs_baseline``), and in the default
  estimate+filter mode on both;
- ``call-mods`` (``engines/adjust.adjust_modbam``), ``entropy`` against
  its reference-shaped scan (``MODKIT_TPU_ENTROPY_BASELINE=1``),
  ``extract full`` against writing the same bytes raw, and ``dmr pair``
  per site against the ``SampleIndex`` parse of both samples.

Every pileup of a mode must write the bytes of the CPU baseline's, and
entropy those of its baseline shape; a mismatch exits non-zero. Beside the
original's fields it records the card (``nvidia-smi``'s name and power
limit), kernel A's launches in the first timed no-filtering run
(``state_launches``) and the warm-up run apart (``device_warm_wall_s``),
since it includes the kernels' first-use ``nvcc`` build (the original
waited out its background compiles there). ``link_bandwidth_MBps`` is one
4 MiB pinned copy to the card timed with CUDA events; the rooflines read it.

The original's keys that the port drops, with the reason: it timed pileup
twice, under its offload policy (``auto``) and with the device forced,
and probed the host's counting rate for that policy; the port has one
route, so the forced runs' wall and rate (``device_forced_*``) and the
probe's rate in Mevents/s have no counterpart (``auto_wall_s`` is the one
route's wall), nor have the port's own route and launch keys of the two
runs (``auto_route``, ``auto_state_launches``,
``forced_state_launches``); ``tests/test_torch_tools.py`` lists them all.

``kernel_roofline`` (``null`` under ``--device cpu``): at 4 194 304 events,
M = 2, over 100 000 positions (``numpy.random.default_rng(7)``), each of

- ``threshold_state``: kernel A's f32 entry (``ops/state.py``), the
  counterpart of ``threshold_states``;
- ``matmul``: ``ops/lab_counts.count_call``, the rep8 histogram that
  replaces ``_count_call``;
- ``pipeline``: kernel B (``ops/counts.modcall_counts``), the fused call
  and count that replaces ``_counts_from_prepared``;

is first held exactly against its plain version (and the histograms
against ``modcall_counts_numpy`` or the bincount oracle), then timed with
CUDA events (``true_bench.cuda_time_ms``) warm (the same inputs back to
back, in L2 where they fit) and L2-cold (each call reads the next of
``cold_copies`` distinct copies of its inputs, together at least four
times the card's L2). Each reading gives events/s, the bytes the function
moves per event (inputs read once, output written once), its share of the
HBM read rate ``true_bench`` measures, the events/s the host link allows
for the bytes that cross it per event (kernel A's and B's inputs), and the
plain version's time on the same inputs; a share above 100% is an
error of the yardstick and is listed in ``over_hbm_bound``. The original
subtracted a fetch round trip because its TPU backend returned before the
work ran (``fetch_round_trip_ms``); CUDA events time the device itself, so
that key has no counterpart. Nor has ``matmul_pct_of_int8_mxu_ceiling``:
the port's rep8 body counts with shared-memory atomics, on no tensor core.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
The work directory lies under ``TMPDIR`` and is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOF_EVENTS = 64 * 65536
ROOF_POSITIONS = 100_000
ROOF_CODES = 2
# the L2 of an H100, where torch does not report the device's
DEFAULT_L2_BYTES = 50 * 1024 * 1024


def _note(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def _link_bandwidth_bytes_per_s(dev) -> float:
    """Host-to-device bandwidth of ``dev``: one 4 MiB copy from pinned
    memory timed with CUDA events (infinite on the CPU: no link)."""
    import torch

    if dev.type == "cpu":
        return float("inf")
    buf = torch.zeros(1 << 22, dtype=torch.uint8, pin_memory=True)
    with torch.cuda.device(dev):
        buf[: 1 << 14].to(dev, non_blocking=True)  # warm the path
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        buf.to(dev, non_blocking=True)
        stop.record()
        stop.synchronize()
    return float(buf.numel()) / max(start.elapsed_time(stop) / 1e3, 1e-9)


def state_launches() -> int:
    from ..ops import state

    return state.STATE_KERNEL_LAUNCHES + state.STATE_F32_KERNEL_LAUNCHES


def _timed_copies(fn, copies, reps: int) -> tuple[float, float]:
    """(warm ms, L2-cold ms) of ``fn(*copy)``: warm repeats ``copies[0]``;
    cold takes the next copy on every call."""
    from .true_bench import cuda_time_ms

    warm, _ = cuda_time_ms(lambda: fn(*copies[0]), reps)
    turn = [0]

    def cold_call():
        fn(*copies[turn[0] % len(copies)])
        turn[0] += 1

    cold, _ = cuda_time_ms(cold_call, reps * len(copies))
    return warm, cold


def _n_copies(nbytes: int, l2: int) -> int:
    return max(2, math.ceil(4 * l2 / max(nbytes, 1)))


def _clones(tensors, k: int) -> list:
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(k - 1)]


def kernel_rooflines(link_bw: float, reps: int = 50) -> dict:
    """The three kernels' warm and L2-cold rooflines on the card (see the
    module docstring)."""
    import numpy as np
    import torch

    from ..ops import counts, lab_counts, state
    from . import kernel_lab, true_bench

    dev = torch.device("cuda")
    hbm_gbps = true_bench.hbm_read_gbps()
    torch.cuda.empty_cache()
    props = torch.cuda.get_device_properties(dev)
    l2 = int(getattr(props, "L2_cache_size", 0) or DEFAULT_L2_BYTES)
    n, m, p = ROOF_EVENTS, ROOF_CODES, ROOF_POSITIONS
    events = kernel_lab.lab_events(n, p, m)
    rpos, strand, base, probs = events
    thr_mod = np.full((m, 4), 0.5, np.float32)
    thr_can = np.full(4, 0.5, np.float32)
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
    over = []

    def reading(name, ms_warm, ms_cold, plain, bpe, link_bpe=None):
        plain_ms, _ = true_bench.cuda_time_ms(plain, 3, warmup=1)
        eps_w, eps_c = n / (ms_warm * 1e-3), n / (ms_cold * 1e-3)
        pct_w = 100.0 * eps_w * bpe / (hbm_gbps * 1e9)
        pct_c = 100.0 * eps_c * bpe / (hbm_gbps * 1e9)
        for tag, pct in (("warm", pct_w), ("cold", pct_c)):
            if pct > 100.0:
                over.append(f"{name} {tag} {pct:.1f}%")
        out = dict(events_per_s=eps_w, cold_events_per_s=eps_c,
                   ms=ms_warm, cold_ms=ms_cold, plain_ms=plain_ms,
                   bytes_per_event_hbm=bpe,
                   pct_of_hbm_read_bound=pct_w,
                   cold_pct_of_hbm_read_bound=pct_c)
        if link_bpe is not None:
            out["link_bound_events_per_s"] = link_bw / link_bpe
        return out

    # ---- threshold state: kernel A's f32 entry ----
    probs_d = torch.from_numpy(probs).to(dev)
    base_d = torch.from_numpy(base.astype(np.uint8)).to(dev)
    got = state.threshold_state_f32(probs_d, base_d, tm, tc)
    plain = lambda: state.threshold_state_f32_plain(probs_d, base_d, tm, tc)
    state_equal = bool(torch.equal(got, plain()))
    state_bpe = 4 * m + 1 + 1  # f32 row + u8 base in, u8 state out
    k = _n_copies(n * state_bpe, l2)
    warm, cold = _timed_copies(
        lambda a, b: state.threshold_state_f32(a, b, tm, tc),
        _clones((probs_d, base_d), k), reps)
    st = dict(kernel="cuda state_f32_rows_kernel (csrc/state.cu)",
              cold_copies=k, outputs_equal_plain=state_equal,
              **reading("threshold_state", warm, cold, plain, state_bpe,
                        state_bpe))
    del probs_d, base_d
    torch.cuda.empty_cache()

    # ---- matmul: the rep8 histogram of _count_call ----
    lab = kernel_lab.LabInputs.build(events, p, dev)
    c2g, g = lab.planes[0], lab.n_groups
    p2r, colr = lab.rep8
    got = lab_counts.count_call(c2g, p2r, colr, n_groups=g)
    plain = lambda: lab_counts.rep8_plain(c2g, p2r, colr, g, lab.chunk)
    matmul_equal = bool(torch.equal(got, plain()))
    matmul_oracle = bool(np.array_equal(got.cpu().numpy(), lab.oracle()))
    slots = lab.n_chunks * lab.chunk
    mm_bytes = (slots * 16 + lab.n_chunks * 4
                + g * lab_counts.CELLS * 4)  # 2 rep8 planes, c2g, the output
    k_mm = _n_copies(mm_bytes, l2)
    warm, cold = _timed_copies(
        lambda a, b, c: lab_counts.count_call(a, b, c, n_groups=g),
        _clones((c2g, p2r, colr), k_mm), reps)
    mm = reading("matmul", warm, cold, plain, mm_bytes / n)
    del lab, c2g, p2r, colr
    torch.cuda.empty_cache()

    # ---- pipeline: kernel B ----
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (rpos, strand, base, probs)]
    got = counts.modcall_counts(*args, tm, tc, p)
    want = counts.modcall_counts_numpy(
        rpos.astype(np.int64), strand.astype(np.int64),
        base.astype(np.int64), probs, thr_mod, thr_can, p, m)
    km = 1 + 4 * (m + 1)
    plain = lambda: counts.modcall_counts_plain(*args, tm, tc, p)
    pipe_equal = bool(torch.equal(got, plain()))
    oracle_equal = bool(np.array_equal(got.cpu().numpy(), want))
    pipe_bytes = n * (12 + 4 * m) + p * 2 * km * 4
    k_pipe = _n_copies(pipe_bytes, l2)
    warm, cold = _timed_copies(
        lambda *a: counts.modcall_counts(*a, tm, tc, p),
        _clones(args, k_pipe), reps)
    pipe = reading("pipeline", warm, cold, plain, pipe_bytes / n, 12 + 4 * m)
    del args
    torch.cuda.empty_cache()

    count = dict(
        kernel="cuda rep8 histogram (csrc/lab_counts.cu hist_kernel) and "
               "kernel B (csrc/counts.cu zero_kernel + scatter_kernel)",
        outputs_equal_numpy_oracle=matmul_oracle and oracle_equal,
        matmul_equal_plain=matmul_equal, pipeline_equal_plain=pipe_equal,
        matmul_cold_copies=k_mm, pipeline_cold_copies=k_pipe,
        **{f"matmul_{key}": v for key, v in mm.items()},
        **{f"pipeline_{key}": v for key, v in pipe.items()},
    )
    return {
        "measurement": "CUDA events around back-to-back launches "
                       "(true_bench.cuda_time_ms); warm: the same inputs, "
                       "cold: distinct copies whose sum is >= 4x L2",
        "l2_bytes": l2,
        "hbm_read_GBps": hbm_gbps,
        "threshold_state": st,
        "pileup_count_kernel": count,
        "over_hbm_bound": over,
    }


def _same(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"bench: {what}")


def _knob(name: str, default: str, kind=int):
    return kind(os.environ.get(name, default))


def run(device: str = "cuda") -> dict:
    """The benchmark on ``device``; returns the JSON line's object. Raises
    (RuntimeError) where an output differs from its baseline's. The
    environment's MODKIT_TPU_ENTROPY_BASELINE is restored after."""
    from ..parallel.devices import resolve_device

    dev = resolve_device(device)
    saved = os.environ.get("MODKIT_TPU_ENTROPY_BASELINE")
    tmp = tempfile.mkdtemp(prefix="modkit_bench_")
    try:
        return _bench(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved is None:
            os.environ.pop("MODKIT_TPU_ENTROPY_BASELINE", None)
        else:
            os.environ["MODKIT_TPU_ENTROPY_BASELINE"] = saved


def _bench(dev, tmp: str) -> dict:
    from ..caller import ThresholdCaller
    from ..cli import main as cli_main
    from ..cpu_baseline import run_pileup_cpu
    from ..engines.adjust import adjust_modbam
    from ..engines.dmr import SampleIndex, default_code_lookup
    from ..io.tabix import bgzip_text, build_tabix
    from ..pileup.runner import PileupConfig, run_pileup
    from ..utils.synth import make_synthetic_modbam

    device = str(dev)
    n_reads = _knob("MODKIT_BENCH_READS", "50000")
    read_len = _knob("MODKIT_BENCH_READ_LEN", "5000")
    coverage = _knob("MODKIT_BENCH_COVERAGE", "25", float)
    reps = _knob("MODKIT_BENCH_REPS", "3")
    ent_reads = _knob("MODKIT_BENCH_ENTROPY_READS", "5000")

    bam = os.path.join(tmp, "synth.bam")
    t0 = time.perf_counter()
    stats = make_synthetic_modbam(
        bam, n_reads=n_reads, read_len=read_len, coverage=coverage, seed=1)
    _note(f"generated {n_reads} reads in {time.perf_counter() - t0:.1f}s")

    def pileup(tag, **kw):
        """(seconds, kernel A launches) of one run of the engine."""
        before = state_launches()
        t0 = time.perf_counter()
        res = run_pileup(PileupConfig(
            in_bam=bam, out=os.path.join(tmp, f"{tag}.bed"),
            suppress_progress=True, device=device, **kw))
        dt = time.perf_counter() - t0
        _check(res["rows"] > 0, f"pileup {tag} wrote no rows")
        _note(f"pileup {tag}: {dt:.1f}s")
        return dt, state_launches() - before

    def cpu_baseline(tag, **kw):
        t0 = time.perf_counter()
        res = run_pileup_cpu(bam, os.path.join(tmp, f"{tag}.bed"), **kw)
        dt = time.perf_counter() - t0
        _check(res["rows"] > 0, f"cpu baseline {tag} wrote no rows")
        _note(f"cpu baseline {tag}: {dt:.1f}s")
        return dt

    link_bw = _link_bandwidth_bytes_per_s(dev)
    _note(f"link {link_bw / 1e6:.0f} MB/s")

    # the first run builds the kernels (nvcc) on first use: timed apart
    warm_wall, _ = pileup("warm", no_filtering=True)
    timed = [pileup(f"a{i}", no_filtering=True) for i in range(reps)]
    best = min(t for t, _ in timed)
    launches = timed[0][1]
    # DEFAULT config: threshold estimate (10042-read sample) + filtered
    # pileup, what users get with no flags
    est_wall = min(pileup(f"est{i}")[0] for i in range(reps))
    best_cpu = min(cpu_baseline(f"c{i}") for i in range(reps))
    best_cpu_default = min(cpu_baseline(f"cd{i}", no_filtering=False)
                           for i in range(reps))

    # native adjust-mods/call-mods rewriter throughput (modBAM -> modBAM)
    def time_adjust(i):
        t0 = time.perf_counter()
        st = adjust_modbam(
            bam, os.path.join(tmp, f"adj{i}.bam"), (),
            ThresholdCaller({"C": 0.7, "A": 0.7}, {}, 0.7), None,
            filter_only=False,
        )
        dt = time.perf_counter() - t0
        _check(st["records_written"] > 0, "call-mods wrote no records")
        _note(f"call-mods {i}: {dt:.1f}s")
        return dt

    best_adjust = min(time_adjust(i) for i in range(2))

    # entropy against the reference's scan shape
    # (MODKIT_TPU_ENTROPY_BASELINE=1: window batches of floor(1.5*threads)
    # fetched and decoded independently, every read offered to every
    # window, with this engine's decode and entropy primitives)
    ent_bam = os.path.join(tmp, "ent.bam")
    ent_fa = os.path.join(tmp, "ent.fa")
    ent_stats = make_synthetic_modbam(
        ent_bam, n_reads=ent_reads, read_len=read_len, coverage=coverage,
        seed=2, fasta_out=ent_fa,
    )
    ent_args = ["entropy", "-s", ent_bam, "--ref", ent_fa, "--cpg", "-t",
                "2", "--force", "--suppress-progress"]

    def time_entropy(tag, baseline=False):
        out = os.path.join(tmp, f"ent_{tag}.bedgraph")
        if baseline:
            os.environ["MODKIT_TPU_ENTROPY_BASELINE"] = "1"
        else:
            os.environ.pop("MODKIT_TPU_ENTROPY_BASELINE", None)
        t0 = time.perf_counter()
        cli_main(ent_args + ["-o", out])
        dt = time.perf_counter() - t0
        _note(f"entropy {tag}: {dt:.1f}s")
        return dt

    best_entropy = min(time_entropy(f"e{i}") for i in range(2))
    entropy_base = time_entropy("base", baseline=True)
    os.environ.pop("MODKIT_TPU_ENTROPY_BASELINE", None)
    ent_eq = _same(os.path.join(tmp, "ent_e0.bedgraph"),
                   os.path.join(tmp, "ent_base.bedgraph"))
    _check(ent_eq, "entropy engine != baseline-shape output")

    # extract full against writing the same volume raw: extract is bound by
    # its output (one TSV row per read, position and code)
    ext_out = os.path.join(tmp, "extract.tsv")
    t0 = time.perf_counter()
    cli_main(["extract", "full", ent_bam, ext_out, "--force",
              "--suppress-progress", "-t", "2"])
    extract_wall = time.perf_counter() - t0
    ext_bytes = os.path.getsize(ext_out)
    _note(f"extract full: {extract_wall:.1f}s, "
          f"{ext_bytes / extract_wall / 1e6:.0f} MB/s")
    with open(ext_out, "rb") as fh:
        blob = fh.read(1 << 24)
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "raw.bin"), "wb") as fh:
        written = 0
        while written < ext_bytes:
            fh.write(blob)
            written += len(blob)
        fh.flush()
        os.fsync(fh.fileno())
    raw_write_wall = time.perf_counter() - t0
    _note(f"raw write of same volume: {raw_write_wall:.1f}s")

    # dmr per site against the bedMethyl parse ceiling (the scoring is
    # closed-form; reading both samples is the structural bound)
    dmr_a = os.path.join(tmp, "dmr_a.bed")
    cli_main(["pileup", ent_bam, dmr_a, "--no-filtering",
              "--suppress-progress", "--device", dev.type])
    gzs = [os.path.join(tmp, f"dmr_{name}.bed.gz") for name in ("a", "b")]
    for gz in gzs:
        bgzip_text(dmr_a, gz)
        build_tabix(gz)
    dmr_out = os.path.join(tmp, "dmr_out.bed")
    t0 = time.perf_counter()
    cli_main(["dmr", "pair", "-a", gzs[0], "-b", gzs[1], "-o", dmr_out,
              "--ref", ent_fa, "--base", "C", "-f", "--suppress-progress"])
    dmr_wall = time.perf_counter() - t0
    with open(dmr_out) as fh:
        n_sites = sum(1 for _ in fh)
    _note(f"dmr single-site: {dmr_wall:.1f}s, {n_sites} sites")
    si = SampleIndex(gzs, default_code_lookup(None))
    t0 = time.perf_counter()
    n_lines = 0
    for sid in (0, 1):
        for pos in range(0, ent_stats["contig_len"], 1_000_000):
            n_lines += len(si.read_lines(sid, "synth1", pos, pos + 1_000_000))
    dmr_parse_wall = time.perf_counter() - t0
    _note(f"dmr parse-only ceiling: {dmr_parse_wall:.1f}s ({n_lines} lines)")

    def bed(tag):
        return os.path.join(tmp, f"{tag}.bed")

    _check(_same(bed("a0"), bed("c0")), "engine != CPU baseline output")
    _check(_same(bed("est0"), bed("cd0")),
           "default engine != CPU baseline default")

    roofline = kernel_rooflines(link_bw) if dev.type == "cuda" else None
    return {
        "metric": "pileup_reads_per_s",
        "value": n_reads / best,
        "unit": f"reads/s ({read_len}b reads, {coverage:g}x, 2 mod codes)",
        "vs_baseline": best_cpu / best,
        "extra": {
            "baseline": "all-C++ multithreaded CPU pileup "
                        "(modkit_tpu_torch.cpu_baseline)",
            "device": device,
            "card": card_line() if dev.type == "cuda" else None,
            "state_launches": launches,
            "device_warm_wall_s": warm_wall,
            "cpu_baseline_reads_per_s": n_reads / best_cpu,
            "positions_per_s": stats["contig_len"] / best,
            "auto_wall_s": best,
            "default_filtered_wall_s": est_wall,
            "default_filtered_reads_per_s": n_reads / est_wall,
            "vs_baseline_default": best_cpu_default / est_wall,
            "cpu_default_wall_s": best_cpu_default,
            "adjust_wall_s": best_adjust,
            "adjust_reads_per_s": n_reads / best_adjust,
            "extract_wall_s": extract_wall,
            "extract_reads_per_s": ent_reads / extract_wall,
            "extract_out_MBps": ext_bytes / extract_wall / 1e6,
            "extract_pct_of_raw_write_ceiling":
                100.0 * raw_write_wall / extract_wall,
            "dmr_single_site_wall_s": dmr_wall,
            "dmr_sites_per_s": n_sites / dmr_wall,
            "dmr_pct_of_parse_ceiling": 100.0 * dmr_parse_wall / dmr_wall,
            "entropy_wall_s": best_entropy,
            "entropy_reads_per_s": ent_reads / best_entropy,
            "vs_baseline_entropy": entropy_base / best_entropy,
            "entropy_baseline_wall_s": entropy_base,
            "entropy_outputs_identical": ent_eq,
            "cpu_wall_s": best_cpu,
            "n_reads": n_reads,
            "contig_len": stats["contig_len"],
            "n_tiles": -(-stats["contig_len"] // 100_000),
            # a CPU run has no link (its bandwidth is infinite)
            "link_bandwidth_MBps": (link_bw / 1e6 if math.isfinite(link_bw)
                                    else None),
            "kernel_roofline": roofline,
            "outputs_identical": True,
        },
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m modkit_tpu_torch.tools.bench",
        description="End-to-end benchmark of modkit_tpu_torch: one JSON "
                    "line on stdout.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the run (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
