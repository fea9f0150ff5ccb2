"""The port's count-kernel lab (ops/count_layout.py, ops/lab_counts.py,
tools/kernel_lab.py) against the JAX lab, tools/kernel_lab.py.

Every comparison is exact (``np.array_equal``): the counts are integers.
The JAX kernels run under ``pltpu.force_tpu_interpret_mode()`` on the CPU
and the port's wrappers run their plain PyTorch versions (CPU tensors), on
the same inputs made with numpy from a seed. ``tools/`` is no package, so
the JAX lab is loaded by file path. Groups that no chunk visits are left
unwritten by the TPU kernels; only visited groups are compared, and the
port's are checked to be zero. The CUDA kernels are held against the plain
versions in test_torch_cuda.py.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from modkit_tpu.ops import pallas_counts as jpc
from modkit_tpu_torch.ops import count_layout as cl
from modkit_tpu_torch.ops import lab_counts as lc
from modkit_tpu_torch.tools import kernel_lab as port_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_lab():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_lab", os.path.join(REPO, "tools", "kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jlab = _load_jax_lab()

N, P = 5000, 2000
JAX_DT = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16,
          torch.int32: jnp.int32, torch.float32: jnp.float32}


def _jax_prepare(events, p, m, chunk):
    """The original planner at ``chunk``, patched in as the JAX lab does."""
    oc, ocr = jpc.CHUNK, jpc.CR
    try:
        jpc.CHUNK, jpc.CR = chunk, chunk // jpc.LANES
        return jpc.prepare_events(*events, p, m)
    finally:
        jpc.CHUNK, jpc.CR = oc, ocr


def _lab(chunk=cl.CHUNK, m=2, n=N, p=P, seed=port_lab.SEED):
    events = port_lab.lab_events(n, p, m, seed)
    return port_lab.LabInputs.build(events, p, "cpu", chunk=chunk, m=m)


@pytest.fixture(scope="module")
def lab():
    return _lab()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _visited(c2g, n_groups):
    return np.bincount(c2g, minlength=n_groups) > 0


def _same(port_out, jax_out, c2g, n_groups):
    got = port_out.numpy() if isinstance(port_out, torch.Tensor) else port_out
    want = np.asarray(jax_out)
    vis = _visited(np.asarray(c2g), n_groups)
    assert got.dtype == np.int32 and got.shape == (n_groups, cl.P2, cl.LANES)
    assert np.array_equal(got[vis], want[vis])
    assert not got[~vis].any()


def _interpret(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw))


# ---- count_layout: the port's copies equal the originals ----

def test_layout_constants_and_plan_equal_the_original():
    for name in ("LANES", "CHUNK", "CR", "REP", "WIN_POS", "P2"):
        assert getattr(cl, name) == getattr(jpc, name)
    for m in range(1, 16):
        try:
            want = jpc._plan(m)
        except ValueError:
            with pytest.raises(ValueError, match="too many mod codes"):
                cl._plan(m)
            continue
        assert cl._plan(m) == want


@pytest.mark.parametrize("m,chunk,p", [(2, 2048, 2000), (4, 2048, 3000),
                                       (2, 256, 2000), (1, 512, 50)])
def test_prepare_events_equals_the_original(m, chunk, p):
    events = port_lab.lab_events(3000, p, m, seed=m + chunk)
    got = cl.prepare_events(*events, p, m, chunk=chunk)
    want = _jax_prepare(events, p, m, chunk)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_prepare_events_without_events_equals_the_original():
    events = port_lab.lab_events(0, 100, 2)
    got = cl.prepare_events(*events, 100, 2)
    want = jpc.prepare_events(*events, 100, 2)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


def test_pack_and_rep8_equal_the_originals(lab):
    got = cl.pack_events_u8(lab.c2g, lab.p2, lab.col, lab.valid,
                            lab.n_groups)
    want = jlab.pack_events_u8(lab.c2g, lab.p2, lab.col, lab.valid,
                               lab.n_groups)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the lab's rep8_prod (kernel_lab.py:476-482) and the device expansion
    # of pallas_counts.py:264-272
    nc = lab.n_chunks
    col_v = np.where(lab.valid.reshape(nc, cl.CHUNK) != 0,
                     lab.col.reshape(nc, cl.CHUNK), 255)
    want_col = np.repeat(col_v.reshape(nc, 1, cl.CHUNK).astype(np.uint8), 8,
                         axis=1).reshape(nc * 8, cl.CHUNK)
    assert np.array_equal(cl.rep8(lab.col, nc, valid=lab.valid), want_col)
    want_p2 = np.asarray(jnp.broadcast_to(
        jnp.asarray(lab.p2).reshape(nc, 1, cl.CHUNK),
        (nc, cl.REP, cl.CHUNK)).reshape(nc * cl.REP, cl.CHUNK))
    assert np.array_equal(cl.rep8(lab.p2, nc), want_p2)


def test_lab_data_equals_the_original_lab(lab):
    """lab_events + counters_for reproduce the JAX lab's main (:448-469)."""
    rng = np.random.default_rng(7)
    rpos = rng.integers(0, P, N).astype(np.int32)
    strand = rng.integers(0, 2, N).astype(np.int32)
    base = rng.integers(0, 4, N).astype(np.int32)
    probs = rng.random((N, 2), dtype=np.float32)
    plan, c2g, p2, colb, valid, *_ = jpc.prepare_events(
        rpos, strand, base, probs, P, 2)
    col = colb + ((p2 * 13 + colb // plan["kc"]) % 13).astype(np.int32)
    assert np.array_equal(lab.c2g, c2g) and np.array_equal(lab.col, col)
    assert lab.col.dtype == col.dtype == np.int32
    assert np.array_equal(lab.oracle(), np.asarray(jpc._count_call(
        c2g, cl.rep8(p2, len(c2g)), cl.rep8(col, len(c2g), valid=valid),
        n_groups=lab.n_groups, interpret=True)))


# ---- the six lab kernels and _count_call: plain == JAX ----

@pytest.mark.parametrize("name", ["bf16x2", "bf16x4", "int8x1", "int8x4"])
def test_run_variant(lab, name):
    oh, acc = port_lab._dtypes(name)
    n_acc = int(name.split("x")[1])
    got = lc.run_variant(*lab.planes, n_groups=lab.n_groups, acc=acc, oh=oh,
                         n_acc=n_acc)
    want = _interpret(jlab.run_variant, *[a.numpy() for a in lab.planes],
                      n_groups=lab.n_groups, acc=JAX_DT[acc], oh=JAX_DT[oh],
                      n_acc=n_acc)
    _same(got, want, lab.c2g, lab.n_groups)
    assert np.array_equal(got.numpy(), lab.oracle())


@pytest.mark.parametrize("oh,acc", [(torch.bfloat16, torch.float32),
                                    (torch.int8, torch.int32)])
def test_run_bigk(lab, oh, acc):
    got = lc.run_bigk(*lab.planes, n_groups=lab.n_groups, oh=oh, acc=acc)
    want = _interpret(jlab.run_bigk, *[a.numpy() for a in lab.planes],
                      n_groups=lab.n_groups, oh=JAX_DT[oh], acc=JAX_DT[acc])
    _same(got, want, lab.c2g, lab.n_groups)


@pytest.mark.parametrize("mode", lc.DIAG_MODES)
def test_run_diag(lab, mode):
    got = lc.run_diag(*lab.planes, n_groups=lab.n_groups, mode=mode)
    want = _interpret(jlab.run_diag, *[a.numpy() for a in lab.planes],
                      n_groups=lab.n_groups, mode=mode)
    _same(got, want, lab.c2g, lab.n_groups)
    if mode != "empty":
        assert got.sum() > 0


@pytest.mark.parametrize("oh,acc,n_acc", [(torch.int8, torch.int32, 1),
                                          (torch.bfloat16, torch.float32, 2)])
def test_run_group(lab, oh, acc, n_acc):
    gmeta, packed = lab.packed
    got = lc.run_group(gmeta, packed, n_groups=lab.n_groups, oh=oh, acc=acc,
                       n_acc=n_acc)
    want = _interpret(jlab.run_group, gmeta.numpy(), packed.numpy(),
                      n_groups=lab.n_groups, oh=JAX_DT[oh], acc=JAX_DT[acc],
                      max_chunks=int(gmeta[:lab.n_groups].max()), n_acc=n_acc)
    # run_group writes every group, an empty one as zeros
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), lab.oracle())


def test_run_group_with_empty_groups_and_its_own_ranges():
    """Chunk ranges come from gmeta, not c2g: group 1 counts nothing, group
    2 recounts group 0's chunk."""
    lab = _lab()
    gmeta, packed = lab.packed
    g = lab.n_groups
    cnt, start = gmeta[:g].clone(), gmeta[g:].clone()
    cnt[1], cnt[2], start[2] = 0, 1, start[0]
    gm = torch.cat([cnt, start])
    got = lc.run_group(gm, packed, n_groups=g, oh=torch.int8, acc=torch.int32)
    want = _interpret(jlab.run_group, gm.numpy(), packed.numpy(), n_groups=g,
                      oh=jnp.int8, acc=jnp.int32, max_chunks=int(cnt.max()))
    assert np.array_equal(got.numpy(), want)
    assert not got[1].any() and got[2].sum() > 0
    # ranges past the chunks, or of a negative count, count nowhere (the
    # TPU kernel would read outside its input there)
    cnt[1], cnt[3], start[3] = -3, 2, lab.n_chunks - 1
    got = lc.run_group(torch.cat([cnt, start]), packed, n_groups=g,
                       oh=torch.int8, acc=torch.int32)
    cnt[1], cnt[3] = 0, 1
    want = lc.run_group(torch.cat([cnt, start]), packed, n_groups=g,
                        oh=torch.int8, acc=torch.int32)
    assert torch.equal(got, want)
    assert not got[1].any() and got[3].sum() > 0


@pytest.mark.parametrize("oh,acc", [(torch.int8, torch.int32),
                                    (torch.bfloat16, torch.float32)])
def test_run_bigk_host(lab, oh, acc):
    got = lc.run_bigk_host(lab.planes[0], *lab.rows, n_groups=lab.n_groups,
                           oh=oh, acc=acc)
    want = _interpret(jlab.run_bigk_host, lab.c2g, *[a.numpy() for a in lab.rows],
                      n_groups=lab.n_groups, oh=JAX_DT[oh], acc=JAX_DT[acc])
    _same(got, want, lab.c2g, lab.n_groups)
    assert np.array_equal(got.numpy(), lab.oracle())


@pytest.mark.parametrize("oh,acc,chunk", [(torch.int8, torch.int32, 2048),
                                          (torch.bfloat16, torch.float32, 256)])
def test_run_rep8(oh, acc, chunk):
    lab = _lab(chunk=chunk)
    got = lc.run_rep8(lab.planes[0], *lab.rep8, n_groups=lab.n_groups, oh=oh,
                      acc=acc, chunk=chunk)
    want = _interpret(jlab.run_rep8, lab.c2g, *[a.numpy() for a in lab.rep8],
                      n_groups=lab.n_groups, oh=JAX_DT[oh], acc=JAX_DT[acc],
                      chunk=chunk)
    _same(got, want, lab.c2g, lab.n_groups)
    assert np.array_equal(got.numpy(), lab.oracle())


@pytest.mark.parametrize("chunk", [256, 2048])
def test_run_rep8_rows_not_replicated(chunk):
    """Random u8 rows, values >= 128 included: row i of the output reads
    replica row i % 8, column j replica row j % 8."""
    rng = np.random.default_rng(chunk)
    n_chunks, g = 5, 3
    c2g = np.array([0, 0, 1, 2, 2], dtype=np.int32)
    p2r = rng.integers(0, 256, (n_chunks * 8, chunk)).astype(np.uint8)
    colr = rng.integers(0, 256, (n_chunks * 8, chunk)).astype(np.uint8)
    got = lc.run_rep8(_t(c2g), _t(p2r), _t(colr), n_groups=g, oh=torch.int8,
                      acc=torch.int32, chunk=chunk)
    want = _interpret(jlab.run_rep8, c2g, p2r, colr, n_groups=g, oh=jnp.int8,
                      acc=jnp.int32, chunk=chunk)
    assert np.array_equal(got.numpy(), want) and got.sum() > 0


@pytest.mark.parametrize("ablation,env", [("no-dot", "LAB_NO_DOT"),
                                          ("no-construct", "LAB_NO_CONSTRUCT")])
def test_run_rep8_ablations(monkeypatch, ablation, env):
    """The original reads its ablation switches while tracing, so its jit
    caches are cleared around the call."""
    rng = np.random.default_rng(3)
    chunk, g = 256, 2
    c2g = np.array([0, 1, 1], dtype=np.int32)
    p2r = rng.integers(0, 256, (24, chunk)).astype(np.uint8)
    colr = rng.integers(0, 256, (24, chunk)).astype(np.uint8)
    got = lc.run_rep8(_t(c2g), _t(p2r), _t(colr), n_groups=g, oh=torch.int8,
                      acc=torch.int32, chunk=chunk, ablation=ablation)
    monkeypatch.setenv(env, "1")
    jax.clear_caches()
    try:
        want = _interpret(jlab.run_rep8, c2g, p2r, colr, n_groups=g,
                          oh=jnp.int8, acc=jnp.int32, chunk=chunk)
    finally:
        jax.clear_caches()
    assert np.array_equal(got.numpy(), want) and got.sum() > 0


def test_count_call_equals_pallas_count_call(lab):
    p2r, colr = lab.rep8
    got = lc.count_call(lab.planes[0], p2r, colr, n_groups=lab.n_groups)
    want = np.asarray(jpc._count_call(lab.c2g, p2r.numpy(), colr.numpy(),
                                      n_groups=lab.n_groups, interpret=True))
    _same(got, want, lab.c2g, lab.n_groups)


def test_four_codes_plan_and_unvisited_groups():
    """M = 4 (KC = 32, 256-position groups) with events on half the
    positions only, so some groups are never visited."""
    rng = np.random.default_rng(5)
    n, p, m = 4000, 3000, 4
    rpos = np.concatenate([rng.integers(0, 700, n // 2),
                           rng.integers(2000, 2600, n // 2)]).astype(np.int32)
    events = (rpos, *port_lab.lab_events(n, p, m, seed=5)[1:])
    lab = port_lab.LabInputs.build(events, p, "cpu", m=m)
    assert not _visited(lab.c2g, lab.n_groups).all()
    got = lc.run_variant(*lab.planes, n_groups=lab.n_groups, acc=torch.int32,
                         oh=torch.int8, n_acc=1)
    want = _interpret(jlab.run_variant, *[a.numpy() for a in lab.planes],
                      n_groups=lab.n_groups, acc=jnp.int32, oh=jnp.int8,
                      n_acc=1)
    _same(got, want, lab.c2g, lab.n_groups)
    assert np.array_equal(got.numpy(), lab.oracle())


def test_values_out_of_range_count_nowhere():
    """u8 p2 above 127 and int32 col outside [0, 128) match no output row
    or lane of the TPU kernel; the port drops them too."""
    rng = np.random.default_rng(9)
    n_chunks, g = 3, 2
    c2g = np.array([0, 1, 1], dtype=np.int32)
    p2 = rng.integers(0, 256, n_chunks * cl.CHUNK).astype(np.uint8)
    col = rng.integers(-40, 200, n_chunks * cl.CHUNK).astype(np.int32)
    valid = rng.integers(0, 2, n_chunks * cl.CHUNK).astype(np.int32)
    args = [_t(a) for a in (c2g, p2, col, valid)]
    got = lc.run_variant(*args, n_groups=g, acc=torch.int32, oh=torch.int8,
                         n_acc=1)
    want = _interpret(jlab.run_variant, c2g, p2, col, valid, n_groups=g,
                      acc=jnp.int32, oh=jnp.int8, n_acc=1)
    assert np.array_equal(got.numpy(), want)
    keep = (p2 < 128) & (col >= 0) & (col < 128) & (valid != 0)
    assert int(got.sum()) == int(keep.sum())
    for mode in ("onehot-only", "a-only"):
        got = lc.run_diag(*args, n_groups=g, mode=mode)
        want = _interpret(jlab.run_diag, c2g, p2, col, valid, n_groups=g,
                          mode=mode)
        assert np.array_equal(got.numpy(), want)


# ---- plans the TPU kernels could not take ----

def test_unsorted_c2g_is_refused(lab):
    """The plan check refuses what the TPU kernels could not take; the
    port's wrappers count the chunks in any order."""
    with pytest.raises(ValueError, match="non-decreasing"):
        cl.check_c2g(lab.c2g[::-1], lab.n_groups)
    with pytest.raises(ValueError, match="outside"):
        cl.check_c2g(lab.c2g, 1)
    cl.check_c2g(lab.c2g, lab.n_groups)
    nc = lab.n_chunks
    flipped = [t.reshape(nc, -1).flip(0).reshape(t.shape).contiguous()
               for t in lab.planes]
    got = lc.run_variant(*flipped, n_groups=lab.n_groups, acc=torch.int32,
                         oh=torch.int8, n_acc=1)
    assert np.array_equal(got.numpy(), lab.oracle())


def _chunk_rows(t, n_chunks, keep):
    return t.reshape(n_chunks, -1)[keep].reshape(-1, *t.shape[1:])


@pytest.mark.parametrize("case", [
    "run_variant", *lc.DIAG_MODES, "run_bigk_host", "run_rep8",
    *lc.ABLATIONS, "count_call"])
def test_chunks_of_no_group_count_nowhere(case):
    """A chunk whose group is outside [0, n_groups) adds nothing, as in the
    CUDA kernels: the result equals that of the other chunks alone."""
    rng = np.random.default_rng(21)
    g = 3
    c2g = np.array([0, 0, -1, 1, 3, 2], dtype=np.int32)
    n = len(c2g)
    if case in ("run_rep8", *lc.ABLATIONS, "count_call"):
        chunk = cl.CHUNK if case == "count_call" else 256
        arrays = [_t(rng.integers(0, 256, (n * cl.REP, chunk))
                     .astype(np.uint8)) for _ in range(2)]
        if case == "count_call":
            fn = lambda c, a, b: lc.count_call(c, a, b, n_groups=g)
        else:
            ablation = None if case == "run_rep8" else case
            fn = lambda c, a, b: lc.run_rep8(
                c, a, b, n_groups=g, oh=torch.int8, acc=torch.int32,
                chunk=chunk, ablation=ablation)
    elif case == "run_bigk_host":
        arrays = [_t(rng.integers(0, 256, (n, cl.CHUNK)).astype(np.uint8))
                  for _ in range(2)]
        fn = lambda c, a, b: lc.run_bigk_host(c, a, b, n_groups=g,
                                              oh=torch.int8, acc=torch.int32)
    else:
        slots = n * cl.CHUNK
        arrays = [_t(rng.integers(0, 256, slots).astype(np.uint8)),
                  _t(rng.integers(-40, 200, slots).astype(np.int32)),
                  _t(rng.integers(0, 2, slots).astype(np.int32))]
        if case == "run_variant":
            fn = lambda *a: lc.run_variant(*a, n_groups=g, acc=torch.int32,
                                           oh=torch.int8, n_acc=1)
        else:
            fn = lambda *a: lc.run_diag(*a, n_groups=g, mode=case)
    keep = torch.from_numpy((c2g >= 0) & (c2g < g))
    got = fn(_t(c2g), *arrays)
    want = fn(_t(c2g)[keep], *[_chunk_rows(a, n, keep) for a in arrays])
    assert torch.equal(got, want)
    assert case == "empty" or got.sum() != 0


def test_knobs_and_shapes_are_validated(lab):
    with pytest.raises(ValueError, match="oh must be"):
        lc.run_variant(*lab.planes, n_groups=lab.n_groups, acc=torch.int32,
                       oh=torch.float16, n_acc=1)
    with pytest.raises(ValueError, match="n_acc"):
        lc.run_variant(*lab.planes, n_groups=lab.n_groups, acc=torch.int32,
                       oh=torch.int8, n_acc=0)
    with pytest.raises(ValueError, match="mode must be"):
        lc.run_diag(*lab.planes, n_groups=lab.n_groups, mode="full")
    with pytest.raises(TypeError, match="expected torch.int32"):
        lc.run_variant(lab.planes[0], lab.planes[1], lab.planes[2].long(),
                       lab.planes[3], n_groups=lab.n_groups, acc=torch.int32,
                       oh=torch.int8, n_acc=1)
    with pytest.raises(ValueError, match="multiple of 128"):
        lc.run_rep8(lab.planes[0], *lab.rep8, n_groups=lab.n_groups,
                    oh=torch.int8, acc=torch.int32, chunk=100)
    gmeta, packed = lab.packed
    with pytest.raises(ValueError, match="gmeta must be"):
        lc.run_group(gmeta[:-1], packed, n_groups=lab.n_groups,
                     oh=torch.int8, acc=torch.int32)


# ---- the lab's entry point ----

ALL_VARIANTS = ["bf16x2", "int8x4", "bigk-int8", "group-int8", "groupx2",
                "bigkh-int8", "rep8-int8", "rep8-bf16-c256", "empty",
                "onehot-only", "matmul-only", "a-only"]


def test_lab_cli_on_the_cpu_prints_equal_for_every_variant():
    proc = subprocess.run(
        [sys.executable, "-m", "modkit_tpu_torch.tools.kernel_lab",
         "--device", "cpu", "--events", str(N), "--positions", str(P),
         *ALL_VARIANTS],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "LAB_REPS": "1"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("current rep8-int8")
    for name in ALL_VARIANTS:
        line = next(ln for ln in lines if ln.startswith(f"{name} "))
        assert "[equal]" in line, line


@pytest.mark.parametrize("env,ablation", [("LAB_NO_DOT", "no-dot"),
                                          ("LAB_NO_CONSTRUCT", "no-construct")])
def test_lab_ablation_switches(monkeypatch, env, ablation):
    assert port_lab.ablation_from_env() is None
    monkeypatch.setenv(env, "1")
    assert port_lab.ablation_from_env() == ablation
    lines = []
    res = port_lab.run_lab(["rep8-int8"], "cpu", 3000, 1000, 1, ablation,
                           log=lines.append)
    assert res["rep8-int8"]["ok"]
    assert "[equal]" in lines[-1] and ablation in lines[-1]


def test_lab_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_lab.run_lab(["int8x1"], "cuda", 1000, 500, 1)
    from modkit_tpu_torch.tools import call_bench, true_bench
    with pytest.raises(RuntimeError, match="CUDA device"):
        true_bench.hbm_read_gbps()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call_bench.main(["--baseline-csrc", REPO])


# ---- the shapes that stress the CUDA histograms' shared-memory blocks ----

def _stress_lab(shape):
    """``one-position``: every event at one position and strand, so one
    cell takes whole chunks; ``one-group``: positions that fit one group,
    so every chunk belongs to group 0."""
    if shape == "one-position":
        events = port_lab.one_position_events(N, P)
        lab = port_lab.LabInputs.build(events, P, "cpu")
        assert len(np.unique(lab.oracle().nonzero()[0])) == 1
        assert np.count_nonzero(lab.oracle()) == 1
        return lab
    p = 500
    lab = port_lab.LabInputs.build(port_lab.lab_events(N, p), p, "cpu")
    assert lab.n_groups == 1 and lab.n_chunks > 1
    return lab


@pytest.mark.parametrize("fn", ["run_variant", "run_bigk_host", "run_rep8",
                                "count_call", "run_group"])
@pytest.mark.parametrize("shape", ["one-position", "one-group"])
def test_stress_shapes_equal_the_jax_lab(shape, fn):
    lab = _stress_lab(shape)
    g = lab.n_groups
    c2g = lab.planes[0]
    if fn == "run_variant":
        got = lc.run_variant(*lab.planes, n_groups=g, acc=torch.int32,
                             oh=torch.int8, n_acc=1)
        want = _interpret(jlab.run_variant, *[a.numpy() for a in lab.planes],
                          n_groups=g, acc=jnp.int32, oh=jnp.int8, n_acc=1)
    elif fn == "run_bigk_host":
        got = lc.run_bigk_host(c2g, *lab.rows, n_groups=g, oh=torch.int8,
                               acc=torch.int32)
        want = _interpret(jlab.run_bigk_host, lab.c2g,
                          *[a.numpy() for a in lab.rows], n_groups=g,
                          oh=jnp.int8, acc=jnp.int32)
    elif fn == "run_rep8":
        got = lc.run_rep8(c2g, *lab.rep8, n_groups=g, oh=torch.int8,
                          acc=torch.int32)
        want = _interpret(jlab.run_rep8, lab.c2g,
                          *[a.numpy() for a in lab.rep8], n_groups=g,
                          oh=jnp.int8, acc=jnp.int32, chunk=cl.CHUNK)
    elif fn == "count_call":
        got = lc.count_call(c2g, *lab.rep8, n_groups=g)
        want = np.asarray(jpc._count_call(
            lab.c2g, *[a.numpy() for a in lab.rep8], n_groups=g,
            interpret=True))
    else:
        gmeta, packed = lab.packed
        got = lc.run_group(gmeta, packed, n_groups=g, oh=torch.int8,
                           acc=torch.int32)
        want = _interpret(jlab.run_group, gmeta.numpy(), packed.numpy(),
                          n_groups=g, oh=jnp.int8, acc=jnp.int32,
                          max_chunks=int(gmeta[:g].max()))
    _same(got, want, lab.c2g, g)
    assert np.array_equal(got.numpy(), lab.oracle())


def test_block_constants_equal_the_cuda_source():
    """The span and shared-memory figures that chip_smoke.py prints are the
    kernel's own."""
    import re

    with open(os.path.join(REPO, "modkit_tpu_torch", "csrc",
                           "lab_counts.cu")) as fh:
        src = fh.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kGroupSpan"] == lc.GROUP_SPAN
    assert const["kPieceSlots"] == lc.PIECE_SLOTS
    assert const["kThreads"] == lc.MAX_SPAN
    assert "kSmemBytes = kCells * 2;" in src
    assert const["kP2"] * const["kLanes"] * 2 == lc.BLOCK_SMEM_BYTES
    for reader, n in lc.BLOCKS_PER_SM.items():
        body = src[src.index(f"struct {reader.capitalize()}Reader {{"):]
        assert re.search(r"kBlocksPerSm = (\d+);", body).group(1) == str(n)
    # 16-bit counts: a cell gains at most one per slot between flushes
    assert lc.PIECE_SLOTS < 1 << 16
    assert lc.GROUP_SPAN * cl.CHUNK <= lc.PIECE_SLOTS
    assert lc.hist_spans("planes", 2149, 132) == (4, 5)
    assert lc.hist_spans("rows", 10**7, 132) == (lc.MAX_SPAN - 1, lc.MAX_SPAN)
    assert lc.hist_spans("rep8", 7, 132) == (1, 1)


def test_alignment_check_refuses_a_misaligned_base_pointer():
    buf = torch.zeros(4096 + 16, dtype=torch.uint8)
    lc.check_aligned("run_bigk_host", {"p2_rows": buf[16:]})
    with pytest.raises(ValueError, match="p2_rows is not 16-byte aligned"):
        lc.check_aligned("run_bigk_host", {"p2_rows": buf[1:4097]})


@pytest.mark.parametrize("fn", [*lc.DIAG_MODES, *lc.ABLATIONS])
@pytest.mark.parametrize("shape", ["one-position", "one-group"])
def test_diag_stress_shapes_equal_the_jax_lab(monkeypatch, shape, fn):
    """run_diag's modes and run_rep8's ablations where one cell takes whole
    chunks (one position) or every chunk is group 0 (one group), the shapes
    that stress the CUDA diag kernel's 16-bit group block and its spans."""
    lab = _stress_lab(shape)
    g = lab.n_groups
    if fn in lc.DIAG_MODES:
        got = lc.run_diag(*lab.planes, n_groups=g, mode=fn)
        want = _interpret(jlab.run_diag, *[a.numpy() for a in lab.planes],
                          n_groups=g, mode=fn)
    else:
        got = lc.run_rep8(lab.planes[0], *lab.rep8, n_groups=g,
                          oh=torch.int8, acc=torch.int32, ablation=fn)
        monkeypatch.setenv({"no-dot": "LAB_NO_DOT",
                            "no-construct": "LAB_NO_CONSTRUCT"}[fn], "1")
        jax.clear_caches()
        try:
            want = _interpret(jlab.run_rep8, lab.c2g,
                              *[a.numpy() for a in lab.rep8], n_groups=g,
                              oh=jnp.int8, acc=jnp.int32, chunk=cl.CHUNK)
        finally:
            jax.clear_caches()
    _same(got, want, lab.c2g, g)
    assert fn == "empty" or got.sum() > 0


def test_diag_constants_equal_the_cuda_source():
    """diag_kernel's widths, alignment runs and pieces, and its 16-bit
    bound: what one chunk adds to one cell, times the chunks of a piece,
    stays below 2^16 in both of its modes."""
    import re

    with open(os.path.join(REPO, "modkit_tpu_torch", "csrc",
                           "lab_counts.cu")) as fh:
        src = fh.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kDiagPiece"] == lc.DIAG_PIECE_CHUNKS
    assert const["kDiagSmThreads"] == lc.DIAG_SM_THREADS
    for mode, name in (("onehot-only", "kOnehotOnly"), ("a-only", "kAOnly")):
        body = src[src.index(f"struct DiagBody<{name}> {{"):]
        assert re.search(r"kThreads = (\d+);", body).group(1) == str(
            lc.DIAG_THREADS[mode])
        align = re.search(r"kAlign = (\w+);", body).group(1)
        assert const.get(align, align) in (lc.DIAG_ALIGN[mode],
                                           str(lc.DIAG_ALIGN[mode]))
        assert lc.DIAG_SM_THREADS % lc.DIAG_THREADS[mode] == 0
        assert lc.DIAG_ALIGN[mode] <= lc.DIAG_PIECE_CHUNKS
    assert set(lc.DIAG_CELL_GAIN_PER_CHUNK) == set(lc.DIAG_THREADS)
    for mode, gain in lc.DIAG_CELL_GAIN_PER_CHUNK.items():
        assert gain * lc.DIAG_PIECE_CHUNKS < 1 << 16, mode
    assert lc.DIAG_PIECE_CHUNKS * cl.CHUNK == lc.PIECE_SLOTS


@pytest.mark.parametrize("mode", ["onehot-only", "a-only"])
def test_diag_cell_gain_per_chunk_is_the_most_a_chunk_adds(mode):
    """One chunk whose every slot lands on one cell adds exactly the
    gain the CUDA kernel's 16-bit bound assumes."""
    c2g = torch.zeros(1, dtype=torch.int32)
    p2 = torch.full((cl.CHUNK,), 13, dtype=torch.uint8)
    col = torch.full((cl.CHUNK,), 13, dtype=torch.int32)
    got = lc.run_diag(c2g, p2, col, torch.ones_like(col), n_groups=1,
                      mode=mode)
    assert int(got.max()) == lc.DIAG_CELL_GAIN_PER_CHUNK[mode]
