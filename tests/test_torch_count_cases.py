"""Kernel B's count (ops/counts.py) at its edge cases, against modkit_tpu.

The CUDA kernel (``csrc/counts.cu``) writes every cell of its output and
drops an event whose flat index ``(rpos * 2 + strand) * Km + counter``
falls outside the output. Here the port's count on the CPU (its plain
version, ``modcall_counts``) is held, exactly, to the Pallas kernel
``modcall_counts_pallas`` in interpret mode and to the numpy oracle
``modcall_counts_numpy``, on inputs made with numpy from a seed and on the
events the port's engine emits, read by read; and the wrappers' ``out`` is
checked. The references take no event outside the output, so where a case
has some (rpos -1 or P) every count gets the events the kernel keeps;
the port's count is also called on every event of such a case, unfiltered,
and must drop the others itself. The kernel itself is held to the plain
version on the card in test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from modkit_tpu.ops import pileup_counts as jax_counts
from modkit_tpu.ops.pallas_counts import modcall_counts_pallas
from modkit_tpu_torch.ops import counts
from modkit_tpu_torch.ops.state import thresholds_to_tensors

CODES = [1, 2, 3, 4, 8, 9]
FILL = 0x7F7F7F7F
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(n, m, p, seed, shape="random"):
    rng = np.random.default_rng(seed)
    rpos = rng.integers(0, p, n).astype(np.int32)
    if shape == "one-position":
        rpos[:] = p // 3
    if shape == "out-of-range":
        rpos[::5] = -1
        rpos[1::7] = p
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.int32)
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0  # absent classes
    probs[rng.random((n, m)) < 0.1] = 0.0
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.5)
    thr_can = np.full(4, 0.5, dtype=np.float32)
    return rpos, strand, base, probs, thr_mod, thr_can


def _tensors(rpos, strand, base, probs, thr_mod, thr_can):
    tm, tc = thresholds_to_tensors(thr_mod, thr_can, probs.shape[1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(rpos), t(strand), t(base), t(probs), tm, tc


def _kept(case, p):
    """The events whose flat index lies in the output."""
    rpos, strand, base, probs, thr_mod, thr_can = case
    km = 1 + 4 * (probs.shape[1] + 1)
    flat = counts.flat_indices(*_tensors(*case)).numpy()
    keep = (flat >= 0) & (flat < p * 2 * km)
    return (rpos[keep], strand[keep], base[keep], probs[keep], thr_mod,
            thr_can)


def _references(kept, p):
    """{name: counts} of the JAX package's Pallas kernel (interpret mode)
    and numpy oracle over the kept events."""
    rpos, strand, base, probs, thr_mod, thr_can = kept
    return {
        "pallas": np.asarray(modcall_counts_pallas(*kept, p, interpret=True)),
        "numpy": jax_counts.modcall_counts_numpy(
            rpos.astype(np.int64), strand.astype(np.int64),
            base.astype(np.int64), probs, thr_mod, thr_can, p,
            probs.shape[1]),
    }


def _port_counts(kept, p):
    """The port's count of the kept events, into an output first filled
    with 0x7f7f7f7f."""
    t = _tensors(*kept)
    km = 1 + 4 * (kept[3].shape[1] + 1)
    out = torch.full((p, 2, km), FILL, dtype=torch.int32)
    got = counts.modcall_counts(*t, p, out=out)
    assert got is out
    return got.numpy()


# ---- the count against modkit_tpu ----

@pytest.mark.parametrize("m", CODES)
@pytest.mark.parametrize("shape,n", [("random", 3000), ("one-position", 3000),
                                     ("out-of-range", 3000), ("empty", 0),
                                     ("one", 1)])
def test_counts_equal_modkit_tpu(m, shape, n):
    """P odd; every event at one position; events at rpos -1 and P, which
    the kernel drops; no event; one event."""
    p = 1001 + 3 * m
    case = _case(n, m, p, seed=n + 10 * m, shape=shape)
    kept = _kept(case, p)
    got = _port_counts(kept, p)
    km = 1 + 4 * (m + 1)
    assert got.dtype == np.int32 and got.shape == (p, 2, km)
    for want in _references(kept, p).values():
        assert np.array_equal(got, want)
    assert got.sum() == len(kept[0])
    if shape == "out-of-range":
        assert 0 < len(kept[0]) < n
    if shape == "one-position":
        assert np.count_nonzero(got.sum(axis=(1, 2))) == 1


def test_counts_keep_what_the_plain_count_keeps():
    """A strand outside {0, 1} and a base outside 0..3 move an event's flat
    index: the kernel counts it where ``torch.bincount`` of the flat index
    does, and nowhere when that index leaves the output."""
    m, p, n = 2, 700, 4000
    rpos, strand, base, probs, thr_mod, thr_can = _case(n, m, p, seed=5)
    strand[::9] = 2
    strand[1::13] = -1
    base[2::11] = 5
    base[3::17] = -1
    rpos[4::19] = p - 1
    t = _tensors(rpos, strand, base, probs, thr_mod, thr_can)
    flat = counts.flat_indices(*t)
    km = 1 + 4 * (m + 1)
    keep = (flat >= 0) & (flat < p * 2 * km)
    assert 0 < int(keep.sum()) < n
    want = torch.bincount(flat[keep], minlength=p * 2 * km).to(torch.int32)
    got = counts.modcall_counts(*[a[keep] for a in t[:4]], *t[4:], p)
    assert torch.equal(got.reshape(-1), want)


@pytest.mark.parametrize("m", CODES)
def test_counts_drop_out_of_range_events_unfiltered(m):
    """``modcall_counts`` on the CPU called with every event of the
    ``out-of-range`` case, unfiltered, plus events at rpos -1 and rpos P at
    each strand: it keeps only the events whose flat index lies in the
    output, as the kernel does, and equals a numpy ``bincount`` of those
    indices."""
    p, n = 1001 + 3 * m, 3000
    rpos, strand, base, probs, thr_mod, thr_can = _case(
        n, m, p, seed=n + 10 * m, shape="out-of-range")
    rpos[-4:] = (-1, -1, p, p)
    strand[-4:] = (0, 1, 0, 1)
    t = _tensors(rpos, strand, base, probs, thr_mod, thr_can)
    km = 1 + 4 * (m + 1)
    flat = counts.flat_indices(*t).numpy()
    keep = (flat >= 0) & (flat < p * 2 * km)
    assert 0 < keep.sum() < n and not keep[-4:].any()
    want = np.bincount(flat[keep], minlength=p * 2 * km).astype(np.int32)
    out = torch.full((p, 2, km), FILL, dtype=torch.int32)
    for got in (counts.modcall_counts(*t, p),
                counts.modcall_counts(*t, p, out=out)):
        assert got.dtype == torch.int32 and got.shape == (p, 2, km)
        assert np.array_equal(got.numpy().reshape(-1), want)
    assert np.array_equal(
        counts.modcall_counts_plain(*t, p).numpy().reshape(-1), want)


@pytest.mark.parametrize("reference", ["pallas", "numpy"])
def test_counts_of_read_ordered_engine_events(engine_events, reference):
    """The events the port's engine hands the count, read by read in query
    order (not sorted by position)."""
    rpos, strand, base, probs, tm, tc, p = engine_events
    assert (np.diff(rpos) < 0).sum() > 10  # read order, not position order
    case = (rpos, strand, base, probs, tm, tc)
    got = _port_counts(case, p)
    assert np.array_equal(got, _references(case, p)[reference])
    assert got.sum() == len(rpos)


@pytest.fixture(scope="module")
def engine_events(tmp_path_factory):
    """The first tile's arguments to ``modcall_counts`` in a port pileup on
    the CPU with the native decoder off (the Python event route)."""
    from modkit_tpu_torch.pileup import engine as port_engine
    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam

    work = tmp_path_factory.mktemp("count_cases")
    bam = str(work / "reads.bam")
    make_synthetic_modbam(bam, n_reads=60, read_len=1500, coverage=20.0,
                          seed=4)
    seen = []
    fn = port_engine.modcall_counts

    def spy(rpos, strand, base, probs, tm, tc, p, **kw):
        seen.append((rpos.numpy().copy(), strand.numpy().copy(),
                     base.numpy().copy(), probs.numpy().copy(),
                     tm.numpy()[:probs.shape[1]].copy(), tc.numpy().copy(),
                     p))
        return fn(rpos, strand, base, probs, tm, tc, p, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_engine, "modcall_counts", spy)
    mp.setenv("MODKIT_TPU_DISABLE_NATIVE", "1")
    try:
        run_pileup(PileupConfig(in_bam=bam, out=str(work / "out.bed"),
                                no_filtering=True, suppress_progress=True,
                                device="cpu"))
    finally:
        mp.undo()
    assert seen
    return max(seen, key=lambda s: len(s[0]))


# ---- the wrappers' ``out`` on the CPU ----

def test_modcall_counts_writes_into_out():
    m, p = 2, 500
    t = _tensors(*_case(2000, m, p, seed=9))
    out = torch.full((p, 2, 1 + 4 * (m + 1)), FILL, dtype=torch.int32)
    got = counts.modcall_counts(*t, p, out=out)
    assert got is out
    assert torch.equal(out, counts.modcall_counts_plain(*t, p))


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_modcall_counts_refuses_a_wrong_out(bad):
    m, p = 2, 500
    t = _tensors(*_case(200, m, p, seed=9))
    shape = (p, 2, 1 + 4 * (m + 1))
    out = {"shape": torch.zeros((p - 1,) + shape[1:], dtype=torch.int32),
           "dtype": torch.zeros(shape, dtype=torch.int64),
           "strided": torch.zeros(shape[::-1], dtype=torch.int32).permute(
               2, 1, 0)}[bad]
    with pytest.raises(ValueError, match="out must be"):
        counts.modcall_counts(*t, p, out=out)


def test_run_diag_empty_writes_into_out():
    from modkit_tpu_torch.ops import lab_counts

    n, g = 3, 2
    c2g = torch.tensor([0, 1, 1], dtype=torch.int32)
    p2 = torch.zeros(n * 2048, dtype=torch.uint8)
    col = torch.zeros(n * 2048, dtype=torch.int32)
    out = torch.full((g, 128, 128), FILL, dtype=torch.int32)
    got = lab_counts.run_diag(c2g, p2, col, col, n_groups=g, mode="empty",
                              out=out)
    assert got is out and int(out.abs().max()) == 0


# ---- the C entry and the bench's contract check ----

def test_count_entry_takes_the_argument_list_the_wrapper_declares():
    """csrc/counts.cu's mk_modcall_counts has as many parameters as
    ops/kernels.py declares for it."""
    from modkit_tpu_torch.ops import kernels

    with open(os.path.join(REPO, "modkit_tpu_torch", "csrc",
                           "counts.cu")) as fh:
        src = fh.read()
    head = src[src.index('extern "C" int mk_modcall_counts('):]
    params = head[head.index("(") + 1:head.index(")")]
    assert len(params.split(",")) == len(
        kernels._SIGNATURES["counts"]["mk_modcall_counts"])


def test_call_bench_tells_the_two_contracts_apart(tmp_path):
    """``call_bench`` runs a source tree whose kernel B and ``empty`` need
    a zeroed output through its adapter, and this tree's directly."""
    from modkit_tpu_torch.tools import call_bench

    assert call_bench.writes_every_cell(
        os.path.join(REPO, "modkit_tpu_torch", "csrc"))
    (tmp_path / "counts.cu").write_text(
        "// counts must hold num_positions * 2 * (1 + 4(m+1)) zeroed int32\n")
    assert not call_bench.writes_every_cell(str(tmp_path))
