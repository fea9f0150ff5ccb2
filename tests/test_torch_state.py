"""modkit_tpu_torch's threshold-state call (ops/state.py) against modkit_tpu.

Every comparison is exact (``np.array_equal``): the port's plain PyTorch
version on the CPU, the Pallas kernel ``threshold_state_pallas`` in
interpret mode, the XLA functions of ``ops/pileup_counts.py`` and a numpy
oracle agree bit for bit on the same inputs, made with numpy from a seed.
The CUDA kernel is held against the plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from modkit_tpu.ops.pallas_state import LANES, threshold_state_pallas
from modkit_tpu.ops.pileup_counts import (
    threshold_state_f32 as xla_state_f32,
    threshold_state_from_quals,
)
from modkit_tpu_torch.ops import state


def random_case(rng, n, m):
    quals = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    present = rng.integers(0, 1 << m, size=n).astype(np.uint8)
    zero = (rng.integers(0, 1 << m, size=n) & present).astype(np.uint8)
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    thr_mod = rng.random((m, 4), dtype=np.float32)
    thr_can = rng.random(4, dtype=np.float32)
    return quals, present, zero, base, thr_mod, thr_can


def probs_of(quals, present, zero):
    """f32 probabilities of the compact encoding (−1 = absent)."""
    m = quals.shape[1]
    j = np.arange(m, dtype=np.uint8)
    pres = ((present[:, None] >> j) & 1).astype(bool)
    zer = ((zero[:, None] >> j) & 1).astype(bool)
    p = (quals.astype(np.float32) + np.float32(0.5)) / np.float32(256.0)
    return np.where(pres, np.where(zer, np.float32(0), p), np.float32(-1))


def oracle_states(probs, base, thr_mod, thr_can):
    m = probs.shape[1]
    present_m = probs >= 0
    pass_mod = present_m & (probs >= thr_mod.T[base])
    canon_p = np.float32(1.0)
    prob_sum = np.zeros(len(probs), dtype=np.float32)
    for j in range(m):  # class order, one class at a time
        prob_sum = prob_sum + np.where(present_m[:, j], probs[:, j], 0)
    canon_p = canon_p - prob_sum
    pass_can = canon_p >= thr_can[base]
    mod_p = np.where(pass_mod, probs, -np.inf)
    rev_arg = (m - 1) - np.argmax(mod_p[:, ::-1], axis=1)
    best_p = np.take_along_axis(mod_p, rev_arg[:, None], axis=1)[:, 0]
    any_mod = pass_mod.any(axis=1)
    choose_can = pass_can & ((~any_mod) | (canon_p >= best_p))
    return np.where(choose_can, 1, np.where(any_mod, 2 + rev_arg, 0)).astype(
        np.uint8
    )


def port_quals_t(quals, present, zero, base, thr_mod, thr_can):
    m = quals.shape[1]
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
    return state.threshold_state_quals_t(
        torch.from_numpy(np.ascontiguousarray(quals.T)),
        torch.from_numpy(present), torch.from_numpy(zero),
        torch.from_numpy(base), tm, tc,
    ).numpy()


def port_f32(probs, base, thr_mod, thr_can):
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, probs.shape[1])
    return state.threshold_state_f32(
        torch.from_numpy(probs), torch.from_numpy(base), tm, tc
    ).numpy()


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_quals_t_matches_pallas_xla_and_oracle(m):
    rng = np.random.default_rng(100 + m)
    n = 64 * LANES
    quals, present, zero, base, thr_mod, thr_can = random_case(rng, n, m)
    want = oracle_states(probs_of(quals, present, zero), base, thr_mod, thr_can)
    got = port_quals_t(quals, present, zero, base, thr_mod, thr_can)
    pallas = np.asarray(
        threshold_state_pallas(
            np.ascontiguousarray(quals.T), present, zero, base,
            thr_mod, thr_can, interpret=True,
        )
    )
    xla = np.asarray(
        threshold_state_from_quals(quals, present, zero, base, thr_mod, thr_can)
    )
    assert np.array_equal(pallas, want)
    assert np.array_equal(xla, want)
    assert np.array_equal(got, want)
    assert len(np.unique(got)) > 2  # filtered, canonical and mod states occur


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_f32_matches_xla_and_oracle(m):
    rng = np.random.default_rng(200 + m)
    n = 5000
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0  # absent classes
    probs[rng.random((n, m)) < 0.1] = 0.0
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.5)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.5)
    want = oracle_states(probs, base, thr_mod, thr_can)
    xla = np.asarray(xla_state_f32(probs, base, thr_mod, thr_can))
    got = port_f32(probs, base, thr_mod, thr_can)
    assert np.array_equal(xla, want)
    assert np.array_equal(got, want)


def arbitrary_f32_case(rng, n, m):
    """Arbitrary f32 rows, not the 1/256 grid of ``probs_of``: absent (−1),
    0 and 1.0 values, values equal to their mod threshold, rows whose sum
    exceeds 1, and canonical thresholds equal to some row's 1 − sum."""
    probs = rng.random((n, m), dtype=np.float32) * np.float32(1.5 / m)
    probs[rng.random((n, m)) < 0.15] = -1.0
    probs[rng.random((n, m)) < 0.05] = 0.0
    probs[rng.random((n, m)) < 0.02] = 1.0
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.6)
    at_thr = rng.random((n, m)) < 0.1
    probs = np.where(at_thr, thr_mod.T[base], probs).astype(np.float32)
    # rows whose sum exceeds 1: every class present and at least 0.6
    over = rng.random(n) < 0.05
    probs[over] = np.float32(0.6) + rng.random((int(over.sum()), m),
                                               dtype=np.float32)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.6)
    prob_sum = np.zeros(n, dtype=np.float32)
    for j in range(m):  # class order, as the call sums
        prob_sum = prob_sum + np.where(probs[:, j] >= 0, probs[:, j],
                                       np.float32(0))
    canon = np.float32(1.0) - prob_sum
    for b in range(4):
        rows = np.flatnonzero((base == b) & (canon > 0))
        if len(rows):
            thr_can[b] = canon[rows[0]]
    return probs, base, thr_mod, thr_can


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_f32_plain_on_arbitrary_rows_matches_xla_and_oracle(m):
    """The f32 entry's plain version (what every CUDA body of the f32 entry
    is held to) equals the XLA function and the oracle on arbitrary f32
    rows, ties at the thresholds included."""
    rng = np.random.default_rng(500 + m)
    n = 6001
    probs, base, thr_mod, thr_can = arbitrary_f32_case(rng, n, m)
    assert (probs.sum(axis=1) > 1).any() and (probs == -1).any()
    assert (probs == 1.0).any() and (probs == 0.0).any()
    assert (probs == thr_mod.T[base]).any()
    want = oracle_states(probs, base, thr_mod, thr_can)
    xla = np.asarray(xla_state_f32(probs, base, thr_mod, thr_can))
    got = port_f32(probs, base, thr_mod, thr_can)
    assert np.array_equal(xla, want)
    assert np.array_equal(got, want)
    assert {0, 1}.issubset(set(np.unique(got))) and got.max() >= 2


@pytest.mark.parametrize("m", [2, 4])
def test_f32_of_compact_encoding_equals_quals_t(m):
    """The f32 entry over the decoded probabilities gives the states of the
    compact u8 entry, as the engine relies on when it switches paths."""
    rng = np.random.default_rng(300 + m)
    quals, present, zero, base, thr_mod, thr_can = random_case(rng, 4000, m)
    probs = probs_of(quals, present, zero)
    assert np.array_equal(
        port_f32(probs, base, thr_mod, thr_can),
        port_quals_t(quals, present, zero, base, thr_mod, thr_can),
    )


def test_ties_prefer_last_class_then_canonical():
    # the cases of tests/test_pallas_state.py: two classes tie, the later
    # wins; an equal-or-better canonical wins over both
    m = 2
    present = np.array([0b11], dtype=np.uint8)
    zero = np.array([0], dtype=np.uint8)
    base = np.array([1], dtype=np.uint8)
    thr_mod = np.zeros((m, 4), dtype=np.float32)
    n_pad = LANES * 32

    def pad(a):
        out = np.zeros(n_pad, dtype=a.dtype)
        out[: len(a)] = a
        return out

    for q, thr_can, want in (
        (127, np.ones(4, dtype=np.float32), 2 + 1),  # later mod class
        (0, np.zeros(4, dtype=np.float32), 1),  # canonical 0.996 wins
    ):
        quals = np.full((1, m), q, dtype=np.uint8)
        pallas = np.asarray(
            threshold_state_pallas(
                np.ascontiguousarray(np.tile(pad(quals[:, 0]), (m, 1))),
                pad(present), pad(zero), pad(base), thr_mod, thr_can,
                interpret=True,
            )
        )
        got = port_quals_t(quals, present, zero, base, thr_mod, thr_can)
        assert pallas[0] == want
        assert got[0] == want


@pytest.mark.parametrize("n", [1, 127, 3 * LANES + 3])
def test_ragged_event_count(n):
    """N need not be a multiple of 128 in the port; only the Pallas side is
    padded to its lane tiling."""
    rng = np.random.default_rng(n)
    m = 2
    quals, present, zero, base, thr_mod, thr_can = random_case(rng, n, m)
    n_pad = -(-n // LANES) * LANES
    pad = lambda a: np.pad(a, [(0, n_pad - n)] + [(0, 0)] * (a.ndim - 1))
    pallas = np.asarray(
        threshold_state_pallas(
            np.ascontiguousarray(pad(quals).T), pad(present), pad(zero),
            pad(base), thr_mod, thr_can, interpret=True,
        )
    )[:n]
    got = port_quals_t(quals, present, zero, base, thr_mod, thr_can)
    assert got.shape == (n,)
    assert np.array_equal(got, pallas)


def test_thresholds_to_tensors_pads_like_the_engine():
    thr_mod = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.6, 0.7, 0.8]], np.float32)
    thr_can = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, 4)
    want = np.pad(thr_mod, ((0, 2), (0, 0))).astype(np.float32)
    assert tm.dtype == torch.float32 and tc.dtype == torch.float32
    assert np.array_equal(tm.numpy(), want)
    assert np.array_equal(tc.numpy(), thr_can)
    with pytest.raises(ValueError):
        state.thresholds_to_tensors(thr_mod, thr_can, 1)


def test_non_cpu_tensor_launches_or_raises():
    """A tensor that is not on the CPU never takes the plain version: a
    device with no kernel raises."""
    q = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    z = torch.zeros(4, dtype=torch.uint8, device="meta")
    tm, tc = state.thresholds_to_tensors(np.zeros((2, 4)), np.zeros(4), 2)
    with pytest.raises(ValueError, match="not CUDA"):
        state.threshold_state_quals_t(q, z, z, z, tm, tc)
    with pytest.raises(ValueError, match="not CUDA"):
        state.threshold_state_f32(
            torch.zeros((4, 2), device="meta"), z, tm, tc
        )


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n", [15, 16, 17, 4111, 33 * LANES])
def test_quals_t_any_event_count_matches_xla_pallas_and_oracle(n, m):
    """Event counts around the CUDA quals entry's groups of QUALS_GROUP
    events (a ragged tail, planes 1.. not 4-byte aligned where N % 4 != 0):
    the port equals the XLA function and the oracle, and the Pallas kernel
    where N is a multiple of its 128 lanes."""
    rng = np.random.default_rng(400 + n + m)
    quals, present, zero, base, thr_mod, thr_can = random_case(rng, n, m)
    want = oracle_states(probs_of(quals, present, zero), base, thr_mod, thr_can)
    got = port_quals_t(quals, present, zero, base, thr_mod, thr_can)
    xla = np.asarray(
        threshold_state_from_quals(quals, present, zero, base, thr_mod, thr_can)
    )
    assert np.array_equal(xla, want)
    assert np.array_equal(got, want)
    if n % LANES == 0:
        pallas = np.asarray(
            threshold_state_pallas(
                np.ascontiguousarray(quals.T), present, zero, base,
                thr_mod, thr_can, interpret=True,
            )
        )
        assert np.array_equal(pallas, want)


def _csrc(name):
    import os

    with open(os.path.join(os.path.dirname(state.__file__), os.pardir,
                           "csrc", name)) as fh:
        return fh.read()


def test_quals_constants_equal_the_cuda_source():
    import re

    src = _csrc("state.cu")
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kGroup"] == state.QUALS_GROUP == 4  # one 4-byte load
    assert const["kQualsThreads"] == state.QUALS_THREADS
    # the grouped kernel runs for M <= 4, one thread per event above
    assert "if constexpr (M > 4)" in src
    assert state.QUALS_GROUPED_CLASSES == tuple(
        m for m in state.QUALS_CLASSES if m <= 4)
    # the f32 rows kernel: F32_GROUP events a thread at M = 1 (4-byte base
    # loads), one above, its rows in 16-byte loads
    assert const["kF32Group"] == state.F32_GROUP == 4
    assert const["kF32Threads"] == state.F32_THREADS
    assert "constexpr int G = M == 1 ? kF32Group : 1;" in src
    assert state.F32_ALIGN == 16 and "float4" in src
    for m in state.F32_CLASSES:
        assert f"case {m}: return launch_f32<{m}>(" in src
        assert f"case {m}: return launch_quals<{m}>(" in src


@pytest.mark.parametrize("entry", ["mk_state_quals_t", "mk_state_f32"])
def test_state_entries_take_the_argument_lists_the_wrapper_declares(entry):
    """Each C entry of csrc/state.cu has as many parameters as
    ops/kernels.py declares for it."""
    from modkit_tpu_torch.ops import kernels

    src = _csrc("state.cu")
    head = src[src.index(f'extern "C" int {entry}('):]
    params = head[head.index("(") + 1:head.index(")")]
    assert len(params.split(",")) == len(kernels._SIGNATURES["state"][entry])
