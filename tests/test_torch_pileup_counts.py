"""``pileup_count_kernel`` and ``run_pileup_counts`` of the port
(``ops/counts.py``) against modkit_tpu's (``ops/pileup_counts.py``, jitted
by XLA on JAX's CPU backend), exactly.

Inputs are made with numpy from a seed: all three event types (modcall,
nocall, delete), invalid events, absent and zero probabilities, a base
outside 0..3, and, in the ``out-of-range`` shape, events at rpos -1, P and
past the padded positions. ``run_pileup_counts`` pads the codes to
``round_up_codes(M)`` and the positions to a bucket, so its output is
[P, 2, K(m_pad)]; ``pileup_count_kernel`` counts what JAX's
``.at[flat].add`` counts: a negative flat index wraps once, anything
still outside the output is dropped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modkit_tpu.ops import pileup_counts as ref
from modkit_tpu_torch.ops import counts

CODES = [1, 2, 3, 9]


def _case(n, m, p, seed, shape="random"):
    rng = np.random.default_rng(seed)
    rpos = rng.integers(0, p, n).astype(np.int32)
    if shape == "out-of-range":
        rpos[::7] = -1
        rpos[1::11] = p
        rpos[2::13] = p + 40_000  # past the padded positions too
        rpos[3::17] = -2 * p
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.int32)
    base[4::29] = 4  # N: the first threshold column, a counter past ACGT
    ev_type = rng.integers(0, 3, n).astype(np.int32)
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0
    probs[rng.random((n, m)) < 0.05] = 0.0
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.5)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
    valid = rng.random(n) < 0.9
    return rpos, strand, base, ev_type, probs, thr_mod, thr_can, valid


@pytest.mark.parametrize("m", CODES)
@pytest.mark.parametrize("shape,n", [("random", 4000), ("out-of-range", 4000),
                                     ("empty", 0)])
def test_run_pileup_counts_equals_modkit_tpu(m, shape, n):
    p = 1001 + 7 * m
    rpos, strand, base, ev, probs, tm, tc, _ = _case(n, m, p, n + m, shape)
    want = ref.run_pileup_counts(rpos, strand, base, ev, probs, tm, tc, p)
    got = counts.run_pileup_counts(rpos, strand, base, ev, probs, tm, tc, p,
                                   device="cpu")
    m_pad = counts.round_up_codes(m)
    assert got.dtype == np.int32
    assert got.shape == want.shape == (p, 2, 6 + 4 * (m_pad + 1))
    assert np.array_equal(got, want)
    if n:
        assert 0 < got.sum() <= n
        assert got[:, :, 0].sum() and got[:, :, 2:6].sum()  # delete, nocall


@pytest.mark.parametrize("m", CODES)
def test_pileup_count_kernel_equals_modkit_tpu(m):
    """The unpadded kernel with invalid events and out-of-range indices."""
    p, n = 997, 5000
    case = _case(n, m, p, 3 * m, "out-of-range")
    kw = dict(num_positions=p, num_codes=m)
    want = np.asarray(ref.pileup_count_kernel(
        *(jnp.asarray(a) for a in case[:4]), jnp.asarray(case[4]),
        jnp.asarray(case[7]), jnp.asarray(case[5]), jnp.asarray(case[6]),
        **kw))
    t = [torch.from_numpy(a) for a in case]
    got = counts.pileup_count_kernel(*t[:5], t[7], t[5], t[6], **kw)
    assert got.dtype == torch.int32 and got.shape == (p, 2, 6 + 4 * (m + 1))
    assert np.array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < int(case[7].sum())


def test_out_of_range_events_land_where_jax_puts_them():
    """A delete at rpos -1, strand 1, wraps to the last position's row; one
    at rpos P or at -2P - 1 is dropped; an invalid event counts nowhere."""
    p, m = 10, 1
    k = 6 + 4 * (m + 1)
    rpos = np.array([-1, p, -2 * p - 1, 3, 4], np.int32)
    strand = np.array([1, 0, 0, 0, 0], np.int32)
    zeros = np.zeros(5, np.int32)
    ev = np.full(5, 2, np.int32)  # deletes: counter 0
    probs = np.full((5, m), -1.0, np.float32)
    valid = np.array([True, True, True, True, False])
    tm, tc = np.zeros((m, 4), np.float32), np.zeros(4, np.float32)
    got = counts.pileup_count_kernel(
        *(torch.from_numpy(a) for a in (rpos, strand, zeros, ev, probs,
                                        valid, tm, tc)),
        num_positions=p, num_codes=m).numpy()
    want = np.zeros((p, 2, k), np.int32)
    want[p - 1, 1, 0] = 1  # flat -K + P * 2 * K: position P - 1, strand 1
    want[3, 0, 0] = 1
    assert np.array_equal(got, want)
    jax_got = np.asarray(ref.pileup_count_kernel(
        *(jnp.asarray(a) for a in (rpos, strand, zeros, ev, probs, valid,
                                   tm, tc)),
        num_positions=p, num_codes=m))
    assert np.array_equal(jax_got, want)


def test_run_pileup_counts_needs_a_card_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = _case(10, 2, 50, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        counts.run_pileup_counts(*case[:7], 50)
