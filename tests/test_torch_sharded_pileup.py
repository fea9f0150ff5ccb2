"""The port's sharded pileup count (``parallel/sharded_pileup.py``) against
modkit_tpu's, exactly.

modkit_tpu's runs on JAX's 8 virtual CPU devices (``tests/conftest.py``);
the port's on a [T, R] grid of CPU devices, where each (tile, reader)
shard takes ``pileup_count_kernel``'s plain call. Inputs are made with
numpy from a seed as in ``tests/test_sharded_pileup.py``, plus a case with
events at rpos -1 and P (JAX's negative index wraps into the last
position's row; P is dropped).
"""

import jax
import numpy as np
import pytest
import torch

from modkit_tpu.parallel import sharded_pileup as ref
from modkit_tpu_torch.parallel import sharded_pileup

MESHES = [(4, 2), (2, 4), (8, 1)]


def _case(t, r, seed, out_of_range):
    rng = np.random.default_rng(seed)
    e, m, p = 64, 2, 32
    rpos = rng.integers(0, p, size=(t, r, e)).astype(np.int32)
    if out_of_range:
        rpos[..., ::7] = -1
        rpos[..., 1::11] = p
    strand = rng.integers(0, 2, size=(t, r, e)).astype(np.int32)
    base_idx = rng.integers(0, 4, size=(t, r, e)).astype(np.int32)
    ev_type = rng.integers(0, 3, size=(t, r, e)).astype(np.int32)
    probs = rng.uniform(-1, 1, size=(t, r, e, m)).astype(np.float32)
    valid = rng.random(size=(t, r, e)) < 0.9
    thr_mod = np.full((m, 4), 0.5, np.float32)
    thr_can = np.full(4, 0.5, np.float32)
    if out_of_range:
        thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.6)
        thr_can = rng.random(4, dtype=np.float32) * np.float32(0.6)
    return (rpos, strand, base_idx, ev_type, probs, valid, thr_mod, thr_can,
            p)


@pytest.mark.parametrize("out_of_range", [False, True],
                         ids=["in-range", "out-of-range"])
@pytest.mark.parametrize("t,r", MESHES)
def test_sharded_pileup_equals_modkit_tpu(t, r, out_of_range):
    assert len(jax.devices()) >= t * r  # conftest: 8 virtual CPU devices
    case = _case(t, r, 7, out_of_range)
    want = ref.run_sharded_pileup(ref.make_mesh(t, r), *case)
    mesh = sharded_pileup.make_mesh(t, r, [torch.device("cpu")] * (t * r))
    got = sharded_pileup.run_sharded_pileup(mesh, *case)
    p, m = case[-1], case[4].shape[-1]
    assert got.dtype == np.int32
    assert got.shape == want.shape == (t, p, 2, 6 + 4 * (m + 1))
    assert np.array_equal(got, want)
    assert got.sum() > 0
    if out_of_range:
        # the last position's row holds the wrapped rpos -1 events
        assert got[:, p - 1].sum() > 0


def test_the_step_sums_the_readers_of_each_tile():
    """Each tile's counts are the sum of its readers' local counts, on the
    tile's first device."""
    t, r = 2, 4
    rpos, strand, base, ev, probs, valid, tm, tc, p = _case(t, r, 3, True)
    mesh = sharded_pileup.make_mesh(t, r, ["cpu"] * 8)
    step = sharded_pileup.make_sharded_pileup_step(mesh, p, probs.shape[-1])
    shards = [[tuple(torch.from_numpy(np.ascontiguousarray(a[i, j]))
                     for a in (rpos, strand, base, ev, probs, valid))
               for j in range(r)] for i in range(t)]
    out = step(shards, torch.from_numpy(tm), torch.from_numpy(tc))
    assert len(out) == t
    for i in range(t):
        parts = [sharded_pileup._local_counts(
            *shards[i][j], torch.from_numpy(tm), torch.from_numpy(tc), p,
            probs.shape[-1]) for j in range(r)]
        assert torch.equal(out[i], sum(parts[1:], parts[0]))
        assert out[i].device == mesh[i][0]


def test_make_mesh_with_too_few_devices_raises():
    with pytest.raises(ValueError, match="needs 8 devices, got 7"):
        sharded_pileup.make_mesh(4, 2, ["cpu"] * 7)
    mesh = sharded_pileup.make_mesh(2, 2, ["cpu"] * 5)
    assert [len(row) for row in mesh] == [2, 2]
    with pytest.raises(ValueError, match="do not match"):
        sharded_pileup.run_sharded_pileup(mesh, *_case(4, 2, 1, False))


def test_make_mesh_takes_the_cards_and_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_pileup.make_mesh(1, 1)
