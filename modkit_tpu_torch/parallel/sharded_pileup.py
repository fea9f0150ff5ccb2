"""Sharded pileup counting over a grid of devices.

The port of modkit_tpu/parallel/sharded_pileup.py. Grid axes, as the JAX
mesh's:
  ``tiles``   — data parallelism over genome tiles (the reference's rayon
                fan-out over MultiChromCoordinates, pileup/mod.rs:684).
  ``readers`` — reads of one tile split across devices; partial count
                tensors are summed over this axis (the reference's Moniod
                reduce, monoid.rs:5).

One process drives every device of the grid, as JAX's single-controller
``shard_map`` does: each (tile, reader) device runs the fused threshold
call + count (``ops/counts.pileup_count_kernel``: kernel A's f32 entry on
a CUDA device, then the count) on its local event shard, and the readers'
partials of a tile are summed on the tile's first device, in reader order
(JAX's ``psum`` over ``readers``), exactly, in int32. No process group is
involved: the grid is a ``[T, R]`` list of ``torch.device``s, which may
name one device more than once (``cuda:0`` listed eight times runs every
shard on the one card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.counts import pileup_count_kernel


def make_mesh(n_tiles: int, n_readers: int, devices=None) -> list:
    """A ``[n_tiles][n_readers]`` grid of the first ``n_tiles * n_readers``
    of ``devices`` (every local card, ``compute_devices("cuda")``, when
    None: without a card it raises). Fewer devices than cells is an error,
    as JAX's reshape of its device array is."""
    if devices is None:
        from .devices import compute_devices

        devices = compute_devices("cuda")
    devices = [torch.device(d) for d in devices]
    need = n_tiles * n_readers
    if n_tiles < 1 or n_readers < 1 or len(devices) < need:
        raise ValueError(
            f"a {n_tiles} x {n_readers} mesh needs {need} devices, got "
            f"{len(devices)}"
        )
    return [devices[t * n_readers:(t + 1) * n_readers]
            for t in range(n_tiles)]


def _local_counts(rpos, strand, base_idx, ev_type, probs, valid,
                  thr_mod, thr_can, num_positions: int, num_codes: int):
    """One device's int32 [num_positions, 2, K] counts of its shard."""
    return pileup_count_kernel(
        rpos, strand, base_idx, ev_type, probs, valid, thr_mod, thr_can,
        num_positions=num_positions, num_codes=num_codes,
    )


def make_sharded_pileup_step(mesh: list, num_positions: int,
                             num_codes: int):
    """The sharded step over ``mesh``.

    ``step(shards, thr_mod, thr_can)`` takes ``shards[t][r]``, the tuple
    (rpos, strand, base_idx, ev_type, probs, valid) of tile t's reader r,
    on ``mesh[t][r]``, and the thresholds as CPU f32 tensors (kernel A
    takes them by value; JAX replicates them). It returns tile t's complete
    counts [num_positions, 2, K] for each t, on ``mesh[t][0]``: the [T, P,
    2, K] of JAX's step, whose copy on every reader of a tile holds the
    same values as this one per tile.
    """

    def step(shards, thr_mod, thr_can):
        out = []
        for t, devs in enumerate(mesh):
            merged = None
            for r, dev in enumerate(devs):
                local = _local_counts(*shards[t][r], thr_mod, thr_can,
                                      num_positions, num_codes)
                # merge the readers' partials of this tile (the psum)
                merged = local if merged is None else merged + local.to(
                    devs[0])
            out.append(merged)
        return out

    return step


def run_sharded_pileup(
    mesh: list,
    rpos: np.ndarray,  # [T, R, E]
    strand: np.ndarray,
    base_idx: np.ndarray,
    ev_type: np.ndarray,
    probs: np.ndarray,  # [T, R, E, M]
    valid: np.ndarray,
    thr_mod: np.ndarray,
    thr_can: np.ndarray,
    num_positions: int,
) -> np.ndarray:
    """Convenience wrapper: place each shard on its device, run one step,
    return numpy counts [T, num_positions, 2, K]."""
    t_dim, r_dim = len(mesh), len(mesh[0])
    if rpos.shape[:2] != (t_dim, r_dim):
        raise ValueError(
            f"events of shape {rpos.shape[:2]} do not match a {t_dim} x "
            f"{r_dim} mesh"
        )
    m = probs.shape[-1]
    step = make_sharded_pileup_step(mesh, num_positions, m)
    shards = [
        [
            tuple(
                torch.from_numpy(
                    np.ascontiguousarray(a[t, r], dtype=d)
                ).to(mesh[t][r])
                for a, d in (
                    (rpos, np.int32), (strand, np.int32),
                    (base_idx, np.int32), (ev_type, np.int32),
                    (probs, np.float32), (valid, bool),
                )
            )
            for r in range(r_dim)
        ]
        for t in range(t_dim)
    ]
    out = step(
        shards,
        torch.from_numpy(np.ascontiguousarray(thr_mod, dtype=np.float32)),
        torch.from_numpy(np.ascontiguousarray(thr_can, dtype=np.float32)),
    )
    return np.stack([c.cpu().numpy() for c in out])
