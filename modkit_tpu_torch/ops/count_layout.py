"""The host data planner of the count-kernel lab (``tools/kernel_lab.py``).

The port's own copy of the event layout that the TPU's grouped one-hot
count kernels read:

- the constants and ``_plan`` of ``modkit_tpu/ops/pallas_counts.py:49-75``;
- ``prepare_events`` (``pallas_counts.py:146-207``): sort the events by
  position, bucket them into groups of ``W`` windows x ``WIN_POS``
  positions and pad each group to whole chunks;
- ``pack_events_u8`` (``tools/kernel_lab.py:429-444``): the u8 layout of
  ``run_group`` (per chunk ``CR`` rows of p2, then ``CR`` rows of col with
  255 = invalid) and its per-group (count, start) metadata;
- ``rep8`` (``tools/kernel_lab.py:476-482``, ``pallas_counts.py:264-272``):
  a compact plane expanded to ``REP`` identical rows per chunk.

Host numpy, as in the original. ``prepare_events`` takes the chunk size as
an argument where the lab patched the module's ``CHUNK``
(``kernel_lab.py:526-534``); its ``bucket_chunks`` option, which bounded
jit specialisations of the TPU grid, is left out: nothing here compiles
per shape. ``tests/test_torch_lab.py`` holds each function equal to its
original, array for array. ``check_c2g`` is the port's own: the plan
invariant the TPU kernels relied on, checked on the host.
"""

from __future__ import annotations

import numpy as np

LANES = 128
CHUNK = 2048  # events per chunk
CR = CHUNK // LANES  # rows of a chunk in the [rows, LANES] plane layout
REP = 8  # replicated rows of a chunk in the rep8 layout
WIN_POS = 64  # positions per window
P2 = WIN_POS * 2  # (position-in-window, strand) rows of a group's block


def _plan(num_codes: int) -> tuple[int, int, int]:
    """(KC counter lanes per window, W windows per group, group positions).

    KC must hold Km = 1 + 4*(M+1) counters; W*KC = 128 output lanes.
    """
    km = 1 + 4 * (num_codes + 1)
    if km <= 16:
        kc = 16
    elif km <= 32:
        kc = 32
    elif km <= 64:
        kc = 64
    else:
        raise ValueError(f"too many mod codes for the pallas counter: {num_codes}")
    w = LANES // kc
    return kc, w, w * WIN_POS


def prepare_events(
    rpos: np.ndarray,
    strand: np.ndarray,
    base_idx: np.ndarray,
    probs: np.ndarray,
    num_positions: int,
    num_codes: int,
    chunk: int = CHUNK,
):
    """Sort the events by position and plan groups padded to whole chunks.

    Returns (plan dict, c2g, p2, colb, valid, base_s, probs_s, visited):
    ``c2g`` int32 [n_chunks] is each chunk's group (non-decreasing); the
    u8 planes ``p2`` (position in window * 2 + strand), ``colb`` (window *
    KC, the counter is added later) and ``valid`` hold n_chunks * chunk
    slots, padded slots with valid = 0; ``visited`` marks groups with at
    least one chunk.
    """
    kc, w, group_pos = _plan(num_codes)
    n = len(rpos)
    order = np.argsort(rpos, kind="stable")
    rs = rpos[order]
    groups = rs // group_pos
    n_groups = max(1, -(-num_positions // group_pos))
    gcount = np.bincount(groups, minlength=n_groups).astype(np.int64)
    gchunks = np.maximum((gcount + chunk - 1) // chunk, 0)
    n_chunks = int(gchunks.sum())
    if n_chunks == 0:
        n_chunks = 1
        gchunks[0] = 1
    total = n_chunks * chunk
    # destination offsets: group g's events start at a chunk-aligned offset
    dst_group_start = np.zeros(n_groups, dtype=np.int64)
    dst_group_start[1:] = np.cumsum(gchunks * chunk)[:-1]
    src_group_start = np.zeros(n_groups, dtype=np.int64)
    src_group_start[1:] = np.cumsum(gcount)[:-1]
    idx = np.arange(n, dtype=np.int64)
    dst = dst_group_start[groups] + (idx - src_group_start[groups])

    p2 = np.zeros(total, dtype=np.uint8)
    colb = np.zeros(total, dtype=np.uint8)
    valid = np.zeros(total, dtype=np.uint8)
    base_s = np.zeros(total, dtype=np.int32)
    probs_s = np.full((total, probs.shape[1]), -1.0, dtype=np.float32)
    p2[dst] = ((rs % WIN_POS) * 2 + strand[order]).astype(np.uint8)
    colb[dst] = (((rs % group_pos) // WIN_POS) * kc).astype(np.uint8)
    valid[dst] = 1
    base_s[dst] = base_idx[order]
    probs_s[dst] = probs[order]
    c2g = np.repeat(np.arange(n_groups, dtype=np.int32), gchunks).astype(np.int32)
    visited = (gchunks > 0).astype(np.int32)
    plan = dict(kc=kc, w=w, group_pos=group_pos, n_groups=n_groups)
    return plan, c2g, p2, colb, valid, base_s, probs_s, visited


def check_c2g(c2g, n_groups: int) -> None:
    """Raise unless the host plan ``c2g`` is non-decreasing with every group
    in [0, n_groups): what the TPU kernels required of it (they zero a
    group's block where ``c2g`` changes). The port's kernels count in any
    order, so this is checked once where a plan is made, not per launch."""
    c2g = np.asarray(c2g)
    if c2g.size and (c2g.min() < 0 or c2g.max() >= n_groups):
        raise ValueError(f"c2g has groups outside [0, {n_groups})")
    if np.any(c2g[1:] < c2g[:-1]):
        raise ValueError("c2g must be non-decreasing")


def pack_events_u8(c2g, p2, col, valid, n_groups):
    """[n_chunks*2*CR, LANES] u8: per chunk, CR rows of p2 then CR rows of
    col (255 = invalid); plus per-group (count, start) scalar metadata
    ``gmeta`` int32 [2 * n_groups] (counts, then starts) and the largest
    count."""
    n_chunks = len(c2g)
    p2r = p2.reshape(n_chunks, CR, LANES)
    colr = col.reshape(n_chunks, CR, LANES)
    vr = valid.reshape(n_chunks, CR, LANES)
    colu = np.where(vr != 0, colr, 255).astype(np.uint8)
    packed = np.concatenate([p2r.astype(np.uint8), colu], axis=1).reshape(
        n_chunks * 2 * CR, LANES
    )
    gcnt = np.bincount(c2g, minlength=n_groups).astype(np.int32)
    gstart = np.zeros(n_groups, dtype=np.int32)
    gstart[1:] = np.cumsum(gcnt)[:-1]
    gmeta = np.concatenate([gcnt, gstart]).astype(np.int32)
    return gmeta, packed, int(gcnt.max())


def rep8(plane, n_chunks: int, chunk: int = CHUNK, valid=None):
    """u8 [n_chunks * REP, chunk]: each chunk's slots of the compact
    ``plane`` as REP identical rows; where ``valid`` is given, its zero
    slots read 255 (invalid: matches no output row or lane)."""
    pr = np.asarray(plane).reshape(n_chunks, chunk)
    if valid is not None:
        pr = np.where(np.asarray(valid).reshape(n_chunks, chunk) != 0, pr, 255)
    return np.repeat(
        pr.reshape(n_chunks, 1, chunk).astype(np.uint8), REP, axis=1
    ).reshape(n_chunks * REP, chunk)
