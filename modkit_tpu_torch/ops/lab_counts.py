"""The count-kernel lab's kernels (``csrc/lab_counts.cu``) and their plain
versions.

One wrapper per TPU function, each with its plain PyTorch version:

=================  ===================================================  ===============
wrapper            replaces                                             plain version
=================  ===================================================  ===============
``run_variant``    ``tools/kernel_lab.py:81`` (``make_kernel`` ``:42``)  ``hist_plain``
``run_diag``       ``tools/kernel_lab.py:160`` (``:104``)               ``diag_plain``
``run_bigk``       ``tools/kernel_lab.py:211`` (``:183``)               ``hist_plain``
``run_group``      ``tools/kernel_lab.py:296`` (``:239``)               ``group_plain``
``run_bigk_host``  ``tools/kernel_lab.py:344`` (``:318``)               ``hist_plain``
``run_rep8``       ``tools/kernel_lab.py:412`` (``:364``)               ``rep8_plain``,
                                                                        ``ablation_plain``
``count_call``     ``modkit_tpu/ops/pallas_counts.py:113``              ``rep8_plain``
=================  ===================================================  ===============

Each counts the events of a chunked, grouped layout (``count_layout.py``)
into int32 [n_groups, 128, 128]: chunk ``c`` belongs to group ``c2g[c]``
(``run_group`` takes each group's chunk range from ``gmeta`` instead), and
an event adds one at ``[p2, col]``. A value outside [0, 128) counts
nowhere (col 255 marks an invalid slot). ``run_diag`` and the ablations
of ``run_rep8`` compute the TPU lab's fixed diagnostic functions (see
``diag_plain`` and ``ablation_plain``). Groups that no chunk visits were
left unwritten on the TPU; here they are zero.

The TPU kernels contracted one-hot matrices on the MXU; their one-hot
dtype ``oh``, accumulator dtype ``acc`` and accumulator count ``n_acc`` are
exact in every combination (a chunk counts at most 2048 < 2^24), so they
change no count. The wrappers keep and validate them, and they select
nothing. A chunk whose group lies outside [0, n_groups), and a
``run_group`` chunk range past the chunks, count nowhere, in the kernels and
in the plain versions alike. The TPU kernels also needed ``c2g``
non-decreasing (they zero a group's block where ``c2g`` changes). The
CUDA histograms and two diagnostics count a span of chunks into a group's
block in shared memory and flush it into the zeroed output with atomics
wherever ``c2g`` changes, which is exact in any order, as
``torch.bincount`` is (``onehot-only`` stores a group's block instead
where the kernel finds ``c2g`` non-decreasing and the block the group's
only writer); so the wrappers do not read ``c2g`` back to check it: the
lab's planner (``count_layout.check_c2g``) checks its plans once, on the
host.

Each wrapper runs the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; anything else raises. The
histograms and ``run_diag`` load 16 bytes at a time, so on the card their
wrappers refuse an input whose base pointer is not 16-byte aligned.
``LAUNCHES`` counts the kernel launches of each wrapper, ``DIAG_LAUNCHES``
those of each diag mode and rep8 ablation.
"""

from __future__ import annotations

import threading

import torch

from .count_layout import CHUNK, CR, LANES, P2, REP
from .kernels import check_aligned

CELLS = P2 * LANES
ONEHOT_DTYPES = (torch.bfloat16, torch.int8)
ACC_DTYPES = (torch.float32, torch.int32)
DIAG_MODES = ("empty", "onehot-only", "matmul-only", "a-only")
ABLATIONS = ("no-dot", "no-construct")
# mk_lab_hist layouts and mk_lab_diag modes of csrc/lab_counts.cu
_LAYOUT = {"planes": 0, "rows": 1, "rep8": 2}
_DIAG_MODE = {"empty": 0, "onehot-only": 1, "matmul-only": 2, "a-only": 3,
              "no-dot": 4, "no-construct": 5}
# csrc/lab_counts.cu's block layout: the histogram blocks of each reader
# that fit an SM (kBlocksPerSm; the grid is one wave of them), a block's
# 16-bit shared histogram (kSmemBytes), the slots it counts between flushes
# at most (kPieceSlots) and run_group's sub-range of chunks (kGroupSpan)
BLOCKS_PER_SM = {"planes": 4, "rows": 5, "rep8": 3}
BLOCK_SMEM_BYTES = CELLS * 2
PIECE_SLOTS = 32768
GROUP_SPAN = 2
MAX_SPAN = 256
# diag_kernel's (the onehot-only and a-only bodies): threads per block
# (kThreads; an SM holds DIAG_SM_THREADS of them), the longest run of
# equal c2g kept in one block (kAlign), the chunks it counts between
# flushes at most (kDiagPiece) and the most one chunk adds to one cell
# (the 16-bit bound of csrc/lab_counts.cu)
DIAG_THREADS = {"onehot-only": 512, "a-only": 256}
DIAG_SM_THREADS = 1024
DIAG_ALIGN = {"onehot-only": 16, "a-only": 0}
DIAG_PIECE_CHUNKS = 16
DIAG_CELL_GAIN_PER_CHUNK = {"onehot-only": 2 * CR, "a-only": CR * LANES}


def hist_spans(reader: str, n_chunks: int, sms: int) -> tuple[int, int]:
    """(fewest, most) chunks of a histogram block (``launch_hist``): the
    chunks shared out evenly over one wave of blocks on ``sms`` SMs, or
    over more blocks where a span would pass MAX_SPAN chunks."""
    blocks = min(max(BLOCKS_PER_SM[reader] * sms, -(-n_chunks // MAX_SPAN)),
                 n_chunks)
    return n_chunks // blocks, -(-n_chunks // blocks)


# kernel launches of each wrapper in this process, and of run_diag and
# run_rep8 by diag mode and ablation (each of which has its own body)
LAUNCHES = dict.fromkeys(
    ("run_variant", "run_diag", "run_bigk", "run_group", "run_bigk_host",
     "run_rep8", "count_call"), 0)
DIAG_LAUNCHES = dict.fromkeys(_DIAG_MODE, 0)
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for counts in (LAUNCHES, DIAG_LAUNCHES):
            for k in counts:
                counts[k] = 0


# ---- checks ----

def _check_knobs(what, oh, acc, n_acc=1):
    if oh not in ONEHOT_DTYPES:
        raise ValueError(f"{what}: oh must be one of {ONEHOT_DTYPES}, got {oh}")
    if acc not in ACC_DTYPES:
        raise ValueError(f"{what}: acc must be one of {ACC_DTYPES}, got {acc}")
    if not isinstance(n_acc, int) or n_acc < 1:
        raise ValueError(f"{what}: n_acc must be an int >= 1, got {n_acc!r}")


def _check_tensors(what: str, named: dict) -> torch.device:
    """Device, dtype and contiguity of the inputs; returns their device."""
    dev = None
    for name, (t, dtype) in named.items():
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{what}: inputs span {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _check_numel(what, name, t, want):
    if t.numel() != want:
        raise ValueError(f"{what}: {name} holds {t.numel()} values, "
                         f"expected {want}")


def _check_c2g(what, c2g, n_chunks):
    if c2g.dim() != 1 or c2g.numel() != n_chunks or n_chunks == 0:
        raise ValueError(f"{what}: c2g must be int32 [n_chunks > 0], got "
                         f"{tuple(c2g.shape)}")


# ---- plain PyTorch versions ----

def _bincount(keys, keep, n_groups, scale=1):
    out = torch.bincount(keys[keep], minlength=n_groups * CELLS)
    return (out * scale).to(torch.int32).reshape(n_groups, P2, LANES)


def _in_range(x, hi=LANES):
    return (x >= 0) & (x < hi)


def hist_plain(c2g, p2, col, valid, n_groups: int, chunk: int = CHUNK):
    """The grouped histogram (``tools/kernel_lab.py:42-75``, ``:183-207``,
    ``:318-340``): flat keys ``g * 16384 + p2 * 128 + col`` of the slots
    with ``valid != 0`` (every slot where ``valid`` is None) and p2, col in
    [0, 128), counted with ``torch.bincount``."""
    g = c2g.to(torch.int64).repeat_interleave(chunk)
    i = p2.reshape(-1).to(torch.int64)
    j = col.reshape(-1).to(torch.int64)
    keep = _in_range(i) & _in_range(j) & _in_range(g, n_groups)
    if valid is not None:
        keep &= valid.reshape(-1) != 0
    return _bincount(g * CELLS + i * LANES + j, keep, n_groups)


def rep8_plain(c2g, p2r, colr, n_groups: int, chunk: int = CHUNK):
    """The rep8 histogram (``tools/kernel_lab.py:364-408``,
    ``pallas_counts.py:78-107``) for any rows: ``out[c2g[c], i, j] +=
    sum_k [p2r[c*8 + i%8, k] == i] * [colr[c*8 + j%8, k] == j]``. A value
    v of replica row a counts as row v only when v % 8 == a; with
    identical rows this is the histogram of ``hist_plain``."""
    n = c2g.numel()
    r = p2r.reshape(n, REP, chunk).to(torch.int64)
    s = colr.reshape(n, REP, chunk).to(torch.int64)
    a = torch.arange(REP, device=r.device).view(1, REP, 1)
    ok_i = _in_range(r) & (r % REP == a)
    ok_j = _in_range(s) & (s % REP == a)
    g = c2g.to(torch.int64).view(n, 1)
    ok_g = _in_range(g, n_groups)
    g = g * CELLS
    out = torch.zeros(n_groups * CELLS, dtype=torch.int64, device=r.device)
    for ai in range(REP):
        for bj in range(REP):
            keep = ok_i[:, ai] & ok_j[:, bj] & ok_g
            keys = g + r[:, ai] * LANES + s[:, bj]
            out += torch.bincount(keys[keep], minlength=n_groups * CELLS)
    return out.to(torch.int32).reshape(n_groups, P2, LANES)


def group_plain(gmeta, packed, n_groups: int):
    """``run_group``'s histogram (``tools/kernel_lab.py:239-290``): group g
    counts chunks ``start_g .. start_g + cnt_g - 1`` of ``packed`` (per
    chunk CR rows of p2, then CR rows of col, 255 = invalid); a chunk index
    outside the chunks counts nowhere."""
    dev = packed.device
    blocks = packed.reshape(-1, 2, CHUNK)
    cnt = gmeta[:n_groups].to(torch.int64).clamp(min=0)
    start = gmeta[n_groups:].to(torch.int64)
    grp = torch.repeat_interleave(torch.arange(n_groups, device=dev), cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    chunk_idx = start[grp] + torch.arange(grp.numel(), device=dev) - first
    ok = _in_range(chunk_idx, blocks.shape[0])
    blk = blocks[chunk_idx[ok]].to(torch.int64)
    i, j = blk[:, 0], blk[:, 1]
    keys = grp[ok].view(-1, 1) * CELLS + i * LANES + j
    return _bincount(keys, _in_range(i) & _in_range(j), n_groups)


def diag_plain(c2g, p2, col, valid, n_groups: int, mode: str):
    """``run_diag`` (``tools/kernel_lab.py:104-156``). With ``A_r[i, l] =
    [p2[r, l] == i]`` and ``B_r[j, l] = [col[r, l] == j and valid[r, l]]``
    over the CR rows r of a chunk, each chunk of group g adds to out[g]:
    ``empty`` 0; ``onehot-only`` sum_r (A_r + B_r), indexed [i, l];
    ``matmul-only`` CR * A_0 B_0^T; ``a-only`` sum_r A_r B_0^T."""
    n = c2g.numel()
    dev = p2.device
    if mode == "empty":
        return torch.zeros((n_groups, P2, LANES), dtype=torch.int32,
                           device=dev)
    i = p2.reshape(n, CR, LANES).to(torch.int64)
    j = col.reshape(n, CR, LANES).to(torch.int64)
    g = c2g.to(torch.int64).view(n, 1, 1)
    v = (valid.reshape(n, CR, LANES) != 0) & _in_range(g, n_groups)
    i = torch.where(_in_range(g, n_groups), i, -1)  # a chunk of no group
    g = g * CELLS
    lane = torch.arange(LANES, device=dev).view(1, 1, LANES)
    if mode == "onehot-only":
        keys = torch.cat([(g + i * LANES + lane).reshape(-1),
                          (g + j * LANES + lane).reshape(-1)])
        keep = torch.cat([_in_range(i).reshape(-1),
                          (v & _in_range(j)).reshape(-1)])
        return _bincount(keys, keep, n_groups)
    if mode == "matmul-only":
        i0, j0, v0 = i[:, :1], j[:, :1], v[:, :1]
        return _bincount(g + i0 * LANES + j0,
                         v0 & _in_range(i0) & _in_range(j0), n_groups,
                         scale=CR)
    if mode == "a-only":
        j0 = j[:, :1].expand(n, CR, LANES)
        keep = v[:, :1] & _in_range(j0) & _in_range(i)
        return _bincount(g + i * LANES + j0, keep, n_groups)
    raise ValueError(f"run_diag: mode must be one of {DIAG_MODES}, got {mode!r}")


def ablation_plain(c2g, p2r, colr, n_groups: int, chunk: int, ablation: str):
    """``run_rep8`` under ``LAB_NO_DOT`` / ``LAB_NO_CONSTRUCT``
    (``tools/kernel_lab.py:387-400``). ``no-dot``: out[g][i, l] +=
    [p2r[c*8 + i%8, l] == i] + [colr[c*8 + i%8, l] == i] over the first 128
    slots l of each chunk. ``no-construct``: out[g][0, 0] += chunk *
    p2r[c*8, 0]."""
    n = c2g.numel()
    r = p2r.reshape(n, REP, chunk).to(torch.int64)
    g = c2g.to(torch.int64)
    ok_g = _in_range(g, n_groups)
    if ablation == "no-construct":
        out = torch.zeros(n_groups * CELLS, dtype=torch.int64, device=r.device)
        out.index_add_(0, g[ok_g] * CELLS, chunk * r[ok_g, 0, 0])
        return out.to(torch.int32).reshape(n_groups, P2, LANES)
    if ablation != "no-dot":
        raise ValueError(
            f"run_rep8: ablation must be one of {ABLATIONS}, got {ablation!r}")
    s = colr.reshape(n, REP, chunk).to(torch.int64)
    a = torch.arange(REP, device=r.device).view(1, REP, 1)
    lane = torch.arange(LANES, device=r.device).view(1, 1, LANES)
    keys, keep = [], []
    for x in (r[:, :, :LANES], s[:, :, :LANES]):
        keys.append((g.view(n, 1, 1) * CELLS + x * LANES + lane).reshape(-1))
        keep.append((_in_range(x) & (x % REP == a)
                     & ok_g.view(n, 1, 1)).reshape(-1))
    return _bincount(torch.cat(keys), torch.cat(keep), n_groups)


# ---- wrappers ----

def _launch(what: str, entry: str, *args, n_groups: int, dev,
            diag: str | None = None, out=None) -> torch.Tensor:
    """The output (``out`` or a new tensor), zeroed unless the body writes
    every cell itself (``run_diag``'s ``empty``), one launch of ``entry``
    and its count (and that of diag mode or ablation ``diag``)."""
    from .kernels import check_aligned, check_launch, kernel_lib

    shape = (n_groups, P2, LANES)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    elif (out.dtype != torch.int32 or tuple(out.shape) != shape
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(
            f"{what}: out must be a contiguous int32 {shape} tensor on {dev}, "
            f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if diag == "empty":
        check_aligned(what, {"out": out})
    else:
        out.zero_()
    lib = kernel_lib("lab_counts")
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *args, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, rc, what)
    with _lock:
        LAUNCHES[what] += 1
        if diag is not None:
            DIAG_LAUNCHES[diag] += 1
    return out


def _planes(what, c2g, p2, col, valid):
    dev = _check_tensors(what, {
        "c2g": (c2g, torch.int32), "p2": (p2, torch.uint8),
        "col": (col, torch.int32), "valid": (valid, torch.int32)})
    n_chunks = c2g.numel()
    for name, t in (("p2", p2), ("col", col), ("valid", valid)):
        _check_numel(what, name, t, n_chunks * CHUNK)
    _check_c2g(what, c2g, n_chunks)
    return dev


def _planes_hist(what, c2g, p2, col, valid, n_groups):
    dev = _planes(what, c2g, p2, col, valid)
    if dev.type == "cpu":
        return hist_plain(c2g, p2, col, valid, n_groups)
    check_aligned(what, {"p2": p2, "col": col, "valid": valid})
    return _launch(what, "mk_lab_hist", _LAYOUT["planes"], c2g.data_ptr(),
                   p2.data_ptr(), col.data_ptr(), valid.data_ptr(),
                   c2g.numel(), CHUNK, n_groups, n_groups=n_groups, dev=dev)


def run_variant(c2g, p2, col, valid, *, n_groups: int, acc, oh, n_acc: int):
    """``tools/kernel_lab.py`` ``run_variant``: the grouped histogram of the
    planes ``p2`` u8, ``col`` int32, ``valid`` int32 (n_chunks * 2048 slots
    each; any shape) with ``c2g`` int32 [n_chunks]."""
    _check_knobs("run_variant", oh, acc, n_acc)
    return _planes_hist("run_variant", c2g, p2, col, valid, n_groups)


def run_bigk(c2g, p2, col, valid, *, n_groups: int, oh, acc):
    """``tools/kernel_lab.py`` ``run_bigk``: the same histogram as
    ``run_variant`` (one K = 2048 contraction per chunk on the TPU)."""
    _check_knobs("run_bigk", oh, acc)
    return _planes_hist("run_bigk", c2g, p2, col, valid, n_groups)


def run_diag(c2g, p2, col, valid, *, n_groups: int, mode: str, out=None):
    """``tools/kernel_lab.py`` ``run_diag``: see ``diag_plain``. With
    ``out`` (a contiguous int32 [n_groups, 128, 128] tensor on the inputs'
    device) the result is written there and ``out`` returned; ``empty``'s
    body writes every cell itself, the other modes' add into ``out``
    zeroed first."""
    if mode not in DIAG_MODES:
        raise ValueError(
            f"run_diag: mode must be one of {DIAG_MODES}, got {mode!r}")
    dev = _planes("run_diag", c2g, p2, col, valid)
    if dev.type == "cpu":
        got = diag_plain(c2g, p2, col, valid, n_groups, mode)
        return got if out is None else out.copy_(got)
    check_aligned("run_diag", {"p2": p2, "col": col, "valid": valid})
    return _launch("run_diag", "mk_lab_diag", _DIAG_MODE[mode],
                   c2g.data_ptr(), p2.data_ptr(), col.data_ptr(),
                   valid.data_ptr(), c2g.numel(), CHUNK, n_groups,
                   n_groups=n_groups, dev=dev, diag=mode, out=out)


def run_bigk_host(c2g, p2_rows, col_rows, *, n_groups: int, oh, acc):
    """``tools/kernel_lab.py`` ``run_bigk_host``: the histogram of u8 rows
    ``p2_rows``, ``col_rows`` [n_chunks, 2048] (col 255 = invalid)."""
    what = "run_bigk_host"
    _check_knobs(what, oh, acc)
    dev = _check_tensors(what, {
        "c2g": (c2g, torch.int32), "p2_rows": (p2_rows, torch.uint8),
        "col_rows": (col_rows, torch.uint8)})
    n_chunks = c2g.numel()
    for name, t in (("p2_rows", p2_rows), ("col_rows", col_rows)):
        _check_numel(what, name, t, n_chunks * CHUNK)
    _check_c2g(what, c2g, n_chunks)
    if dev.type == "cpu":
        return hist_plain(c2g, p2_rows, col_rows, None, n_groups)
    check_aligned(what, {"p2_rows": p2_rows, "col_rows": col_rows})
    return _launch(what, "mk_lab_hist", _LAYOUT["rows"], c2g.data_ptr(),
                   p2_rows.data_ptr(), col_rows.data_ptr(), None, n_chunks,
                   CHUNK, n_groups, n_groups=n_groups, dev=dev)


def _rep8(what, c2g, p2r, colr, n_groups, chunk, ablation=None):
    dev = _check_tensors(what, {
        "c2g": (c2g, torch.int32), "p2r": (p2r, torch.uint8),
        "colr": (colr, torch.uint8)})
    if chunk < LANES or chunk % LANES:
        raise ValueError(f"{what}: chunk must be a multiple of {LANES}, "
                         f"got {chunk}")
    n_chunks = c2g.numel()
    for name, t in (("p2r", p2r), ("colr", colr)):
        _check_numel(what, name, t, n_chunks * REP * chunk)
    _check_c2g(what, c2g, n_chunks)
    if dev.type == "cpu":
        if ablation is None:
            return rep8_plain(c2g, p2r, colr, n_groups, chunk)
        return ablation_plain(c2g, p2r, colr, n_groups, chunk, ablation)
    args = (c2g.data_ptr(), p2r.data_ptr(), colr.data_ptr(), None, n_chunks,
            chunk, n_groups)
    if ablation is None:
        check_aligned(what, {"p2r": p2r, "colr": colr})
        return _launch(what, "mk_lab_hist", _LAYOUT["rep8"], *args,
                       n_groups=n_groups, dev=dev)
    return _launch(what, "mk_lab_diag", _DIAG_MODE[ablation], *args,
                   n_groups=n_groups, dev=dev, diag=ablation)


def run_rep8(c2g, p2r, colr, *, n_groups: int, oh, acc, chunk: int = CHUNK,
             ablation: str | None = None):
    """``tools/kernel_lab.py`` ``run_rep8``: the rep8 histogram of u8 rows
    ``p2r``, ``colr`` [n_chunks * 8, chunk] (see ``rep8_plain``), or with
    ``ablation`` (the lab's ``LAB_NO_DOT``/``LAB_NO_CONSTRUCT``) one of the
    functions of ``ablation_plain``."""
    _check_knobs("run_rep8", oh, acc)
    if ablation is not None and ablation not in ABLATIONS:
        raise ValueError(
            f"run_rep8: ablation must be one of {ABLATIONS}, got {ablation!r}")
    return _rep8("run_rep8", c2g, p2r, colr, n_groups, chunk, ablation)


def count_call(c2g, p2r8, colr8, *, n_groups: int):
    """``pallas_counts.py`` ``_count_call``: the rep8 histogram at chunk
    2048 (int8 one-hots, int32 accumulation on the TPU)."""
    return _rep8("count_call", c2g, p2r8, colr8, n_groups, CHUNK)


def run_group(gmeta, packed, *, n_groups: int, oh, acc, n_acc: int = 1):
    """``tools/kernel_lab.py`` ``run_group``: ``out[g]`` is the histogram of
    chunks ``gmeta[n_groups + g] ...`` (``gmeta[g]`` of them) of ``packed``
    u8 [n_chunks * 32, 128] (``count_layout.pack_events_u8``); every group
    is written, an empty one as zeros."""
    what = "run_group"
    _check_knobs(what, oh, acc, n_acc)
    dev = _check_tensors(what, {
        "gmeta": (gmeta, torch.int32), "packed": (packed, torch.uint8)})
    if packed.numel() == 0 or packed.numel() % (2 * CHUNK):
        raise ValueError(f"{what}: packed must hold whole chunks of "
                         f"{2 * CHUNK} bytes")
    n_chunks = packed.numel() // (2 * CHUNK)
    if gmeta.shape != (2 * n_groups,):
        raise ValueError(f"{what}: gmeta must be int32 [2 * n_groups], got "
                         f"{tuple(gmeta.shape)}")
    if dev.type == "cpu":
        return group_plain(gmeta, packed, n_groups)
    check_aligned(what, {"packed": packed})
    return _launch(what, "mk_lab_group", gmeta.data_ptr(), packed.data_ptr(),
                   n_groups, n_chunks, n_groups=n_groups, dev=dev)
