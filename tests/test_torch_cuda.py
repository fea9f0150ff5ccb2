"""modkit_tpu_torch's CUDA kernels against their plain PyTorch versions.

Kernel A (state: the quals entry for M in {1, 2, 4, 8}, the f32 entry for
any M up to ``MAX_CLASSES``, on arbitrary f32 rows and ragged counts, and
its alignment rules) and kernel B
(counts, any M; every cell written, out-of-range events dropped), with a
9-code and a collapsed (``--ignore h``) pileup on the card against the
host route; a CRAM pileup on the card
(kernel B on every tile) against the CPU run, and ``run_pileup_counts``,
``pileup_count_kernel`` and the sharded count on the card against the CPU
(each launch of kernel A's f32 entry counted); a pileup over ``cuda:0``
listed 1 and 4 times, and a two-process shard run on the one card; and the
count-kernel lab's kernels (``ops/lab_counts.py``) against their plain
versions and the oracle.

The tests marked ``cuda`` need an NVIDIA GPU (a CUDA kernel has no CPU
mode) and skip without one; on a machine with a card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda

Every comparison is exact (``torch.equal``). This file imports neither
``jax`` nor ``modkit_tpu``, so it also runs where neither is installed.
"""

import numpy as np
import pytest
import torch

from modkit_tpu_torch.ops import counts, state
from modkit_tpu_torch.pileup.engine import _to_host_async, _upload


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state_case(n, m, seed):
    rng = np.random.default_rng(seed)
    quals_t = rng.integers(0, 256, size=(m, n)).astype(np.uint8)
    present = rng.integers(0, 1 << m, size=n).astype(np.uint8)
    zero = (rng.integers(0, 1 << m, size=n) & present).astype(np.uint8)
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.8)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
    return quals_t, present, zero, base, thr_mod, thr_can


def test_upload_packs_arrays_in_order():
    arrays = [
        np.arange(10, dtype=np.float32).reshape(5, 2),
        np.arange(7, dtype=np.uint8),
        np.arange(3, dtype=np.int32),
    ]
    got = _upload(arrays, torch.device("cpu"))
    for a, t in zip(arrays, got):
        assert np.array_equal(t.numpy(), a)
    host, ev = _to_host_async(got[0])
    assert ev is None and host is got[0]


@pytest.mark.cuda
def test_upload_and_copy_back_on_cuda(cuda_device):
    arrays = [
        np.arange(10, dtype=np.float32).reshape(5, 2),
        np.arange(7, dtype=np.uint8),
        np.arange(3, dtype=np.int32),
    ]
    got = _upload(arrays, cuda_device)
    for a, t in zip(arrays, got):
        assert t.device.type == "cuda" and t.is_contiguous()
        host, ev = _to_host_async(t)
        ev.synchronize()
        assert host.is_pinned()
        assert np.array_equal(host.numpy(), a)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 127, 4111, 200_003])
def test_state_kernel_equals_plain(cuda_device, m, n):
    quals_t, present, zero, base, thr_mod, thr_can = _state_case(n, m, n + m)
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (quals_t, present, zero, base)]
    before = state.STATE_KERNEL_LAUNCHES
    got = state.threshold_state_quals_t(*args, tm, tc)
    assert state.STATE_KERNEL_LAUNCHES == before + 1
    want = state.threshold_state_quals_t_plain(*args, tm, tc)
    assert torch.equal(got, want)
    # the f32 entry over the decoded probabilities gives the same states
    j = torch.arange(m, device=cuda_device, dtype=torch.int32)
    pres = ((args[1].int()[:, None] >> j) & 1) == 1
    zer = ((args[2].int()[:, None] >> j) & 1) == 1
    p = (args[0].T.float() + 0.5) * 0.00390625
    probs = torch.where(pres, torch.where(zer, 0.0, p), -1.0).contiguous()
    got_f32 = state.threshold_state_f32(probs, args[3], tm, tc)
    assert torch.equal(got_f32, want)
    assert torch.equal(
        state.threshold_state_f32_plain(probs, args[3], tm, tc), want
    )


@pytest.mark.cuda
def test_state_kernel_misaligned_base_pointer_raises(cuda_device):
    """The quals entry loads 4 bytes at a time: it refuses an input whose
    base pointer is not 4-byte aligned, and takes the same bytes at an
    aligned address."""
    m, n = 2, 4111
    quals_t, present, zero, base, thr_mod, thr_can = _state_case(n, m, 5)
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (quals_t, present, zero, base)]
    want = state.threshold_state_quals_t_plain(*args, tm, tc)
    buf = torch.zeros(m * n + 16, dtype=torch.uint8, device=cuda_device)
    for name, i in (("quals_t", 0), ("present", 1), ("base", 3)):
        odd = list(args)
        view = buf[1:1 + args[i].numel()].view(args[i].shape)
        view.copy_(args[i])
        odd[i] = view
        with pytest.raises(ValueError, match=f"{name} is not 4-byte aligned"):
            state.threshold_state_quals_t(*odd, tm, tc)
    assert torch.equal(state.threshold_state_quals_t(*args, tm, tc), want)


@pytest.mark.cuda
def test_state_kernel_rejects_unsupported_classes(cuda_device):
    q = torch.zeros((3, 16), dtype=torch.uint8, device=cuda_device)
    z = torch.zeros(16, dtype=torch.uint8, device=cuda_device)
    tm, tc = state.thresholds_to_tensors(np.zeros((3, 4)), np.zeros(4), 3)
    with pytest.raises(ValueError, match="M in"):
        state.threshold_state_quals_t(q, z, z, z, tm, tc)


# ---- kernel A's f32 rows bodies and its M = 8 quals body ----

F32_EVENT_COUNTS = (*range(1, 34), 4111, 200_003, 615_136)


def _arbitrary_rows(rng, n, m):
    """f32 rows off the 1/256 grid: absent (−1), 0 and 1.0 values, values
    equal to their threshold, rows whose sum exceeds 1; u8 bases 0..4 (4
    takes the first threshold column, as the call's select chain does)."""
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.6)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.6)
    base = rng.integers(0, 5, n).astype(np.uint8)
    probs = rng.random((n, m), dtype=np.float32) * np.float32(1.5 / m)
    probs[rng.random((n, m)) < 0.15] = -1.0
    probs[rng.random((n, m)) < 0.05] = 0.0
    probs[rng.random((n, m)) < 0.02] = 1.0
    col = np.where((base >= 1) & (base <= 3), base, 0)
    probs = np.where(rng.random((n, m)) < 0.1, thr_mod.T[col], probs)
    return np.ascontiguousarray(probs, dtype=np.float32), base, thr_mod, thr_can


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_state_f32_rows_equal_plain_on_arbitrary_rows(cuda_device, m):
    """The f32 entry's rows kernel (4 events a thread at M = 1, one with
    16-byte row loads above) at every N % 4 and N % 16 up to 33 and at
    4111, 200 003 and the bench tile's 615 136, one launch each."""
    rng = np.random.default_rng(600 + m)
    for n in F32_EVENT_COUNTS:
        probs, base, thr_mod, thr_can = _arbitrary_rows(rng, n, m)
        tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
        p, b = (torch.from_numpy(a).to(cuda_device) for a in (probs, base))
        before = state.STATE_F32_KERNEL_LAUNCHES
        got = state.threshold_state_f32(p, b, tm, tc)
        assert state.STATE_F32_KERNEL_LAUNCHES == before + 1
        assert torch.equal(got, state.threshold_state_f32_plain(p, b, tm,
                                                                tc)), n


@pytest.mark.cuda
@pytest.mark.parametrize("n0", [4096, 615_136 - 16])
def test_state_quals_m8_at_every_ragged_tail(cuda_device, n0):
    """The M = 8 quals body at N % 16 = 0..15: every plane but the first
    begins at every offset of a 16-byte line, and the last group is
    partial at every N % 4."""
    m = 8
    for n in range(n0, n0 + 16):
        quals_t, present, zero, base, thr_mod, thr_can = _state_case(n, m, n)
        tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (quals_t, present, zero, base)]
        before = state.STATE_KERNEL_LAUNCHES
        got = state.threshold_state_quals_t(*args, tm, tc)
        assert state.STATE_KERNEL_LAUNCHES == before + 1
        assert torch.equal(
            got, state.threshold_state_quals_t_plain(*args, tm, tc)), n


@pytest.mark.cuda
def test_state_f32_misaligned_views_raise(cuda_device):
    """The f32 rows kernel loads rows 16 bytes at a time, and at M = 1 four
    bases at a time: a probs view at a 4-byte offset raises, naming the
    16-byte rule, and so does a base at an odd offset at M = 1; at M = 2 an
    odd base is taken, and so is a runtime-M probs view at a 4-byte offset;
    the same values at an aligned address are taken."""
    n = 4111
    rng = np.random.default_rng(5)

    def odd(t):
        """t's values in a view one element past an aligned allocation."""
        buf = torch.zeros(t.numel() + 4, dtype=t.dtype, device=cuda_device)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    for m in (1, 2, 9):
        probs, base, thr_mod, thr_can = _arbitrary_rows(rng, n, m)
        tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
        p, b = (torch.from_numpy(a).to(cuda_device) for a in (probs, base))
        want = state.threshold_state_f32_plain(p, b, tm, tc)
        assert torch.equal(state.threshold_state_f32(p, b, tm, tc), want)
        if m in state.F32_CLASSES:
            with pytest.raises(ValueError,
                               match="probs is not 16-byte aligned"):
                state.threshold_state_f32(odd(p), b, tm, tc)
        else:
            assert torch.equal(state.threshold_state_f32(odd(p), b, tm, tc),
                               want)
        if m == 1:
            with pytest.raises(ValueError, match="base is not 4-byte aligned"):
                state.threshold_state_f32(p, odd(b), tm, tc)
        else:
            assert torch.equal(state.threshold_state_f32(p, odd(b), tm, tc),
                               want)


@pytest.mark.cuda
def test_pileup_count_kernel_copies_a_misaligned_view(cuda_device):
    """pileup_count_kernel takes a probs view at a 4-byte offset: it copies
    the rows to an aligned tensor itself, and counts as the CPU does."""
    rng = np.random.default_rng(12)
    n, m, p = 50_001, 4, 2_000
    cols = [rng.integers(0, p, n), rng.integers(0, 2, n),
            rng.integers(0, 4, n), rng.integers(0, 3, n)]
    probs, _, thr_mod, thr_can = _arbitrary_rows(rng, n, m)
    cpu = [torch.from_numpy(a.astype(np.int32)) for a in cols]
    valid = torch.ones(n, dtype=torch.bool)
    tm, tc = torch.from_numpy(thr_mod), torch.from_numpy(thr_can)
    kw = dict(num_positions=p, num_codes=m)
    buf = torch.zeros(n * m + 4, dtype=torch.float32, device=cuda_device)
    view = buf[1:1 + n * m].view(n, m)
    view.copy_(torch.from_numpy(probs))
    assert view.data_ptr() % 16
    before = state.STATE_F32_KERNEL_LAUNCHES
    got = counts.pileup_count_kernel(
        *(a.to(cuda_device) for a in cpu), view, valid.to(cuda_device), tm,
        tc, **kw)
    assert state.STATE_F32_KERNEL_LAUNCHES == before + 1
    want = counts.pileup_count_kernel(*cpu, torch.from_numpy(probs), valid,
                                      tm, tc, **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_collapse_pileup_on_cuda_equals_the_host_route(cuda_device, tmp_path,
                                                       monkeypatch):
    """``--ignore h`` leaves one code whose probabilities are not exact ML
    values: on the card every tile with events launches kernel A's f32
    entry at M = 1 once and its quals entry never, and the bedMethyl is the
    host C++ route's."""
    import filecmp

    from modkit_tpu_torch.collapse import CollapseMethod
    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam

    bam = str(tmp_path / "s.bam")
    make_synthetic_modbam(bam, n_reads=600, read_len=2000, coverage=20.0,
                          seed=7)
    outs = {}
    for route, offload in (("cuda", "always"), ("host", "never")):
        monkeypatch.setenv("MODKIT_TPU_OFFLOAD", offload)
        outs[route] = str(tmp_path / f"{route}.bed")
        before = (state.STATE_KERNEL_LAUNCHES,
                  state.STATE_F32_KERNEL_LAUNCHES)
        run_pileup(PileupConfig(
            in_bam=bam, out=outs[route], interval_size=5_000,
            no_filtering=True, suppress_progress=True, device="cuda",
            collapse=[CollapseMethod("dist", ("h",))]))
        launched = (state.STATE_KERNEL_LAUNCHES - before[0],
                    state.STATE_F32_KERNEL_LAUNCHES - before[1])
        if route == "cuda":
            tiles = {int(line.split("\t", 2)[1]) // 5_000
                     for line in open(outs[route])}
            assert launched == (0, len(tiles)) and len(tiles) > 4
        else:
            assert launched == (0, 0)
    assert filecmp.cmp(outs["cuda"], outs["host"], shallow=False)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_count_kernel_equals_plain(cuda_device, m):
    rng = np.random.default_rng(m)
    n, p = 300_000, 100_000
    rpos = rng.integers(0, p, n).astype(np.int32)
    rpos[: n // 10] = 77  # a hot column
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.int32)
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0
    tm, tc = state.thresholds_to_tensors(
        rng.random((m, 4), dtype=np.float32) * np.float32(0.5),
        np.full(4, 0.5, dtype=np.float32), m,
    )
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (rpos, strand, base, probs)]
    before = counts.COUNT_KERNEL_LAUNCHES
    got = counts.modcall_counts(*args, tm, tc, p)
    assert counts.COUNT_KERNEL_LAUNCHES == before + 1
    want = counts.modcall_counts_plain(*args, tm, tc, p)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got.sum()) == n


def _count_case(n, m, p, seed, shape="random"):
    """Events for kernel B: ``one-position`` puts every event on one
    position (every atomic on a few counters), ``out-of-range`` puts some at
    rpos -1 and P (dropped) and some with a strand of 2 or a base of 5 (a
    flat index of another row, or outside)."""
    rng = np.random.default_rng(seed)
    rpos = rng.integers(0, p, n).astype(np.int32)
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.int32)
    if shape == "one-position":
        rpos[:] = p // 3
    elif shape == "out-of-range":
        rpos[::5] = -1
        rpos[1::7] = p
        strand[2::11] = 2
        base[3::13] = 5
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0
    tm, tc = state.thresholds_to_tensors(
        rng.random((m, 4), dtype=np.float32) * np.float32(0.5),
        np.full(4, 0.5, dtype=np.float32), m)
    return [rpos, strand, base, probs], tm, tc


def _kept_counts(args, tm, tc, p):
    """The plain count of every event, unfiltered, which must equal the
    plain count of the events whose flat index lies in the output (the
    kernel and the plain version both drop the others); and how many those
    are."""
    m = args[3].shape[1]
    km = 1 + 4 * (m + 1)
    flat = counts.flat_indices(*args, tm, tc)
    keep = (flat >= 0) & (flat < p * 2 * km)
    want = counts.modcall_counts_plain(*args, tm, tc, p)
    assert torch.equal(want, counts.modcall_counts_plain(
        *[a[keep] for a in args], tm, tc, p))
    return want, int(keep.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("shape,n", [("random", 200_003), ("one-position",
                                                            200_003),
                                     ("out-of-range", 50_001), ("empty", 0),
                                     ("one", 1)])
def test_count_kernel_writes_every_cell(cuda_device, m, shape, n):
    """Kernel B into an output first filled with 0x7f7f7f7f, twice in a row
    (a cell left over from the first call would show in the second), with
    P * 2 * Km not a multiple of 4, so the zero pass stores a tail."""
    p = 30_011
    host, tm, tc = _count_case(n, m, p, seed=n + m, shape=shape)
    args = [torch.from_numpy(a).to(cuda_device) for a in host]
    want, kept = _kept_counts(args, tm, tc, p)
    km = 1 + 4 * (m + 1)
    for _ in range(2):
        out = torch.full((p, 2, km), 0x7F7F7F7F, dtype=torch.int32,
                         device=cuda_device)
        before = counts.COUNT_KERNEL_LAUNCHES
        got = counts.modcall_counts(*args, tm, tc, p, out=out)
        assert counts.COUNT_KERNEL_LAUNCHES == before + 1
        assert got is out and torch.equal(got, want)
        assert int(got.sum()) == kept
        assert torch.equal(counts.modcall_counts(*args, tm, tc, p), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 9])
def test_count_kernel_reads_inputs_written_just_before(cuda_device, m):
    """The count pass loads its events before it waits for the zero pass:
    inputs written by the kernels just before it on the stream, with no
    synchronisation between, must be the ones it counts."""
    p = 20_011
    host, tm, tc = _count_case(300_001, m, p, seed=m)
    src = [torch.from_numpy(a).to(cuda_device) for a in host]
    for shift in range(1, 6):
        # new inputs each round, made on the stream right before the call
        args = [(src[0] + shift * 997) % p, src[1].flip(0).contiguous(),
                src[2].roll(shift).contiguous(), src[3].roll(shift, 0)]
        got = counts.modcall_counts(*args, tm, tc, p)
        assert torch.equal(got, counts.modcall_counts_plain(*args, tm, tc, p))


# ---- kernels A (f32 entry) and B for any M up to MAX_CLASSES ----

def _probs_case(n, m, seed):
    rng = np.random.default_rng(seed)
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0  # absent classes
    probs[rng.random((n, m)) < 0.05] = 0.0
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.5)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
    return rng, probs, thr_mod, thr_can


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 9, 16, state.MAX_CLASSES])
def test_state_f32_any_m_equals_plain(cuda_device, m):
    n = 100_003 if m <= 16 else 4099
    rng, probs, thr_mod, thr_can = _probs_case(n, m, m)
    base = rng.integers(0, 5, n).astype(np.uint8)  # 4 = N: first column
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
    p, b = (torch.from_numpy(a).to(cuda_device) for a in (probs, base))
    before = state.STATE_F32_KERNEL_LAUNCHES
    got = state.threshold_state_f32(p, b, tm, tc)
    assert state.STATE_F32_KERNEL_LAUNCHES == before + 1
    want = state.threshold_state_f32_plain(p, b, tm, tc)
    assert torch.equal(got, want)
    assert int(got.max()) >= 2  # some mod class won


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 9, 16])
def test_count_kernel_any_m_equals_plain(cuda_device, m):
    n, p = 200_000, 50_000
    rng, probs, thr_mod, thr_can = _probs_case(n, m, m + 100)
    rpos = rng.integers(0, p, n).astype(np.int32)
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.int32)
    tm, tc = state.thresholds_to_tensors(thr_mod, thr_can, m)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (rpos, strand, base, probs)]
    before = counts.COUNT_KERNEL_LAUNCHES
    got = counts.modcall_counts(*args, tm, tc, p)
    assert counts.COUNT_KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, counts.modcall_counts_plain(*args, tm, tc, p))
    assert int(got.sum()) == n


@pytest.mark.cuda
def test_any_m_entries_refuse_more_classes_than_a_state_byte(cuda_device):
    m = state.MAX_CLASSES + 1
    p = torch.zeros((4, m), device=cuda_device)
    b = torch.zeros(4, dtype=torch.uint8, device=cuda_device)
    tm, tc = state.thresholds_to_tensors(np.zeros((m, 4)), np.zeros(4), m)
    with pytest.raises(ValueError, match="M <="):
        state.threshold_state_f32(p, b, tm, tc)


@pytest.mark.cuda
def test_nine_code_pileup_on_cuda_equals_the_host_route(cuda_device,
                                                        tmp_path,
                                                        monkeypatch):
    import filecmp

    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
    from modkit_tpu_torch.utils.synth_codes import make_multicode_modbam

    bam = str(tmp_path / "nine.bam")
    make_multicode_modbam(bam, n_reads=300, read_len=2000, seed=3)
    outs = {}
    for route, offload in (("cuda", "always"), ("host", "never")):
        monkeypatch.setenv("MODKIT_TPU_OFFLOAD", offload)
        before = state.STATE_F32_KERNEL_LAUNCHES
        outs[route] = str(tmp_path / f"{route}.bed")
        run_pileup(PileupConfig(in_bam=bam, out=outs[route],
                                no_filtering=True, suppress_progress=True,
                                device="cuda"))
        launched = state.STATE_F32_KERNEL_LAUNCHES - before
        assert (launched > 0) == (route == "cuda")
    assert filecmp.cmp(outs["cuda"], outs["host"], shallow=False)


# ---- CRAM input (kernel B on the Python event route) ----

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no-filtering", "estimate"])
def test_cram_pileup_on_cuda_equals_the_cpu(cuda_device, tmp_path,
                                            monkeypatch, mode):
    """A CRAM runs serially on the Python event route: on the card every
    tile with events launches kernel B once, kernel A never, and the
    bedMethyl is the CPU run's."""
    import filecmp

    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam
    from modkit_tpu_torch.utils.synth_cram import write_cram

    bam, fa, cram = (str(tmp_path / f"s.{x}") for x in ("bam", "fa",
                                                        "cram"))
    make_synthetic_modbam(bam, n_reads=400, read_len=2000, coverage=20.0,
                          seed=5, fasta_out=fa)
    write_cram(bam, fa, cram, records_per_container=100)
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")
    kw = dict(no_filtering=True) if mode == "no-filtering" else {}
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = str(tmp_path / f"{device}.bed")
        before = (state.STATE_KERNEL_LAUNCHES,
                  state.STATE_F32_KERNEL_LAUNCHES,
                  counts.COUNT_KERNEL_LAUNCHES)
        run_pileup(PileupConfig(in_bam=cram, out=outs[device],
                                reference_fasta=fa, interval_size=10_000,
                                suppress_progress=True, device=device, **kw))
        launched = (state.STATE_KERNEL_LAUNCHES - before[0],
                    state.STATE_F32_KERNEL_LAUNCHES - before[1],
                    counts.COUNT_KERNEL_LAUNCHES - before[2])
        if device == "cuda":
            tiles = {int(line.split("\t", 2)[1]) // 10_000
                     for line in open(outs[device])}
            assert launched == (0, 0, len(tiles)) and tiles
        else:
            assert launched == (0, 0, 0)
    assert filecmp.cmp(outs["cuda"], outs["cpu"], shallow=False)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 9])
def test_run_pileup_counts_on_cuda_equals_the_cpu(cuda_device, m):
    rng = np.random.default_rng(40 + m)
    n, p = 300_000, 100_000
    rpos = rng.integers(0, p, n).astype(np.int32)
    rpos[::97] = -1
    rpos[1::89] = p
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.int32)
    ev_type = rng.integers(0, 3, n).astype(np.int32)
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0
    thr_mod = rng.random((m, 4), dtype=np.float32) * np.float32(0.5)
    thr_can = rng.random(4, dtype=np.float32) * np.float32(0.8)
    args = (rpos, strand, base, ev_type, probs, thr_mod, thr_can, p)
    f32_before = state.STATE_F32_KERNEL_LAUNCHES
    got = counts.run_pileup_counts(*args, device="cuda")
    # the call is kernel A's f32 entry: one launch per call
    assert state.STATE_F32_KERNEL_LAUNCHES == f32_before + 1
    want = counts.run_pileup_counts(*args, device="cpu")
    assert state.STATE_F32_KERNEL_LAUNCHES == f32_before + 1
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert 0 < got.sum() < n


# ---- the count-kernel lab (ops/lab_counts.py) ----

LAB_EVENTS, LAB_POSITIONS = 300_000, 30_000


@pytest.fixture(scope="module")
def lab_inputs():
    from modkit_tpu_torch.tools import kernel_lab

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    events = kernel_lab.lab_events(LAB_EVENTS, LAB_POSITIONS)
    return {dev: kernel_lab.LabInputs.build(events, LAB_POSITIONS, dev)
            for dev in ("cuda", "cpu")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "int8x1", "bigk-bf16", "group-int8", "groupx2", "bigkh-int8", "rep8-int8",
    "empty", "onehot-only", "matmul-only", "a-only"])
def test_lab_kernel_equals_plain(lab_inputs, name):
    from modkit_tpu_torch.ops import lab_counts
    from modkit_tpu_torch.tools import kernel_lab

    fn, _, histogram = kernel_lab.variant_call(name, lab_inputs["cuda"])
    before = sum(lab_counts.LAUNCHES.values())
    got = fn()
    assert sum(lab_counts.LAUNCHES.values()) == before + 1
    # the wrapper on CPU tensors runs the plain version
    plain_fn, _, _ = kernel_lab.variant_call(name, lab_inputs["cpu"])
    assert torch.equal(got.cpu(), plain_fn())
    if histogram:
        assert np.array_equal(got.cpu().numpy(), lab_inputs["cpu"].oracle())


@pytest.mark.cuda
@pytest.mark.parametrize("ablation", [None, "no-dot", "no-construct"])
@pytest.mark.parametrize("chunk", [256, 2048])
def test_lab_rep8_rows_not_replicated_equals_plain(cuda_device, chunk,
                                                   ablation):
    from modkit_tpu_torch.ops import lab_counts

    rng = np.random.default_rng(chunk)
    n_chunks, g = 300, 40
    c2g = np.sort(rng.integers(0, g, n_chunks)).astype(np.int32)
    p2r = rng.integers(0, 256, (n_chunks * 8, chunk)).astype(np.uint8)
    colr = rng.integers(0, 256, (n_chunks * 8, chunk)).astype(np.uint8)
    cpu = [torch.from_numpy(a) for a in (c2g, p2r, colr)]
    gpu = [a.to(cuda_device) for a in cpu]
    kw = dict(n_groups=g, oh=torch.int8, acc=torch.int32, chunk=chunk,
              ablation=ablation)
    got = lab_counts.run_rep8(*gpu, **kw)
    assert torch.equal(got.cpu(), lab_counts.run_rep8(*cpu, **kw))


@pytest.mark.cuda
def test_lab_values_out_of_range_and_group_ranges(cuda_device):
    from modkit_tpu_torch.ops import count_layout, lab_counts

    rng = np.random.default_rng(4)
    n_chunks, g = 64, 8
    slots = n_chunks * count_layout.CHUNK
    c2g = np.sort(rng.integers(0, g, n_chunks)).astype(np.int32)
    p2 = rng.integers(0, 256, slots).astype(np.uint8)
    col = rng.integers(-300, 300, slots).astype(np.int32)
    valid = rng.integers(0, 2, slots).astype(np.int32)
    cpu = [torch.from_numpy(a) for a in (c2g, p2, col, valid)]
    gpu = [a.to(cuda_device) for a in cpu]
    for mode in lab_counts.DIAG_MODES:
        assert torch.equal(
            lab_counts.run_diag(*gpu, n_groups=g, mode=mode).cpu(),
            lab_counts.run_diag(*cpu, n_groups=g, mode=mode))
    kw = dict(n_groups=g, acc=torch.int32, oh=torch.int8, n_acc=1)
    assert torch.equal(lab_counts.run_variant(*gpu, **kw).cpu(),
                       lab_counts.run_variant(*cpu, **kw))
    # run_group over ranges that skip, repeat and leave groups empty
    packed = torch.from_numpy(
        rng.integers(0, 256, (n_chunks * 32, 128)).astype(np.uint8))
    cnt = rng.integers(0, 6, g).astype(np.int32)
    cnt[2] = 0
    start = rng.integers(0, n_chunks - 6, g).astype(np.int32)
    gmeta = torch.from_numpy(np.concatenate([cnt, start]))
    kw = dict(n_groups=g, oh=torch.int8, acc=torch.int32)
    assert torch.equal(
        lab_counts.run_group(gmeta.to(cuda_device), packed.to(cuda_device),
                             **kw).cpu(),
        lab_counts.run_group(gmeta, packed, **kw))


@pytest.mark.cuda
def test_lab_unsorted_c2g_and_stray_ranges_on_cuda_equal_plain(cuda_device):
    """Chunks in any group order, groups outside [0, n_groups) and run_group
    ranges past the chunks or of negative count: kernel == plain."""
    from modkit_tpu_torch.ops import count_layout, lab_counts

    rng = np.random.default_rng(8)
    n_chunks, g = 48, 6
    slots = n_chunks * count_layout.CHUNK
    c2g = rng.integers(-2, g + 2, n_chunks).astype(np.int32)  # unsorted
    planes = [c2g, rng.integers(0, 256, slots).astype(np.uint8),
              rng.integers(-40, 200, slots).astype(np.int32),
              rng.integers(0, 2, slots).astype(np.int32)]
    cpu = [torch.from_numpy(a) for a in planes]
    gpu = [a.to(cuda_device) for a in cpu]
    kw = dict(n_groups=g, acc=torch.int32, oh=torch.int8, n_acc=1)
    assert torch.equal(lab_counts.run_variant(*gpu, **kw).cpu(),
                       lab_counts.run_variant(*cpu, **kw))
    for mode in lab_counts.DIAG_MODES:
        assert torch.equal(
            lab_counts.run_diag(*gpu, n_groups=g, mode=mode).cpu(),
            lab_counts.run_diag(*cpu, n_groups=g, mode=mode))
    rows = [torch.from_numpy(rng.integers(0, 256, (n_chunks * 8, 256))
                             .astype(np.uint8)) for _ in range(2)]
    for ablation in (None, *lab_counts.ABLATIONS):
        kw = dict(n_groups=g, oh=torch.int8, acc=torch.int32, chunk=256,
                  ablation=ablation)
        assert torch.equal(
            lab_counts.run_rep8(gpu[0], *[r.to(cuda_device) for r in rows],
                                **kw).cpu(),
            lab_counts.run_rep8(cpu[0], *rows, **kw))
    packed = torch.from_numpy(
        rng.integers(0, 256, (n_chunks * 32, 128)).astype(np.uint8))
    cnt = rng.integers(0, 8, g).astype(np.int32)
    start = rng.integers(0, n_chunks - 8, g).astype(np.int32)
    cnt[0] = -2  # a negative count
    start[1], cnt[1] = n_chunks - 2, 6  # runs past the last chunk
    start[2], cnt[2] = -3, 5  # starts before the first
    gmeta = torch.from_numpy(np.concatenate([cnt, start]))
    kw = dict(n_groups=g, oh=torch.int8, acc=torch.int32)
    assert torch.equal(
        lab_counts.run_group(gmeta.to(cuda_device), packed.to(cuda_device),
                             **kw).cpu(),
        lab_counts.run_group(gmeta, packed, **kw))


@pytest.mark.cuda
def test_lab_entry_point_on_cuda(cuda_device):
    from modkit_tpu_torch.tools import kernel_lab

    lines = []
    res = kernel_lab.run_lab(
        ["bf16x2", "bigk-int8", "group-int8", "bigkh-int8", "rep8-int8",
         "rep8-bf16-c256", "empty", "a-only"], "cuda", LAB_EVENTS,
        LAB_POSITIONS, 2, log=lines.append)
    assert all(r["ok"] for r in res.values()), lines


# ---- shapes that stress the histograms' shared-memory group blocks, their
# spans of chunks and the warp-aggregated increments ----

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8x1", "bigkh-int8", "rep8-int8",
                                  "rep8-int8-c256", "group-int8"])
def test_lab_one_position_equals_plain_and_oracle(cuda_device, name):
    """Every event at one position and strand: one cell takes every slot
    of a chunk."""
    from modkit_tpu_torch.tools import kernel_lab

    chunk = 256 if name.endswith("c256") else kernel_lab.CHUNK
    events = kernel_lab.one_position_events(LAB_EVENTS, LAB_POSITIONS)
    labs = {dev: kernel_lab.LabInputs.build(events, LAB_POSITIONS, dev,
                                            chunk=chunk)
            for dev in ("cuda", "cpu")}
    oracle = labs["cpu"].oracle()
    assert np.count_nonzero(oracle) == 1
    fn, plain, _ = kernel_lab.variant_call(name, labs["cuda"])
    got = fn()
    assert torch.equal(got, plain())
    assert np.array_equal(got.cpu().numpy(), oracle)
    if name == "rep8-int8":
        from modkit_tpu_torch.ops import lab_counts

        lab = labs["cuda"]
        assert torch.equal(lab_counts.count_call(lab.planes[0], *lab.rep8,
                                                 n_groups=lab.n_groups), got)


def _runs(rng, n, lo, hi):
    """n values in [lo, hi) in runs of 1 to 60 equal values, as sorted
    events give them."""
    vals = rng.integers(lo, hi, n)
    return np.repeat(vals, rng.integers(1, 61, n))[:n]


# more chunks than one wave of histogram blocks has blocks, so that each
# block's span holds several chunks, of unequal spans
STRESS_CHUNKS = 1601


def _c2g_plan(kind, n, rng):
    """(c2g, n_groups) over n chunks: one group over every chunk; sorted
    groups of 1 to 9 chunks, whose changes fall inside the blocks' spans;
    or groups interleaved chunk by chunk, with chunks of no group."""
    if kind == "one-group":
        return np.zeros(n, np.int32), 1
    if kind == "straddle":
        cnt = rng.integers(1, 10, n)
        c2g = np.repeat(np.arange(n), cnt)[:n].astype(np.int32)
        return c2g, int(c2g[-1]) + 1
    return np.tile(np.array([0, 1, 2, 1, -1, 3], np.int32), n)[:n], 4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one-group", "straddle", "interleaved"])
@pytest.mark.parametrize("reader", ["planes", "rows", "rep8", "rep8-rows"])
def test_lab_group_blocks_equal_plain(cuda_device, kind, reader):
    from modkit_tpu_torch.ops import count_layout, lab_counts

    rng = np.random.default_rng(len(kind) * 10 + len(reader))
    c2g, g = _c2g_plan(kind, STRESS_CHUNKS, rng)
    n = len(c2g)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for r in lab_counts.BLOCKS_PER_SM:
        assert lab_counts.hist_spans(r, n, sms)[0] > 1
    slots = n * count_layout.CHUNK
    p2 = _runs(rng, slots, 0, 140).astype(np.uint8)
    col = _runs(rng, slots, -5, 135).astype(np.int32)
    valid = (rng.random(slots) < 0.9).astype(np.int32)
    if reader == "planes":
        arrays = [p2, col, valid]
        fn = lambda *a: lab_counts.run_variant(
            *a, n_groups=g, acc=torch.int32, oh=torch.int8, n_acc=1)
    elif reader == "rows":
        arrays = [p2.reshape(n, -1),
                  np.where(valid != 0, col, 255).astype(np.uint8)
                  .reshape(n, -1)]
        fn = lambda *a: lab_counts.run_bigk_host(
            *a, n_groups=g, oh=torch.int8, acc=torch.int32)
    elif reader == "rep8":  # identical rows, as the planner makes them
        arrays = [count_layout.rep8(p2, n),
                  count_layout.rep8(np.clip(col, 0, 255), n, valid=valid)]
        fn = lambda *a: lab_counts.count_call(*a, n_groups=g)
    else:  # rows that differ, at chunk 256: every matching pair adds
        arrays = [_runs(rng, n * 8 * 256, 0, 256).astype(np.uint8)
                  .reshape(n * 8, 256) for _ in range(2)]
        fn = lambda *a: lab_counts.run_rep8(
            *a, n_groups=g, oh=torch.int8, acc=torch.int32, chunk=256)
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in (c2g, *arrays)]
    got = fn(*[a.to(cuda_device) for a in cpu])
    want = fn(*cpu)
    assert got.sum() > 0 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_lab_counts_past_sixteen_bits_equal_plain(cuda_device):
    """One cell takes every slot of chunks of 65 536 slots (two pieces of a
    block's 16-bit counts each), and of a run_group range of 301 chunks."""
    from modkit_tpu_torch.ops import lab_counts

    chunk, n = 65536, 3
    c2g = torch.tensor([0, 0, 1], dtype=torch.int32)
    rows = torch.full((n * 8, chunk), 255, dtype=torch.uint8)
    rows[5::8] = 13  # 13 % 8 == 5: row 13 of the output, one pair per slot
    cols = torch.full((n * 8, chunk), 255, dtype=torch.uint8)
    cols[2::8] = 42  # 42 % 8 == 2
    kw = dict(n_groups=2, oh=torch.int8, acc=torch.int32, chunk=chunk)
    got = lab_counts.run_rep8(*[t.to(cuda_device) for t in (c2g, rows, cols)],
                              **kw)
    assert int(got[0, 13, 42]) == 2 * chunk and int(got[1, 13, 42]) == chunk
    assert torch.equal(got.cpu(), lab_counts.run_rep8(c2g, rows, cols, **kw))
    n_chunks = 301
    packed = torch.full((n_chunks, 32, 128), 7, dtype=torch.uint8)
    packed[:, 16:] = 99  # p2 7, col 99 in every slot
    gmeta = torch.tensor([n_chunks, 0], dtype=torch.int32)
    got = lab_counts.run_group(gmeta.to(cuda_device),
                               packed.view(-1, 128).to(cuda_device),
                               n_groups=1, oh=torch.int8, acc=torch.int32)
    assert int(got[0, 7, 99]) == n_chunks * 2048 and int(got.sum()) == int(
        got[0, 7, 99])


@pytest.mark.cuda
@pytest.mark.parametrize("ranges", ["one-group", "overlapping"])
def test_lab_run_group_ranges_equal_plain(cuda_device, ranges):
    from modkit_tpu_torch.ops import lab_counts

    rng = np.random.default_rng(12)
    n_chunks = 301
    packed = torch.from_numpy(np.stack(
        [_runs(rng, 128, 0, 140) for _ in range(n_chunks * 32)])
        .astype(np.uint8))
    if ranges == "one-group":
        cnt, start = np.array([n_chunks]), np.array([0])
    else:  # ranges that overlap, nest, repeat and run past the chunks
        cnt = np.array([120, 90, 301, 3, 0, 40, 77])
        start = np.array([0, 60, 0, 59, 5, 280, 100])
    gmeta = torch.from_numpy(np.concatenate([cnt, start]).astype(np.int32))
    kw = dict(n_groups=len(cnt), oh=torch.int8, acc=torch.int32)
    got = lab_counts.run_group(gmeta.to(cuda_device), packed.to(cuda_device),
                               **kw)
    assert got.sum() > 0
    assert torch.equal(got.cpu(), lab_counts.run_group(gmeta, packed, **kw))


@pytest.mark.cuda
def test_lab_misaligned_base_pointer_raises(cuda_device):
    from modkit_tpu_torch.ops import count_layout, lab_counts

    n = 3
    slots = n * count_layout.CHUNK
    c2g = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    u8 = torch.zeros(slots * 8 + 16, dtype=torch.uint8, device=cuda_device)
    i32 = torch.zeros(slots + 4, dtype=torch.int32, device=cuda_device)
    odd8, odd32 = u8[1:slots + 1], i32[1:slots + 1]
    ok8, ok32 = u8[:slots], i32[:slots]
    kw = dict(oh=torch.int8, acc=torch.int32)
    with pytest.raises(ValueError, match="col is not 16-byte aligned"):
        lab_counts.run_variant(c2g, ok8, odd32, ok32, n_groups=1, n_acc=1,
                               **kw)
    with pytest.raises(ValueError, match="p2_rows is not 16-byte aligned"):
        lab_counts.run_bigk_host(c2g, odd8.view(n, -1), ok8.view(n, -1),
                                 n_groups=1, **kw)
    rows = u8[1:slots * 8 + 1].view(n * 8, -1)
    with pytest.raises(ValueError, match="p2r is not 16-byte aligned"):
        lab_counts.count_call(c2g, rows, u8[:slots * 8].view(n * 8, -1),
                              n_groups=1)
    gmeta = torch.tensor([n, 0], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="packed is not 16-byte aligned"):
        lab_counts.run_group(gmeta, u8[1:2 * slots + 1].view(-1, 128),
                             n_groups=1, **kw)
    with pytest.raises(ValueError, match="p2 is not 16-byte aligned"):
        lab_counts.run_diag(c2g, odd8, ok32, ok32, n_groups=1, mode="a-only")


# ---- the diag kernel (run_diag's modes, run_rep8's ablations) ----

DIAG = [*["empty", "onehot-only", "matmul-only", "a-only"], "no-dot",
        "no-construct"]


def _diag_call(name, c2g, planes=None, rows=None, g=1, chunk=2048):
    """run_diag(mode=name) over the planes, or run_rep8(ablation=name) over
    the rep8 rows."""
    from modkit_tpu_torch.ops import lab_counts

    if name in lab_counts.DIAG_MODES:
        return lab_counts.run_diag(c2g, *planes, n_groups=g, mode=name)
    return lab_counts.run_rep8(c2g, *rows, n_groups=g, oh=torch.int8,
                               acc=torch.int32, chunk=chunk, ablation=name)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["lab", "unvisited"])
def test_lab_empty_writes_every_cell(cuda_device, plan):
    """run_diag's empty body writes every cell of an output first filled
    with 0x7f7f7f7f, at the lab's shape and on a plan whose chunks visit
    only some groups (and one chunk of no group)."""
    from modkit_tpu_torch.ops import lab_counts
    from modkit_tpu_torch.tools import kernel_lab

    if plan == "lab":
        lab = kernel_lab.LabInputs.build(
            kernel_lab.lab_events(LAB_EVENTS, LAB_POSITIONS), LAB_POSITIONS,
            cuda_device)
        c2g, planes, g = lab.planes[0], lab.planes[1:], lab.n_groups
    else:
        g = 37
        c2g = torch.tensor([3, 3, 9, 20, 99], dtype=torch.int32,
                           device=cuda_device)
        slots = c2g.numel() * 2048
        planes = [torch.full((slots,), 5, dtype=torch.uint8,
                             device=cuda_device),
                  torch.full((slots,), 5, dtype=torch.int32,
                             device=cuda_device),
                  torch.ones(slots, dtype=torch.int32, device=cuda_device)]
    out = torch.full((g, 128, 128), 0x7F7F7F7F, dtype=torch.int32,
                     device=cuda_device)
    before = lab_counts.DIAG_LAUNCHES["empty"]
    got = lab_counts.run_diag(c2g, *planes, n_groups=g, mode="empty",
                              out=out)
    assert lab_counts.DIAG_LAUNCHES["empty"] == before + 1
    assert got is out
    assert torch.equal(got, lab_counts.diag_plain(c2g, *planes, g, "empty"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", DIAG)
@pytest.mark.parametrize("shape", ["lab", "one-position", "one-group"])
def test_lab_diag_equals_plain(cuda_device, shape, name):
    """Each diag body at the lab's data, with every event at one position
    (one cell takes whole chunks) and with every chunk in group 0 (a run
    longer than a piece, split over blocks)."""
    from modkit_tpu_torch.ops import lab_counts
    from modkit_tpu_torch.tools import kernel_lab

    if shape == "lab":
        events, p = kernel_lab.lab_events(LAB_EVENTS, LAB_POSITIONS), LAB_POSITIONS
    elif shape == "one-position":
        events = kernel_lab.one_position_events(LAB_EVENTS, LAB_POSITIONS)
        p = LAB_POSITIONS
    else:
        events, p = kernel_lab.lab_events(LAB_EVENTS, 500), 500
    labs = {k: kernel_lab.LabInputs.build(events, p, dev)
            for k, dev in (("card", cuda_device), ("cpu", "cpu"))}
    if shape == "one-group":
        assert labs["cpu"].n_groups == 1
        assert labs["cpu"].n_chunks > lab_counts.DIAG_PIECE_CHUNKS
    outs = {k: _diag_call(name, lab.planes[0], lab.planes[1:], lab.rep8,
                          lab.n_groups)
            for k, lab in labs.items()}
    assert torch.equal(outs["card"].cpu(), outs["cpu"])
    assert name == "empty" or outs["cpu"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["a-only", "matmul-only", "no-construct",
                                  "onehot-only"])
def test_lab_diag_counts_past_sixteen_bits_equal_plain(cuda_device, name):
    """One cell takes every slot of 40 chunks of group 0, and of 3 chunks
    of group 1: the output's count passes 2^16 through the flushes of
    several blocks (matmul-only and no-construct add to the output
    directly). A block's own pieces are tested below."""
    n = 40
    c2g = torch.zeros(n, dtype=torch.int32)
    c2g[-3:] = 1
    slots = n * 2048
    planes = [torch.full((slots,), 5, dtype=torch.uint8),
              torch.full((slots,), 5, dtype=torch.int32),
              torch.ones(slots, dtype=torch.int32)]
    rows = [torch.full((n * 8, 2048), 255, dtype=torch.uint8)
            for _ in range(2)]
    rows[0][::8] = 200  # no-construct: 2048 x 200 per chunk at (0, 0)
    cpu = _diag_call(name, c2g, planes, rows, g=2)
    got = _diag_call(name, c2g.to(cuda_device),
                     [t.to(cuda_device) for t in planes],
                     [t.to(cuda_device) for t in rows], g=2)
    assert int(cpu.max()) >= (1 << 16) or name == "onehot-only"
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["a-only", "onehot-only"])
def test_lab_diag_block_flushes_its_pieces_equal_plain(cuda_device, name):
    """So many chunks of group 0, each with every slot on one cell, that
    every block of diag_kernel's wave counts 2 * DIAG_PIECE_CHUNKS + 1 of
    them: its 16-bit block must flush after each piece (a-only's cell
    would pass 2^16 within the block after 32 chunks), then 3 chunks of
    group 1."""
    from modkit_tpu_torch.ops import lab_counts as lc

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    wave = lc.DIAG_SM_THREADS // lc.DIAG_THREADS[name] * sms
    per_block = 2 * lc.DIAG_PIECE_CHUNKS + 1
    n = wave * per_block + 3
    # one wave, not more blocks: a nominal span holds the block's chunks
    assert per_block <= lc.DIAG_THREADS[name] - 2 * lc.DIAG_PIECE_CHUNKS - 2
    if name == "a-only":
        assert per_block * lc.DIAG_CELL_GAIN_PER_CHUNK[name] >= 1 << 16
    c2g = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    c2g[-3:] = 1
    slots = n * 2048
    planes = [torch.full((slots,), 5, dtype=torch.uint8, device=cuda_device),
              torch.full((slots,), 5, dtype=torch.int32, device=cuda_device),
              torch.ones(slots, dtype=torch.int32, device=cuda_device)]
    got = lc.run_diag(c2g, *planes, n_groups=2, mode=name)
    want = lc.diag_plain(c2g, *planes, 2, name)
    assert int(want[0].max()) == (n - 3) * lc.DIAG_CELL_GAIN_PER_CHUNK[name]
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DIAG)
@pytest.mark.parametrize("kind", ["one-group", "straddle", "interleaved"])
def test_lab_diag_group_plans_equal_plain(cuda_device, kind, name):
    """Runs of c2g shorter and longer than a piece, changing inside the
    blocks' nominal spans, and groups interleaved chunk by chunk (c2g in no
    order: every flush adds), on runs of equal values as sorted events
    give them."""
    from modkit_tpu_torch.ops import count_layout

    rng = np.random.default_rng(len(kind) * 7 + len(name))
    c2g, g = _c2g_plan(kind, 601, rng)
    n = len(c2g)
    slots = n * count_layout.CHUNK
    planes = [torch.from_numpy(_runs(rng, slots, 0, 140).astype(np.uint8)),
              torch.from_numpy(_runs(rng, slots, -5, 135).astype(np.int32)),
              torch.from_numpy((rng.random(slots) < 0.9).astype(np.int32))]
    rows = [torch.from_numpy(_runs(rng, n * 8 * 256, 0, 256).astype(np.uint8)
                             .reshape(n * 8, 256)) for _ in range(2)]
    c2g = torch.from_numpy(c2g)
    cpu = _diag_call(name, c2g, planes, rows, g, chunk=256)
    got = _diag_call(name, c2g.to(cuda_device),
                     [t.to(cuda_device) for t in planes],
                     [t.to(cuda_device) for t in rows], g, chunk=256)
    assert torch.equal(got.cpu(), cpu)


# ---- the parallel paths: sharded count, 1 vs N devices, shard runs ----

@pytest.mark.cuda
def test_pileup_count_kernel_on_cuda_launches_the_f32_entry(cuda_device):
    """pileup_count_kernel on the card takes its call from kernel A's f32
    entry, one launch, and equals the CPU's, out-of-range events
    included."""
    rng = np.random.default_rng(8)
    n, m, p = 200_003, 2, 5_000
    rpos = rng.integers(-3, p + 3, n).astype(np.int32)
    strand = rng.integers(0, 2, n).astype(np.int32)
    base = rng.integers(0, 5, n).astype(np.int32)
    ev_type = rng.integers(0, 3, n).astype(np.int32)
    probs = rng.random((n, m), dtype=np.float32) / np.float32(m)
    probs[rng.random((n, m)) < 0.3] = -1.0
    valid = rng.random(n) < 0.9
    tm = torch.from_numpy(rng.random((m, 4), dtype=np.float32) * 0.5)
    tc = torch.from_numpy(rng.random(4, dtype=np.float32) * 0.8)
    cpu = [torch.from_numpy(a) for a in (rpos, strand, base, ev_type, probs,
                                         valid)]
    kw = dict(num_positions=p, num_codes=m)
    before = state.STATE_F32_KERNEL_LAUNCHES
    got = counts.pileup_count_kernel(*(a.to(cuda_device) for a in cpu), tm,
                                     tc, **kw)
    assert state.STATE_F32_KERNEL_LAUNCHES == before + 1
    want = counts.pileup_count_kernel(*cpu, tm, tc, **kw)
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 0


@pytest.mark.cuda
def test_sharded_pileup_on_one_card_equals_the_cpu(cuda_device):
    """A 4 x 2 grid of cuda:0: one f32 launch per shard, the counts the
    CPU grid's."""
    from modkit_tpu_torch.parallel import sharded_pileup as sp

    rng = np.random.default_rng(9)
    t, r, e, m, p = 4, 2, 20_000, 2, 3_000
    rpos = rng.integers(-1, p + 1, (t, r, e)).astype(np.int32)
    strand = rng.integers(0, 2, (t, r, e)).astype(np.int32)
    base = rng.integers(0, 4, (t, r, e)).astype(np.int32)
    ev_type = rng.integers(0, 3, (t, r, e)).astype(np.int32)
    probs = rng.uniform(-1, 1, (t, r, e, m)).astype(np.float32)
    valid = rng.random((t, r, e)) < 0.9
    tm = rng.random((m, 4), dtype=np.float32) * np.float32(0.6)
    tc = rng.random(4, dtype=np.float32) * np.float32(0.6)
    args = (rpos, strand, base, ev_type, probs, valid, tm, tc, p)
    before = state.STATE_F32_KERNEL_LAUNCHES
    got = sp.run_sharded_pileup(sp.make_mesh(t, r, [cuda_device] * 8),
                                *args)
    assert state.STATE_F32_KERNEL_LAUNCHES == before + t * r
    want = sp.run_sharded_pileup(sp.make_mesh(t, r, ["cpu"] * 8), *args)
    assert np.array_equal(got, want) and got.sum() > 0


@pytest.mark.cuda
def test_pileup_at_1_and_4_entries_of_one_card(cuda_device, tmp_path,
                                               monkeypatch):
    """compute_devices patched to cuda:0 listed 1 and 4 times: byte-equal
    bedMethyls, kernel A launched once per tile with events both times."""
    import filecmp

    from modkit_tpu_torch.parallel import devices
    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam

    bam = str(tmp_path / "s.bam")
    make_synthetic_modbam(bam, n_reads=600, read_len=2000, coverage=20.0,
                          seed=6)
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", "always")
    outs = {}
    for n in (1, 4):
        monkeypatch.setattr(devices, "compute_devices",
                            lambda device, n=n: [cuda_device] * n)
        outs[n] = str(tmp_path / f"{n}.bed")
        before = state.STATE_KERNEL_LAUNCHES
        run_pileup(PileupConfig(in_bam=bam, out=outs[n], interval_size=5_000,
                                no_filtering=True, suppress_progress=True,
                                device="cuda"))
        tiles = {int(line.split("\t", 2)[1]) // 5_000
                 for line in open(outs[n])}
        assert state.STATE_KERNEL_LAUNCHES - before == len(tiles) > 4
    assert filecmp.cmp(outs[1], outs[4], shallow=False)


@pytest.mark.cuda
def test_two_process_shard_pileup_on_one_card(cuda_device, tmp_path):
    """Two ranks of a gloo group share the card: the merged bedMethyl is
    the single process's."""
    import filecmp
    import os
    import socket
    import subprocess
    import sys

    from modkit_tpu_torch.pileup.runner import PileupConfig, run_pileup
    from modkit_tpu_torch.utils.synth import make_synthetic_modbam

    bam = str(tmp_path / "s.bam")
    make_synthetic_modbam(bam, n_reads=600, read_len=2000, coverage=20.0,
                          seed=6)
    single, multi = str(tmp_path / "single.bed"), str(tmp_path / "multi.bed")
    kw = dict(interval_size=5_000, no_filtering=True, with_header=True,
              suppress_progress=True)
    run_pileup(PileupConfig(in_bam=bam, out=single, device="cuda", **kw))
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    code = (
        "from modkit_tpu_torch.pileup.runner import PileupConfig, "
        "run_pileup\n"
        f"run_pileup(PileupConfig(in_bam={bam!r}, out={multi!r}, "
        f"device='cuda', **{kw!r}))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=repo, stderr=subprocess.PIPE,
        env=dict(os.environ, MODKIT_TPU_COORD=f"127.0.0.1:{port}",
                 MODKIT_TPU_NPROC="2", MODKIT_TPU_PROC_ID=str(rank)))
        for rank in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert filecmp.cmp(single, multi, shallow=False)
