"""modkit_tpu_torch's CUDA kernels against their plain PyTorch versions.

Kernel A (state: the quals entry for M in {1, 2, 4, 8}, the f32 entry for
any M up to ``MAX_CLASSES``) and kernel B (counts, any M), with a 9-code
pileup on the card against the host route; and the count-kernel lab's
kernels (``ops/lab_counts.py``) against their plain versions and the
oracle.

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
@pytest.mark.parametrize("n", [1, 127, 200_003])
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
def test_state_kernel_rejects_unsupported_classes(cuda_device):
    q = torch.zeros((3, 16), dtype=torch.uint8, device=cuda_device)
    z = torch.zeros(16, dtype=torch.uint8, device=cuda_device)
    tm, tc = state.thresholds_to_tensors(np.zeros((3, 4)), np.zeros(4), 3)
    with pytest.raises(ValueError, match="M in"):
        state.threshold_state_quals_t(q, z, z, z, tm, tc)


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
