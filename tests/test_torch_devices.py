"""modkit_tpu_torch.parallel.devices against modkit_tpu.parallel.devices,
and the device rule of the port's engine.

The port has one count route per device: the run's device does every
tile's call and count, whatever ``MODKIT_TPU_OFFLOAD`` says (modkit_tpu
still reads it, and keeps its offload policy). Its shard merge and
process info match modkit_tpu's. Every comparison is exact (``==`` on
decisions and counts, bytes on merged files).
"""

import numpy as np
import pytest
import torch

import modkit_tpu.parallel.devices as ref_devices
import modkit_tpu_torch.parallel.devices as port_devices
from modkit_tpu import collapse as ref_collapse
from modkit_tpu.caller import ThresholdCaller as RefCaller
from modkit_tpu.io.bam import BamReader as RefReader
from modkit_tpu.pileup import engine as ref_engine
from modkit_tpu_torch import collapse as port_collapse
from modkit_tpu_torch import native as port_native
from modkit_tpu_torch.caller import ThresholdCaller as PortCaller
from modkit_tpu_torch.io.bam import BamReader as PortReader
from modkit_tpu_torch.ops import counts as port_counts
from modkit_tpu_torch.pileup import engine as port_engine
from modkit_tpu_torch.utils.synth import make_synthetic_modbam


def test_cpu_device_is_one_cpu():
    assert port_devices.compute_devices("cpu") == [torch.device("cpu")]


def test_unknown_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        port_devices.resolve_device("meta")


@pytest.fixture(scope="module")
def route_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_devices") / "s.bam")
    make_synthetic_modbam(path, n_reads=120, read_len=2000, coverage=20.0,
                          seed=23)
    return path


# tile kind: (the port op its tile runs, engine options, threshold caller)
TILE_KINDS = {
    "quals": ("threshold_state_quals_t", {}, None),
    "f32": ("threshold_state_f32", {"collapse": "h"}, 0.6),
    "python": ("modcall_counts", {"use_native": False}, 0.6),
}
ROW_FIELDS = ("pos", "strand", "code_idx", "valid", "n_mod", "n_can",
              "n_other", "n_del", "n_filt", "n_diff", "n_nocall")


def _tile_rows(engine, caller_cls, reader, collapse_mod, kind):
    _, opts, threshold = TILE_KINDS[kind]
    opts = dict(opts)
    if opts.pop("collapse", None):
        opts["collapse"] = [collapse_mod.CollapseMethod("dist", ("h",))]
    if engine is port_engine:
        opts["device"] = "cpu"
    caller = (caller_cls.passthrough() if threshold is None
              else caller_cls({}, {}, threshold))
    proc = engine.TileProcessor(caller, engine.PileupOptions(**opts))
    return proc.finish_tile(proc.launch_tile(reader, 0, 0, 8000))


@pytest.mark.parametrize("kind", sorted(TILE_KINDS))
@pytest.mark.parametrize("mode", [None, "always", "never", "auto"])
def test_tile_route_follows_the_device(monkeypatch, route_bam, mode, kind):
    """A port tile on ``cpu`` runs its op (kernel A's quals or f32 entry,
    or kernel B on the Python event route) once, through its plain
    version, under every ``MODKIT_TPU_OFFLOAD``, and never the host
    routes; its rows equal modkit_tpu's, which takes its own route under
    the variable (its host C++ pass or numpy count under ``never``)."""
    if mode is None:
        monkeypatch.delenv("MODKIT_TPU_OFFLOAD", raising=False)
    else:
        # read by modkit_tpu's side only
        monkeypatch.setenv("MODKIT_TPU_OFFLOAD", mode)
    calls = {}
    for name in ("threshold_state_quals_t", "threshold_state_f32",
                 "modcall_counts"):
        def spy(*a, _fn=getattr(port_engine, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_engine, name, spy)

    def host_route(*_a, **_k):
        raise AssertionError("the port took a host count route")

    monkeypatch.setattr(port_native.NativeTile, "threshold_states_cpu",
                        host_route)
    monkeypatch.setattr(port_counts, "modcall_counts_numpy", host_route)
    monkeypatch.setattr(port_engine, "modcall_counts_numpy", host_route,
                        raising=False)
    got = _tile_rows(port_engine, PortCaller, PortReader(route_bam),
                     port_collapse, kind)
    assert calls == {TILE_KINDS[kind][0]: 1}
    want = _tile_rows(ref_engine, RefCaller, RefReader(route_bam),
                      ref_collapse, kind)
    assert len(got) == len(want) > 0
    assert got.labels == want.labels
    for name in ROW_FIELDS:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_merge_shards_matches_modkit_tpu(tmp_path):
    # two processes, seven tiles, an empty tile and one larger than the
    # 1 MiB read chunk
    blocks = {
        0: [b"t0\n", b"", b"x" * (3 << 20) + b"\n", b"t6\n"],
        1: [b"t1\n", b"t3\n", b"t5\n"],
    }
    merged = []
    for pkg in (ref_devices, port_devices):
        out = str(tmp_path / f"{pkg.__name__}.bed")
        for pidx, bs in blocks.items():
            with open(pkg.shard_path(out, pidx), "wb") as fh:
                for b in bs:
                    fh.write(b + pkg._TILE_SENTINEL)
        pkg.merge_shards(out, 2)
        with open(out, "rb") as fh:
            merged.append(fh.read())
    assert merged[0] == merged[1]
    assert merged[1].startswith(b"t0\nt1\nt3\nxxx")


def test_process_info_of_a_single_process_matches_modkit_tpu(monkeypatch):
    monkeypatch.delenv("MODKIT_TPU_COORD", raising=False)
    assert port_devices.process_info() == ref_devices.process_info() == (0, 1)


def test_process_info_and_sync_need_a_process_group(monkeypatch):
    monkeypatch.setenv("MODKIT_TPU_COORD", "localhost:1234")
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        port_devices.process_info()
    with pytest.raises(RuntimeError, match="modkit_extract_shards"):
        port_devices.sync_processes("modkit_extract_shards")


def test_process_info_and_sync_over_a_gloo_group(monkeypatch):
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        monkeypatch.setenv("MODKIT_TPU_COORD", f"localhost:{port}")
        assert port_devices.process_info() == (0, 1)
        port_devices.sync_processes("modkit_dmr_single_site_shards")
    finally:
        dist.destroy_process_group()
