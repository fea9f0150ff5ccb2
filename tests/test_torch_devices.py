"""modkit_tpu_torch.parallel.devices against modkit_tpu.parallel.devices.

The port keeps modkit_tpu's offload rule (one MODKIT_TPU_OFFLOAD and
MODKIT_TPU_HOST_EVENT_RATE setting drives both packages) and its shard
merge; device selection follows the port's device rule. Every comparison
is exact (``==`` on decisions, bytes on merged files).
"""

import pytest
import torch

import modkit_tpu.parallel.devices as ref_devices
import modkit_tpu_torch.parallel.devices as port_devices


def test_cpu_device_is_one_cpu():
    assert port_devices.compute_devices("cpu") == [torch.device("cpu")]
    assert port_devices.link_bandwidth_bytes_per_s("cpu") == float("inf")


def test_unknown_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        port_devices.resolve_device("meta")


@pytest.mark.parametrize("mode", ["always", "never", "auto"])
@pytest.mark.parametrize("n_events", [1, 600_000])
@pytest.mark.parametrize("link", [5e7, 2e10])
def test_offload_rule_matches_modkit_tpu(monkeypatch, mode, n_events, link):
    monkeypatch.setenv("MODKIT_TPU_OFFLOAD", mode)
    monkeypatch.setenv("MODKIT_TPU_HOST_EVENT_RATE", "3e7")
    monkeypatch.setattr(ref_devices, "link_bandwidth_bytes_per_s",
                        lambda: link)
    monkeypatch.setattr(port_devices, "link_bandwidth_bytes_per_s",
                        lambda dev: link)
    assert port_devices.host_event_rate() == ref_devices.host_event_rate()
    assert port_devices.offload_events_to_device(
        n_events, 5.0, torch.device("cpu")
    ) == ref_devices.offload_events_to_device(n_events, 5.0)


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
