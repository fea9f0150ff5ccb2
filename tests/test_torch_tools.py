"""The port's measuring tools on the CPU: ``tools/bench.py``,
``tools/scale_bench.py`` and ``tools/multichip_model.py`` of
``modkit_tpu_torch`` at a tiny size under ``--device cpu``.

Each prints (or writes to ``--out``) the JSON of its original
(``bench.py``, ``tools/scale_bench.py``, ``tools/multichip_model.py``, read
here with ``ast``) with every key of it but those the port has no
counterpart of; the bench's byte-equality checks hold; without a CUDA
device a run that did not ask for the CPU raises; and no run writes the
repository's ``BENCH_SCALE_r05.json`` or ``MULTICHIP_MODEL.json``, which the
originals overwrite.
"""

import ast
import json
import os

import pytest
import torch

from modkit_tpu_torch.tools import bench, multichip_model, scale_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# keys of bench.py's JSON, and of the port's own earlier JSON, that the
# port's bench does not write (the reasons are in the docstring of
# modkit_tpu_torch/tools/bench.py): the TPU's fetch round trip and MXU
# ceiling, and the offload policy's second pileup route and host probe
BENCH_DROPPED = {"fetch_round_trip_ms", "matmul_pct_of_int8_mxu_ceiling",
                 "device_forced_wall_s", "device_forced_reads_per_s",
                 "host_event_rate_Meps", "auto_route", "auto_state_launches",
                 "forced_state_launches"}


def _json_keys(path: str, func: str) -> set:
    """String keys of the dict literals in what ``func`` of ``path`` hands
    to ``json.dump``/``json.dumps``, or of the dict it assigns to ``out``
    before."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    body = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == func)
    roots = [c.args[0] for c in ast.walk(body) if isinstance(c, ast.Call)
             and getattr(c.func, "attr", "") in ("dump", "dumps")]
    roots += [a.value for a in ast.walk(body) if isinstance(a, ast.Assign)
              and getattr(a.targets[0], "id", "") == "out"]
    return {k.value for r in roots for d in ast.walk(r)
            if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}


def _repo_outputs() -> dict:
    out = {}
    for name in ("BENCH_SCALE_r05.json", "MULTICHIP_MODEL.json"):
        with open(os.path.join(REPO, name), "rb") as fh:
            out[name] = fh.read()
    return out


@pytest.fixture
def tiny(monkeypatch):
    for key, val in (("MODKIT_BENCH_READS", "400"),
                     ("MODKIT_BENCH_READ_LEN", "2000"),
                     ("MODKIT_BENCH_ENTROPY_READS", "150"),
                     ("MODKIT_BENCH_REPS", "1"),
                     ("SCALE_READS", "400"), ("SCALE_READ_LEN", "2000"),
                     ("MC_READS", "1200")):
        monkeypatch.setenv(key, val)
    before = _repo_outputs()
    yield
    assert _repo_outputs() == before


def test_bench_on_the_cpu_keeps_the_originals_keys(tiny, capsys):
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    extra = got["extra"]
    want = _json_keys("bench.py", "main") - BENCH_DROPPED
    assert want <= set(got) | set(extra)
    assert not BENCH_DROPPED & (set(got) | set(extra))
    assert got["metric"] == "pileup_reads_per_s" and got["value"] > 0
    assert extra["kernel_roofline"] is None
    assert extra["device"] == "cpu" and extra["card"] is None
    assert extra["state_launches"] == 0
    assert extra["link_bandwidth_MBps"] is None
    for key, val in extra.items():
        if key.endswith("_identical") or "_equal" in key:
            assert val is True, key
    # the environment the run changed is restored
    assert "MODKIT_TPU_ENTROPY_BASELINE" not in os.environ


def test_scale_bench_on_the_cpu_writes_only_where_asked(tiny, tmp_path,
                                                        capsys):
    out = tmp_path / "scale.json"
    assert scale_bench.main(["--device", "cpu", "--out", str(out)]) == 0
    assert capsys.readouterr().out == ""
    got = json.loads(out.read_text())
    want = _json_keys("tools/scale_bench.py", "main")
    assert want <= set(got) | set(got["config"])
    assert got["config"]["n_reads"] == 400 and got["reads_per_s"] > 0
    assert got["peak_rss_mb"] > 0
    # host memory: VmRSS after each stage; the peaks of the synthesis and
    # of each pileup, with the BAM's mapped pages (the synthesis maps it
    # to index it; the pileups drop each block once read); no pinned stats
    # off a card
    stages = ["imports", "device", "kernels", "synthesis", "default",
              "journal"]
    assert list(got["rss_mb"]) == stages
    assert all(got["rss_mb"][k] > 0 for k in stages)
    assert max(got["rss_mb"].values()) <= got["peak_rss_mb"]
    assert list(got["phase_peak_mb"]) == ["synthesis", "default", "journal"]
    for peak in got["phase_peak_mb"].values():
        assert 0 <= peak["bam"] < peak["rss"] <= got["peak_rss_mb"]
    assert got["pinned_host_memory"] is None


def test_multichip_model_on_the_cpu(tiny, capsys):
    assert multichip_model.main(["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = {"host_feed_curve", "virtual_mesh_wall_s", "note"}
    assert want <= set(got)
    assert set(got["host_feed_curve"]) == {"1", "2"}
    assert set(got["virtual_mesh_wall_s"]) == {"1", "2", "4", "8"}
    assert got["virtual_mesh_devices"]["8"] == ["cpu"] * 8
    # every N's bedMethyl was byte-equal to N = 1's, or the run raised
    assert got["outputs_identical"] is True


def test_multichip_device_lists_use_real_cards_first(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    lists = multichip_model.device_lists(torch.device("cuda"))
    assert [str(d) for d in lists[4]] == ["cuda:0", "cuda:1", "cuda:0",
                                         "cuda:1"]
    assert lists[1] == [torch.device("cuda", 0)]


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a CUDA device")
@pytest.mark.parametrize("tool", [bench, scale_bench, multichip_model])
def test_tools_raise_without_a_card(tool, monkeypatch):
    monkeypatch.setenv("MODKIT_BENCH_READS", "10")
    before = _repo_outputs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
    assert _repo_outputs() == before
