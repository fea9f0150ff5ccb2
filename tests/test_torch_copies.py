"""The port's copies of modkit_tpu's jax-free modules stay byte-equal.

``modkit_tpu_torch`` imports nothing of ``modkit_tpu``: each jax-free
module it needs is its own copy, at the same path under the package. Each
copy here must equal its original byte for byte; the modules that share a
path with an original but are ports of it, not copies, are named with the
reason they differ. A module of the port that has an original and is in
neither list fails the last test, so a new copy cannot go unchecked.
"""

import filecmp
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "modkit_tpu_torch")
ORIGINAL = os.path.join(REPO, "modkit_tpu")

COPIES = (
    "__main__.py",
    "bedmethyl.py",
    "caller.py",
    "charts.py",
    "collapse.py",
    "errors.py",
    "genome_positions.py",
    "hmm.py",
    "logging.py",
    "modcodes.py",
    "modtags.py",
    "motifs.py",
    "position_filter.py",
    "summary.py",
    "writers.py",
    "engines/__init__.py",
    "engines/adjust.py",
    "engines/bedmethyl_tools.py",
    "engines/dmr.py",
    "engines/find_motifs.py",
    "engines/modbam_util.py",
    "engines/motif_bed.py",
    "engines/pileup_hemi.py",
    "engines/repair.py",
    "engines/validate.py",
    "io/__init__.py",
    "io/bam.py",
    "io/bgzf.py",
    "io/bigwig.py",
    "io/cram.py",
    "io/fasta.py",
    "io/tabix.py",
    "ops/beta_diff.py",
    "ops/llk.py",
    "pileup/__init__.py",
    "pileup/events.py",
    "utils/synth.py",
)

# same path as an original, but a port of it
PORTS = {
    "__init__.py": "the package docstring names the port",
    "cli.py": "pileup takes --device; the docstring names the port",
    "engines/dmr_single_site.py": "the shard barrier is a torch.distributed "
                                  "barrier (sync_processes), not jax's",
    "engines/entropy.py": "the shard barrier is a torch.distributed "
                          "barrier (sync_processes), not jax's",
    "engines/extract.py": "the shard barrier is a torch.distributed "
                          "barrier (sync_processes), not jax's",
    "thresholds.py": "the forced-device percentile sorts with torch.sort "
                     "on the run's device instead of a jitted jnp.sort",
    "ops/__init__.py": "the docstring names the CUDA kernels",
    "parallel/__init__.py": "the docstring: devices, a grid of torch "
                            "devices and a process group, not a jax Mesh",
    "parallel/devices.py": "torch devices, the device rule; a gloo "
                           "torch.distributed process group for multi-host "
                           "runs (maybe_init_distributed, process_info, "
                           "sync_processes) instead of jax.distributed",
    "parallel/sharded_pileup.py": "a [tiles, readers] grid of torch devices "
                                  "driven by one process instead of a jax "
                                  "Mesh and shard_map; the readers' psum "
                                  "is an int32 sum on the tile's first "
                                  "device",
    "pileup/engine.py": "the kernels' wrappers, CUDA streams and pinned "
                        "copies instead of jitted calls",
    "pileup/runner.py": "the run's device, torch.profiler; the shard "
                        "barrier is sync_processes, not jax's",
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original(rel):
    assert filecmp.cmp(os.path.join(PORT, rel), os.path.join(ORIGINAL, rel),
                       shallow=False), f"{rel} differs from modkit_tpu/{rel}"


def test_every_module_with_an_original_is_listed():
    found = set()
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), PORT)
            if os.path.exists(os.path.join(ORIGINAL, rel)):
                found.add(rel.replace(os.sep, "/"))
    assert found == set(COPIES) | set(PORTS)
    assert not set(COPIES) & set(PORTS)
