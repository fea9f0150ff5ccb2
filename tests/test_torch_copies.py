"""The port's copies of modkit_tpu's jax-free modules stay byte-equal.

``modkit_tpu_torch`` imports nothing of ``modkit_tpu``: each jax-free
module it needs is its own copy, at the same path under the package. Each
copy here must equal its original byte for byte; the modules that share a
path with an original but are ports of it, not copies, are named with the
reason they differ. A module of the port that has an original and is in
neither list fails the last test, so a new copy cannot go unchecked.
"""

import filecmp
import hashlib
import os

import pytest

from modkit_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "modkit_tpu_torch")
ORIGINAL = os.path.join(REPO, "modkit_tpu")

COPIES = (
    "__main__.py",
    "bedmethyl.py",
    "caller.py",
    "charts.py",
    "cpu_baseline.py",
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
    "thresholds.py": "every estimate's percentile sorts on the host, "
                     "whatever MODKIT_TPU_OFFLOAD says (no jitted "
                     "jnp.sort under always); the native sample drops its "
                     "blocks' pages from the reader's map",
    "ops/__init__.py": "the docstring names the CUDA kernels",
    "parallel/__init__.py": "the docstring: devices, a grid of torch "
                            "devices and a process group, not a jax Mesh",
    "parallel/devices.py": "torch devices, the device rule and no offload "
                           "policy (the run's device does every tile's "
                           "call and count); a gloo torch.distributed "
                           "process group for multi-host runs "
                           "(maybe_init_distributed, process_info, "
                           "sync_processes) instead of jax.distributed",
    "parallel/sharded_pileup.py": "a [tiles, readers] grid of torch devices "
                                  "driven by one process instead of a jax "
                                  "Mesh and shard_map; the readers' psum "
                                  "is an int32 sum on the tile's first "
                                  "device",
    "pileup/engine.py": "the kernels' wrappers, CUDA streams and pinned "
                        "copies instead of jitted calls; one count route "
                        "per tile kind, on the run's device (no "
                        "use_device, no host threshold or numpy count); a "
                        "decoded tile's blocks leave the reader's map; "
                        "with a focus or combined strands, bedMethyl rows "
                        "decode column-wise over the focus positions only",
    "pileup/runner.py": "the run's device (no use_device), "
                        "torch.profiler; the shard barrier is "
                        "sync_processes, not jax's; the tile workers share "
                        "the run's reader",
    "writers.py": "BedMethylWriter.write_columnar renders the motif "
                  "route's columns too: motif labels and strand '.'",
}


# files of the port that are copies of a file outside modkit_tpu, with the
# original and the reason they differ
NATIVE_PORTS = {
    "csrc/modkit_native.cpp": (
        "native/modkit_native.cpp",
        "the tile decode (mk_decode_tile) walks each read's alignment as "
        "CIGAR runs clipped to the tile and its focus, counts no-calls and "
        "deletions straight into per-thread tile histograms, and reports "
        "aligned_columns and walked_columns; its output equals the "
        "original's (tests/test_torch_decode_walk.py); mk_decode_tile_bgzf "
        "takes a cache of inflated BGZF blocks that a run's tiles share "
        "and counts the blocks it served (tests/test_torch_block_cache.py); "
        "it has no "
        "mk_bench_event_rate, the host counting-rate probe of the offload "
        "policy the port does not have",
    ),
}


@pytest.mark.parametrize("rel", list(NATIVE_PORTS))
def test_native_port_differs_from_its_original(rel):
    original, _why = NATIVE_PORTS[rel]
    assert os.path.exists(os.path.join(REPO, original))
    assert not filecmp.cmp(os.path.join(PORT, rel), os.path.join(REPO, original),
                           shallow=False)


def test_native_runtime_builds_from_the_ports_copy():
    """The port's library is built from csrc/modkit_native.cpp: its file
    name carries the hash of that source (sobuild.build_once), not of
    native/modkit_native.cpp, which the JAX package keeps loading."""
    copy = os.path.join(PORT, "csrc", "modkit_native.cpp")
    assert os.path.samefile(native._SRC, copy)
    lib = native.load()
    assert lib is not None

    def built_name(src):
        with open(src, "rb") as fh:
            h = hashlib.sha256(fh.read())
        h.update("\0".join([os.environ.get("CXX", "g++"), *native._CXX_FLAGS,
                            repr(native._LINK_CHOICES)]).encode())
        return f"libmodkit_native-{h.hexdigest()[:16]}.so"

    assert os.path.basename(lib._name) == built_name(copy)
    assert built_name(copy) != built_name(os.path.join(REPO, "native", "modkit_native.cpp"))


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
