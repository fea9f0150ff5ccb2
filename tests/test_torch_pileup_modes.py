"""modkit_tpu_torch's pileup is byte-equal to modkit_tpu's: motif, preset,
partition, bedgraph, region and engine-route modes.

The same construction as test_torch_pileup.py (a 300-read x 2 kb synthetic
modBAM with its FASTA, both packages run, every output file compared with
``cmp``); split off so the test workers share the load.
"""

import numpy as np
import pytest

import modkit_tpu.native as ref_native
from modkit_tpu.io.bam import BamReader, BamWriter, build_bai
from modkit_tpu.utils.synth import make_synthetic_modbam
from modkit_tpu_torch.pileup import engine as port_engine
from test_torch_pileup import op_calls, run_both  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pileup_modes")
    bam, fa = str(d / "s.bam"), str(d / "s.fa")
    make_synthetic_modbam(
        bam, n_reads=300, read_len=2000, coverage=20.0, seed=12, fasta_out=fa
    )
    # a copy whose reads carry an HP:i tag (1 or 2) for --partition-tag
    tagged = str(d / "hp.bam")
    reader = BamReader(bam)
    with BamWriter(tagged, reader.header) as w:
        for i, rec in enumerate(reader.records()):
            w.write_raw(rec.raw() + b"HPC" + bytes([1 + i % 2]))
    build_bai(tagged)
    return bam, fa, tagged


def test_cpg(tmp_path, synth, op_calls):
    kw = dict(no_filtering=True, cpg=True, reference_fasta=synth[1])
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls.get("threshold_state_quals_t")


def test_cpg_combine_strands(tmp_path, synth, op_calls):
    kw = dict(filter_threshold={"default": 0.6}, cpg=True,
              combine_strands=True, reference_fasta=synth[1])
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls.get("threshold_state_quals_t")


def test_preset_traditional(tmp_path, synth, op_calls):
    kw = dict(no_filtering=True, preset="traditional",
              reference_fasta=synth[1])
    run_both(tmp_path, synth[0], kw, kw)
    # the preset collapses 5hmC: probabilities leave the u8 encoding
    assert op_calls.get("threshold_state_f32")


MOTIF_MODES = {
    # focus positions with two motif ids, so rows read "code,motif"
    "motifs": dict(motifs=["CG", "0", "CGCG", "0", "GATC", "1"]),
    "non_palindrome": dict(motifs=["CHG", "0"]),
    "include_bed": dict(),
    "cpg_combine_mods": dict(cpg=True, combine_mods=True),
    "traditional_mixed_delimiters": dict(preset="traditional",
                                         mixed_delimiters=True),
}


@pytest.mark.parametrize("mode", sorted(MOTIF_MODES))
def test_motif_route_modes(tmp_path, synth, op_calls, mode):
    """The motif route's rows: labels, strands, the include-bed focus,
    combined codes and the writer's delimiters."""
    kw = dict(no_filtering=True, reference_fasta=synth[1], **MOTIF_MODES[mode])
    if mode == "include_bed":
        bed = tmp_path / "focus.bed"
        bed.write_text(
            "synth1\t100\t6000\t.\t0\t+\n"
            "synth1\t8000\t15000\t.\t0\t-\n"
            "synth1\t17000\t24000\t.\t0\t.\n"
            "synth1\t26000\t29000\n"
        )
        kw["include_bed"] = str(bed)
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls


def test_partition_tags(tmp_path, synth, op_calls):
    kw = dict(no_filtering=True, partition_tags=["HP"])
    names = run_both(tmp_path, synth[2], kw, kw, out_is_dir=True)
    assert names == ["1.bed", "2.bed"]
    assert op_calls.get("threshold_state_quals_t")


def test_bedgraph(tmp_path, synth, op_calls):
    kw = dict(filter_threshold={"default": 0.6}, bedgraph=True)
    names = run_both(tmp_path, synth[0], kw, kw, out_is_dir=True)
    assert names == ["h_positive.bedgraph", "m_positive.bedgraph"]
    assert op_calls.get("threshold_state_quals_t")


def test_region(tmp_path, synth, op_calls):
    kw = dict(no_filtering=True, region="synth1:5000-20000",
              interval_size=4000)
    run_both(tmp_path, synth[0], kw, kw)
    assert op_calls.get("threshold_state_quals_t")


def test_python_event_route_takes_the_count_path(
    tmp_path, synth, op_calls, monkeypatch
):
    """With the native decoder off (use_native=False in the engine, here
    through MODKIT_TPU_DISABLE_NATIVE) both packages take the Python event
    route and its fused call + count."""
    monkeypatch.setenv("MODKIT_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setattr(ref_native, "_lib", None)  # the reference caches it
    kw = dict(filter_threshold={"default": 0.6}, region="synth1:0-12000")
    run_both(tmp_path, synth[0], kw, kw)
    assert set(op_calls) == {"modcall_counts"}


def test_port_equals_modkit_tpu_host_numpy_route(tmp_path, synth, op_calls):
    """modkit_tpu's host numpy route (its ``use_device=False``) against the
    port's one route: kernel A's quals entry, through its plain version."""
    kw = dict(filter_threshold={"default": 0.6})
    run_both(tmp_path, synth[0], dict(kw, use_device=False), kw)
    assert set(op_calls) == {"threshold_state_quals_t"}


def test_engine_use_native_false_option(synth):
    """PileupOptions.use_native=False routes a tile through the Python event
    path and the count op, with the same rows as the native route."""
    from modkit_tpu_torch.caller import ThresholdCaller
    from modkit_tpu_torch.io.bam import BamReader as PortReader

    reader = PortReader(synth[0])
    rows = []
    for use_native in (True, False):
        proc = port_engine.TileProcessor(
            ThresholdCaller({}, {}, 0.6),
            port_engine.PileupOptions(use_native=use_native, device="cpu"),
        )
        rows.append(proc.finish_tile(proc.launch_tile(reader, 0, 0, 8000)))
    nat, py = rows
    assert len(nat) == len(py) > 0
    for name in ("pos", "strand", "code_idx", "valid", "n_mod", "n_can",
                 "n_other", "n_del", "n_filt", "n_diff", "n_nocall"):
        assert np.array_equal(getattr(nat, name), getattr(py, name)), name
