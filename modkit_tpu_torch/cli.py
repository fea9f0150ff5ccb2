"""Command-line interface of the port: ``python -m modkit_tpu_torch <cmd>``.

The subcommands of modkit_tpu's CLI (cli.py) that the port has, with
modkit_tpu's flags: ``pileup`` (BAM or CRAM; ``--device`` chooses the
run's device, ``cuda`` by default), ``summary``, ``sample-probs``,
``adjust-mods``, ``call-mods``, ``update-tags``, ``extract full``/``calls``,
``validate``, ``pileup-hemi``, ``dmr pair``/``multi``, ``stats``,
``localize``, ``bedmethyl merge``/``tobigwig``, ``repair``, ``modbam
check-tags``/``sample-reads``, ``entropy``, ``motif search``/``refine``/
``evaluate``/``bed`` and ``find-motifs``: every subcommand of modkit_tpu.
Only ``pileup`` runs its counting on the device; the others run on the
host, as in modkit_tpu, so they need no card. Every threshold estimate,
pileup's included, sorts its confidences on the host.
"""

from __future__ import annotations

import argparse
import sys


def _add_common_sampling(p):
    # `--sample-num-reads` is extract's long name for -n in the reference
    # (extract/subcommand.rs:426); accept it everywhere as an alias.
    p.add_argument("-n", "--num-reads", "--sample-num-reads",
                   dest="num_reads", type=int, default=10042)
    p.add_argument("-f", "--sampling-frac", "--sample-frac",
                   dest="sampling_frac", type=float, default=None)
    p.add_argument("--no-sampling", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--sampling-interval-size", type=int, default=1_000_000
    )


def _add_threshold_args(p):
    p.add_argument("-p", "--filter-percentile", type=float, default=0.1)
    p.add_argument("--filter-threshold", action="append", default=None)
    p.add_argument("--mod-thresholds", action="append", default=None)
    p.add_argument("--no-filtering", action="store_true")


def _add_logging(p):
    p.add_argument("--log-filepath", default=None)
    p.add_argument("--suppress-progress", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=4)


def parse_filter_thresholds(raw_list):
    """--filter-threshold [A:0.8 | 0.75] repeated (command_utils.rs:17)."""
    if not raw_list:
        return None
    out = {}
    for raw in raw_list:
        if ":" in raw:
            base, v = raw.split(":", 1)
            if base not in "ACGT" or len(base) != 1:
                raise SystemExit(f"invalid per-base threshold {raw!r}")
            out[base] = float(v)
        else:
            out["default"] = float(raw)
    return out


def parse_mod_thresholds(raw_list):
    if not raw_list:
        return None
    from .modcodes import parse_mod_code

    out = {}
    for raw in raw_list:
        if ":" not in raw:
            raise SystemExit(f"invalid mod threshold {raw!r}, use code:value")
        code, v = raw.rsplit(":", 1)
        out[parse_mod_code(code)] = float(v)
    return out


def parse_edge_filter(raw: str, invert: bool):
    from .pileup.events import EdgeFilter

    if "," in raw:
        a, b = raw.split(",")
        return EdgeFilter(int(a), int(b), invert)
    return EdgeFilter(int(raw), int(raw), invert)




def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="modkit-tpu-torch",
        description="PyTorch/CUDA port of modkit_tpu: modBAM -> bedMethyl "
        "pileup on an NVIDIA GPU, and the modBAM tools",
    )
    from . import __version__

    ap.add_argument(
        "-V", "--version", action="version",
        version=f"mod_kit-tpu-torch {__version__}",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    # ---- pileup ----
    p = sub.add_parser("pileup", help="modBAM -> per-position bedMethyl table")
    p.add_argument("in_bam")
    p.add_argument("out_bed")
    p.add_argument("-i", "--interval-size", type=int, default=100_000)
    p.add_argument("--journal", default=None,
                   help="per-tile completion journal enabling resume")
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=8000)
    p.add_argument("--region", default=None)
    p.add_argument("--sample-region", default=None,
                   help="region to sample reads from for threshold estimation")
    p.add_argument("--include-bed", "--include-positions", dest="include_bed", default=None)
    p.add_argument("--include-unmapped", action="store_true")
    p.add_argument("--ignore", default=None)
    p.add_argument("--combine-mods", action="store_true")
    p.add_argument("--combine-strands", action="store_true")
    p.add_argument("--cpg", action="store_true")
    p.add_argument("--motif", nargs=2, action="append", default=None)
    p.add_argument("--preset", choices=["traditional"], default=None)
    p.add_argument("-r", "--ref", "--reference-fasta", dest="reference_fasta", default=None)
    p.add_argument("--edge-filter", default=None)
    p.add_argument("--invert-edge-filter", action="store_true")
    p.add_argument("--force-allow-implicit", action="store_true")
    p.add_argument("--only-tabs", action="store_true")  # deprecated no-op
    p.add_argument("--mixed-delim", "--mixed-delimiters", dest="mixed_delimiters", action="store_true")
    p.add_argument("--bedgraph", action="store_true")
    p.add_argument("--prefix", default=None)
    p.add_argument("--partition-tag", action="append", default=None)
    p.add_argument("--header", "--with-header", dest="with_header", action="store_true")
    _add_common_sampling(p)
    _add_threshold_args(p)
    _add_logging(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the run (default: cuda)")
    p.set_defaults(func=cmd_pileup)

    # ---- summary ----
    p = sub.add_parser("summary", help="summarize mod calls in a modBAM")
    p.add_argument("in_bam")
    p.add_argument("--region", default=None)
    p.add_argument("--ignore", default=None)
    p.add_argument("--tsv", dest="tsv_format", action="store_true")
    p.add_argument("--table", dest="table_format", action="store_true")
    p.add_argument("--only-mapped", action="store_true")
    p.add_argument("--edge-filter", default=None)
    p.add_argument("--invert-edge-filter", action="store_true")
    p.add_argument("--include-bed", default=None)
    _add_common_sampling(p)
    _add_threshold_args(p)
    _add_logging(p)
    p.set_defaults(func=cmd_summary)

    # ---- sample-probs ----
    p = sub.add_parser(
        "sample-probs", help="percentiles of base-mod call probabilities"
    )
    p.add_argument("in_bam")
    p.add_argument("--region", default=None)
    p.add_argument("--percentiles", default="0.1,0.5,0.9")
    p.add_argument("-o", "--out-dir", default=None)
    p.add_argument("--prefix", default=None)
    p.add_argument("--force", action="store_true")
    p.add_argument("--hist", "--histogram", dest="histogram", action="store_true")
    p.add_argument("--dna-color", nargs=2, action="append", default=None,
                   help="BASE #RRGGBB histogram color override")
    p.add_argument("--mod-color", nargs=2, action="append", default=None,
                   help="CODE #RRGGBB histogram color override")
    p.add_argument("--ignore", default=None)
    p.add_argument("--edge-filter", default=None)
    p.add_argument("--invert-edge-filter", action="store_true")
    p.add_argument("--only-mapped", action="store_true")
    p.add_argument("--include-bed", default=None)
    _add_common_sampling(p)
    _add_logging(p)
    p.set_defaults(func=cmd_sample_probs)

    # ---- adjust-mods ----
    p = sub.add_parser(
        "adjust-mods", help="rewrite modBAM, collapsing/converting mod calls"
    )
    p.add_argument("in_bam")
    p.add_argument("out_bam")
    p.add_argument("--ignore", default=None)
    p.add_argument("--method", choices=["norm", "dist"], default="dist")
    p.add_argument("--convert", nargs=2, action="append", default=None)
    p.add_argument("--edge-filter", default=None)
    p.add_argument("--invert-edge-filter", action="store_true")
    p.add_argument("--motif", nargs=2, action="append", default=None)
    p.add_argument("--cpg", action="store_true")
    p.add_argument("--discard-motifs", action="store_true")
    p.add_argument("--ff", "--fail-fast", dest="fail_fast", action="store_true")
    p.add_argument("--filter-probs", action="store_true")
    p.add_argument("--sample-region", default=None)
    p.add_argument("--output-sam", action="store_true")
    _add_common_sampling(p)
    _add_threshold_args(p)
    _add_logging(p)
    p.set_defaults(func=cmd_adjust_mods, call_mode=False)

    # ---- call-mods ----
    p = sub.add_parser(
        "call-mods", help="rewrite modBAM with thresholded (hard) calls"
    )
    p.add_argument("in_bam")
    p.add_argument("out_bam")
    p.add_argument("--mod-threshold", dest="mod_thresholds", action="append", default=None)
    p.add_argument("--edge-filter", default=None)
    p.add_argument("--invert-edge-filter", action="store_true")
    p.add_argument("--include-unmapped", action="store_true")
    p.add_argument("--ff", "--fail-fast", dest="fail_fast", action="store_true")
    p.add_argument("--output-sam", action="store_true")
    p.add_argument("-p", "--filter-percentile", type=float, default=0.1)
    p.add_argument("--filter-threshold", action="append", default=None)
    p.add_argument("--no-filtering", action="store_true")
    p.add_argument("--sample-region", default=None)
    _add_common_sampling(p)
    _add_logging(p)
    p.set_defaults(func=cmd_call_mods)

    # ---- update-tags ----
    p = sub.add_parser("update-tags", help="update MM/ML tag styles and modes")
    p.add_argument("in_bam")
    p.add_argument("out_bam")
    p.add_argument("--mode", choices=["explicit", "implicit", "ambiguous"], default=None)
    p.add_argument("--no-implicit-probs", action="store_true")
    p.add_argument("--output-sam", action="store_true")
    _add_logging(p)
    p.set_defaults(func=cmd_update_tags)

    # ---- extract ----
    p = sub.add_parser("extract", help="read-level table of mod calls")
    esub = p.add_subparsers(dest="extract_mode", required=True)
    for mode in ("full", "calls"):
        q = esub.add_parser(mode)
        q.add_argument("in_bam")
        q.add_argument("out_path")
        q.add_argument("-i", "--interval-size", type=int, default=100_000)
        q.add_argument("--ref", "--reference", dest="reference_fasta", default=None)
        q.add_argument("--force", action="store_true")
        q.add_argument("--ignore", default=None)
        q.add_argument("--mapped-only", action="store_true")
        q.add_argument("--allow-non-primary", action="store_true")
        q.add_argument("--region", default=None)
        q.add_argument("--kmer-size", type=int, default=5)
        q.add_argument("--edge-filter", default=None)
        q.add_argument("--invert-edge-filter", action="store_true")
        q.add_argument("--no-headers", action="store_true")
        q.add_argument("--include-bed", "--include-positions",
                       dest="include_bed", default=None)
        q.add_argument("-v", "--exclude-bed", dest="exclude_bed",
                       default=None)
        q.add_argument("--motif", nargs=2, action="append", default=None)
        q.add_argument("--cpg", action="store_true")
        q.add_argument("--bgzf", action="store_true",
                       help="compress output with parallel bgzf")
        q.add_argument("--out-threads", type=int, default=4,
                       help="threads for parallel bgzf writing")
        q.add_argument("-q", "--queue-size", type=int, default=1000)
        q.add_argument("--ignore-implicit", action="store_true",
                       help="omit implicit (inferred) canonical calls")
        _add_common_sampling(q)
        _add_logging(q)
        if mode == "calls":
            q.add_argument("--pass-only", action="store_true")
            q.add_argument("--mod-threshold", dest="mod_thresholds", action="append", default=None)
            _add_threshold_args(q)
        q.set_defaults(func=cmd_extract, extract_mode=mode)

    # ---- dmr pair/multi (dmr/subcommands.rs:29-55) ----
    p = sub.add_parser("dmr", help="differential methylation scoring")
    dsub = p.add_subparsers(dest="dmr_mode", required=True)
    q = dsub.add_parser("pair", help="compare a pair of samples")
    q.add_argument("-a", action="append", default=[], dest="a")
    q.add_argument("-b", action="append", default=[], dest="b")
    q.add_argument("--index-a", action="append", default=[], dest="index_a",
                   help="explicit tabix index for the -a bedMethyl(s)")
    q.add_argument("--index-b", action="append", default=[], dest="index_b",
                   help="explicit tabix index for the -b bedMethyl(s)")
    q.add_argument("-o", "--out-path", default=None)
    q.add_argument("--header", "--with-header", action="store_true")
    q.add_argument("-r", "--regions", "--regions-bed", default=None,
                   dest="regions")
    q.add_argument("--ref", required=True)
    q.add_argument("--segment", default=None, dest="segment")
    q.add_argument("--max-gap-size", type=int, default=5000)
    q.add_argument("--dmr-prior", type=float, default=0.1)
    q.add_argument("--diff-stay", type=float, default=0.9)
    q.add_argument("--significance-factor", type=float, default=0.01)
    q.add_argument("--log-transition-decay", action="store_true")
    q.add_argument("--decay-distance", type=int, default=500)
    q.add_argument("--fine-grained", action="store_true")
    q.add_argument("-m", "--base", "--modified-bases", action="append",
                   default=[], dest="base")
    q.add_argument("--assign-code", action="append", default=None)
    q.add_argument("--log-filepath", "--log", default=None)
    q.add_argument("-t", "--threads", type=int, default=4)
    q.add_argument("--io-threads", type=int, default=4)
    q.add_argument("--batch-size", "--batch", type=int, default=None)
    q.add_argument("-k", "--mask", action="store_true")
    q.add_argument("--suppress-progress", action="store_true")
    q.add_argument("-f", "--force", action="store_true")
    q.add_argument("--missing", choices=["quiet", "warn", "fail"],
                   default="warn")
    q.add_argument("--min-valid-coverage", "--min-coverage", type=int,
                   default=0)
    q.add_argument("--prior", nargs=2, type=float, default=None)
    q.add_argument("--delta", type=float, default=0.05)
    q.add_argument("-N", "--n-sample-records", type=int, default=10_042)
    q.add_argument("--max-coverages", nargs=2, type=int, default=None)
    q.add_argument("--cap-coverages", action="store_true")
    q.add_argument("-i", "--interval-size", type=int, default=100_000)
    q.set_defaults(func=cmd_dmr_pair, command_name="dmr pair")
    q = dsub.add_parser("multi", help="compare all pairs of samples")
    q.add_argument("-s", "--sample", nargs=2, action="extend", default=[])
    q.add_argument("-r", "--regions", "--regions-bed", required=True,
                   dest="regions")
    q.add_argument("--header", "--with-header", action="store_true")
    q.add_argument("-o", "--out-dir", required=True)
    q.add_argument("-p", "--prefix", default=None)
    q.add_argument("--ref", required=True)
    q.add_argument("-m", "--base", "--modified-bases", action="append",
                   default=[], dest="base")
    q.add_argument("--assign-code", action="append", default=None)
    q.add_argument("--log-filepath", "--log", default=None)
    q.add_argument("-t", "--threads", type=int, default=4)
    q.add_argument("--io-threads", type=int, default=4)
    q.add_argument("-k", "--mask", action="store_true")
    q.add_argument("--suppress-progress", action="store_true")
    q.add_argument("-f", "--force", action="store_true")
    q.add_argument("--missing", choices=["quiet", "warn", "fail"],
                   default="warn")
    q.add_argument("--min-valid-coverage", "--min-coverage", type=int,
                   default=0)
    q.set_defaults(func=cmd_dmr_multi, command_name="dmr multi")

    # ---- stats (stats/subcommand.rs:25-66) ----
    p = sub.add_parser("stats", help="per-region methylation statistics")
    p.add_argument("in_bedmethyl")
    p.add_argument("--regions", required=True)
    p.add_argument("-c", "--mod-codes", "--codes", action="extend",
                   type=lambda s: s.split(","), default=None)
    p.add_argument("-m", "--min-coverage", "--min-cov", type=int, default=1)
    p.add_argument("-o", "--out-table", "--out", required=True)
    p.add_argument("--force", action="store_true")
    p.add_argument("--no-header", action="store_true")
    p.add_argument("--log-filepath", "--log", default=None)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--io-threads", type=int, default=2)
    p.set_defaults(func=cmd_stats, command_name="stats")

    # ---- localize (localise/subcommand.rs:27-104) ----
    p = sub.add_parser(
        "localize", aliases=["localise"],
        help="aggregate methylation around features",
    )
    p.add_argument("in_bedmethyl")
    p.add_argument("--regions", required=True)
    p.add_argument("--chart", default=None, dest="chart_filepath")
    p.add_argument("--name", default=None, dest="chart_name")
    p.add_argument("-w", "--window", type=int, default=2000)
    p.add_argument("-s", "--stranded", choices=["same", "opposite"],
                   default=None)
    p.add_argument("--stranded-features", choices=["+", "-", "."],
                   default=None)
    p.add_argument("--min-coverage", type=int, default=3)
    p.add_argument("-r", "--genome-sizes", required=True)
    p.add_argument("-o", "--out-file", default=None)
    p.add_argument("--log-filepath", "--log", default=None)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--io-threads", type=int, default=2)
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--batch-size", type=int, default=500_000)
    p.set_defaults(func=cmd_localize, command_name="localize")

    # ---- bedmethyl merge/tobigwig (bedmethyl_util/subcommands.rs) ----
    p = sub.add_parser("bedmethyl", help="bedMethyl utilities")
    bsub = p.add_subparsers(dest="bedmethyl_mode", required=True)
    q = bsub.add_parser("merge", help="merge N tabix bedMethyl files")
    q.add_argument("in_bedmethyl", nargs="+")
    q.add_argument("-o", "--out-bed", required=True)
    q.add_argument("-g", "--genome-sizes", required=True)
    q.add_argument("--force", action="store_true")
    q.add_argument("--chunk-size", type=int, default=None)
    q.add_argument("-i", "--interval-size", type=int, default=100_000)
    q.add_argument("--log-filepath", "--log", default=None)
    q.add_argument("-t", "--threads", type=int, default=4)
    q.add_argument("--queue-size", type=int, default=30)
    q.add_argument("--io-threads", type=int, default=2)
    q.set_defaults(func=cmd_bedmethyl_merge, command_name="bedmethyl merge")
    q = bsub.add_parser("tobigwig", help="bedMethyl -> bigWig track")
    q.add_argument("in_bedmethyl")
    q.add_argument("out_fp")
    q.add_argument("-g", "--sizes", required=True, dest="chromsizes")
    q.add_argument("-m", "--mod-codes", "--mod-code", action="extend",
                   type=lambda s: s.split(","), required=True)
    q.add_argument("--negative-strand-values", action="store_true")
    q.add_argument("-t", "--nthreads", type=int, default=6)
    q.add_argument("-z", "--nzooms", type=int, default=10)
    q.add_argument("--zooms", type=lambda s: [int(x) for x in s.split(",")],
                   default=None)
    q.add_argument("-u", "--uncompressed", action="store_true")
    q.add_argument("--block-size", type=int, default=256)
    q.add_argument("--items-per-slot", type=int, default=1024)
    q.add_argument("--inmemory", action="store_true")
    q.add_argument("--log-filepath", "--log", default=None)
    q.add_argument("--suppress-progress", action="store_true")
    q.set_defaults(
        func=cmd_bedmethyl_tobigwig, command_name="bedmethyl tobigwig"
    )

    # ---- entropy (entropy/subcommand.rs:28-181) ----
    p = sub.add_parser(
        "entropy", help="methylation entropy in sliding windows"
    )
    p.add_argument("-s", "--in-bam", action="append", required=True,
                   dest="in_bam")
    p.add_argument("-o", "--out-bed", default=None)
    p.add_argument("--prefix", default=None)
    p.add_argument("-n", "--num-positions", type=int, default=4)
    p.add_argument("-w", "--window-size", type=int, default=50)
    p.add_argument("--no-filtering", action="store_true")
    p.add_argument("--num-reads", type=int, default=10_042)
    p.add_argument("-p", "--filter-percentile", type=float, default=0.1)
    p.add_argument("--filter-threshold", "--pass_threshold", type=float,
                   default=None)
    p.add_argument("--mod-thresholds", "--mod-threshold", action="append",
                   default=None)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--io-threads", type=int, default=None)
    p.add_argument("--ref", "--reference", required=True)
    p.add_argument("--mask", action="store_true")
    p.add_argument("--motif", nargs=2, action="extend", default=None)
    p.add_argument("--cpg", action="store_true")
    p.add_argument("--base", action="append", default=None)
    p.add_argument("--regions", default=None)
    p.add_argument("--combine-strands", action="store_true")
    p.add_argument("--min-coverage", type=int, default=3,
                   dest="min_coverage")
    p.add_argument("--log-filepath", "--log", default=None)
    p.add_argument("--verbose-logging", action="store_true", dest="verbose")
    p.add_argument("--suppress-progress", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--header", "--with-header", action="store_true")
    p.add_argument("--drop-zeros", action="store_true")
    p.add_argument("--max-filtered-positions", type=int, default=None)
    p.set_defaults(func=cmd_entropy, command_name="entropy")

    # ---- validate (validate/subcommand.rs:797-889) ----
    p = sub.add_parser("validate", help="accuracy vs ground-truth BEDs")
    p.add_argument("--bam-and-bed", nargs=2, action="extend", default=[],
                   metavar=("BAM", "BED"))
    p.add_argument("--ignore", default=None)
    p.add_argument("--edge-filter", default=None)
    p.add_argument("--invert-edge-filter", action="store_true")
    p.add_argument("-c", "--canonical-base", default=None,
                   choices=["A", "C", "G", "T"])
    p.add_argument("--min-identity", type=float, default=None)
    p.add_argument("--min-length", type=int, default=None)
    p.add_argument("-p", "--filter-quantile", type=float, default=0.1)
    p.add_argument("--filter-threshold", "--pass_threshold", type=float,
                   default=None)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--suppress-progress", action="store_true")
    p.add_argument("-o", "--out-filepath", "--out", default=None)
    p.add_argument("--log-filepath", "--log", default=None)
    p.set_defaults(func=cmd_validate, command_name="validate")

    # ---- repair (repair_tags.rs:23-44) ----
    p = sub.add_parser(
        "repair", help="project mod tags from donor onto trimmed reads"
    )
    p.add_argument("-d", "--donor-bam", "--donor", required=True,
                   dest="donor")
    p.add_argument("-a", "--acceptor-bam", "--acceptor", required=True,
                   dest="acceptor")
    p.add_argument("-o", "--output-bam", "--output", required=True,
                   dest="output")
    p.add_argument("--log-filepath", default=None)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.set_defaults(func=cmd_repair, command_name="repair")

    # ---- pileup-hemi (pileup/subcommand.rs:827+) ----
    p = sub.add_parser(
        "pileup-hemi", help="double-stranded (hemi) pattern pileup"
    )
    p.add_argument("in_bam")
    p.add_argument("-o", "--out-bed", default=None)
    p.add_argument("--cpg", action="store_true")
    p.add_argument("--motif", nargs=2, default=None)
    p.add_argument("-r", "--ref", "--reference", required=True)
    p.add_argument("--region", default=None)
    p.add_argument("--sample-region", default=None)
    p.add_argument("--ignore", default=None)
    p.add_argument("--combine-mods", action="store_true")
    p.add_argument("--edge-filter", default=None)
    p.add_argument("--invert-edge-filter", action="store_true")
    p.add_argument("--force-allow-implicit", action="store_true")
    p.add_argument("-n", "--num-reads", type=int, default=10042)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("-p", "--filter-percentile", type=float, default=0.1)
    p.add_argument("--filter-threshold", action="append", default=None)
    p.add_argument("--mod-thresholds", "--mod-threshold", action="append",
                   default=None)
    p.add_argument("--no-filtering", action="store_true")
    p.add_argument("-i", "--interval-size", type=int, default=100_000)
    p.add_argument("--max-depth", type=int, default=8000)
    p.add_argument("--mixed-delim", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--log-filepath", "--log", default=None)
    p.add_argument("--suppress-progress", action="store_true")
    p.set_defaults(func=cmd_pileup_hemi, command_name="pileup-hemi")

    # ---- modbam check-tags (modbam_util/subcommands.rs:44-115) ----
    p = sub.add_parser(
        "modbam", aliases=["mb"], help="modBAM utilities"
    )
    msub = p.add_subparsers(dest="modbam_mode", required=True)
    q = msub.add_parser("check-tags", help="audit MM/ML tag validity")
    q.add_argument("in_bam")
    q.add_argument("--permissive", action="store_true")
    q.add_argument("-o", "--out-dir", default=None)
    q.add_argument("-f", "--force", action="store_true")
    q.add_argument("--prefix", default=None)
    q.add_argument("-t", "--threads", type=int, default=4)
    q.add_argument("--ignore-index", action="store_true")
    q.add_argument("-i", "--interval-size", type=int, default=5_000_000)
    q.add_argument("--log-filepath", "--log", default=None)
    q.add_argument("--suppress-progress", action="store_true")
    q.add_argument("-n", "--num-reads", type=int, default=None)
    q.add_argument("--check-secondary", action="store_true",
                   dest="allow_non_primary")
    q.add_argument("--only-mapped", action="store_true")
    q.add_argument("--region", default=None)
    q.set_defaults(func=cmd_modbam_check_tags, command_name="modbam check-tags")
    q = msub.add_parser("sample-reads")
    q.add_argument("in_bam")
    q.set_defaults(
        func=cmd_modbam_sample_reads, command_name="modbam sample-reads"
    )

    # ---- motif search/refine/evaluate/bed (find_motifs/) ----
    def _add_motif_input(q):
        q.add_argument("-i", "--in-bedmethyl", required=True)
        q.add_argument("-t", "--threads", type=int, default=4)
        q.add_argument("--io-threads", type=int, default=2)
        q.add_argument("-r", "--ref", required=True)
        q.add_argument("--contig", default=None)
        q.add_argument("--log-filepath", "--log", default=None)
        q.add_argument("--suppress-progress", action="store_true")

    def _add_refine_args(q):
        q.add_argument("--low-thresh", type=float, default=0.2)
        q.add_argument("--high-thresh", type=float, default=0.6)
        q.add_argument("--min-log-odds", type=float, default=1.5)
        q.add_argument("--exhaustive-seed-min-log-odds", type=float,
                       default=2.5)
        q.add_argument("--exhaustive-seed-len", type=int, default=3)
        q.add_argument("--skip-search", action="store_true")
        q.add_argument("--min-coverage", type=int, default=5)
        q.add_argument("--context-size", nargs=2, type=int, default=[12, 12])
        q.add_argument("--min-sites", type=int, default=300)
        q.add_argument("--min-frac-mod", type=float, default=0.85)

    def _add_known_motifs(q):
        q.add_argument("--known-motif", nargs=3, action="extend", default=None)
        q.add_argument("--known-motifs-table", default=None)

    p = sub.add_parser("motif", help="motif utilities")
    fsub = p.add_subparsers(dest="motif_mode", required=True)
    q = fsub.add_parser("search", help="discover enriched motifs")
    _add_motif_input(q)
    _add_refine_args(q)
    _add_known_motifs(q)
    q.add_argument("-o", "--out-table", default=None)
    q.add_argument("--eval-motifs-table", default=None)
    q.add_argument("--init-context-size", nargs=2, type=int, default=[2, 2])
    q.add_argument("--mod-code", action="append", default=None)
    q.add_argument("--force-override-spec", action="store_true")
    q.set_defaults(func=cmd_motif_search, command_name="motif search")
    q = fsub.add_parser("refine", help="refine known motifs")
    _add_motif_input(q)
    _add_known_motifs(q)
    _add_refine_args(q)
    q.add_argument("--out", default=None)
    q.add_argument("--min_refine_frac_mod", type=float, default=0.6,
                   dest="min_refine_frac_mod")
    q.add_argument("--min-refine-sites", type=int, default=300)
    q.add_argument("--force-override-spec", action="store_true")
    q.set_defaults(func=cmd_motif_refine, command_name="motif refine")
    q = fsub.add_parser("evaluate", help="score known motifs")
    _add_motif_input(q)
    _add_known_motifs(q)
    q.add_argument("--out", default=None)
    q.add_argument("--force-override-spec", action="store_true")
    q.add_argument("--min-coverage", type=int, default=5)
    q.add_argument("--context-size", nargs=2, type=int, default=[12, 12])
    q.add_argument("--low-thresh", type=float, default=0.2)
    q.add_argument("--high-thresh", type=float, default=0.6)
    q.add_argument("--suppress-table", action="store_true")
    q.set_defaults(func=cmd_motif_evaluate, command_name="motif evaluate")
    q = fsub.add_parser("bed", help="emit motif locations BED")
    q.add_argument("fasta")
    q.add_argument("motif")
    q.add_argument("offset", type=int)
    q.add_argument("-k", "--mask", action="store_true")
    q.set_defaults(func=cmd_motif_bed, command_name="motif bed")

    # find-motifs = deprecated alias of motif search
    q = sub.add_parser("find-motifs", help="motif discovery from bedMethyl")
    _add_motif_input(q)
    _add_refine_args(q)
    _add_known_motifs(q)
    q.add_argument("-o", "--out-table", default=None)
    q.add_argument("--eval-motifs-table", default=None)
    q.add_argument("--init-context-size", nargs=2, type=int, default=[2, 2])
    q.add_argument("--mod-code", action="append", default=None)
    q.add_argument("--force-override-spec", action="store_true")
    q.set_defaults(func=cmd_motif_search, command_name="find-motifs")

    return ap


def cmd_pileup(args) -> int:
    from .collapse import CollapseMethod
    from .modcodes import parse_mod_code
    from .pileup.runner import PileupConfig, run_pileup

    collapse = []
    if args.ignore:
        collapse.append(
            CollapseMethod("dist", (parse_mod_code(args.ignore),))
        )
    edge_filter = (
        parse_edge_filter(args.edge_filter, args.invert_edge_filter)
        if args.edge_filter
        else None
    )
    motifs = [x for pair in (args.motif or []) for x in pair]
    cfg = PileupConfig(
        in_bam=args.in_bam,
        out=args.out_bed,
        interval_size=args.interval_size,
        no_filtering=args.no_filtering,
        filter_threshold=parse_filter_thresholds(args.filter_threshold),
        mod_thresholds=parse_mod_thresholds(args.mod_thresholds),
        filter_percentile=args.filter_percentile,
        sample_frac=args.sampling_frac,
        num_reads=args.num_reads,
        seed=args.seed,
        include_unmapped=args.include_unmapped,
        region=args.region,
        sample_region=args.sample_region,
        combine_mods=args.combine_mods,
        collapse=collapse,
        edge_filter=edge_filter,
        force_allow=args.force_allow_implicit,
        max_depth=args.max_depth,
        mixed_delimiters=args.mixed_delimiters,
        with_header=args.with_header,
        bedgraph=args.bedgraph,
        prefix=args.prefix,
        partition_tags=args.partition_tag,
        reference_fasta=args.reference_fasta,
        motifs=motifs,
        cpg=args.cpg,
        combine_strands=args.combine_strands,
        preset=args.preset,
        include_bed=args.include_bed,
        sampling_interval_size=args.sampling_interval_size,
        journal=args.journal,
        suppress_progress=args.suppress_progress,
        threads=args.threads,
        chunk_size=args.chunk_size,
        device=args.device,
    )
    stats = run_pileup(cfg)
    if stats["errors"]:
        from .errors import ErrorTally

        t = ErrorTally(stats["errors"])
        print(t.format_table(), file=sys.stderr)
    return 0


def cmd_adjust_mods(args) -> int:
    from .caller import ThresholdCaller
    from .collapse import CollapseMethod
    from .engines.adjust import adjust_modbam
    from .modcodes import parse_mod_code
    from .motifs import parse_motifs

    methods = []
    if args.convert:
        for frm, to in args.convert:
            methods.append(
                CollapseMethod(
                    "convert", (parse_mod_code(frm),), parse_mod_code(to)
                )
            )
    elif args.ignore:
        # --method selects the collapse math for --ignore: "dist"
        # (ReDistribute, the reference's only behavior) or "norm"
        # (ReNormalize, mod_bam.rs:306-323)
        methods.append(
            CollapseMethod(args.method, (parse_mod_code(args.ignore),))
        )
    edge_filter = (
        parse_edge_filter(args.edge_filter, args.invert_edge_filter)
        if args.edge_filter
        else None
    )
    motifs = None
    if args.motif or args.cpg:
        motifs = parse_motifs(
            [x for pair in (args.motif or []) for x in pair], args.cpg
        )
    caller = None
    if args.filter_probs:
        ft = parse_filter_thresholds(args.filter_threshold)
        if args.no_filtering:
            caller = ThresholdCaller.passthrough()
        elif ft is not None:
            default = ft.pop("default", 0.0)
            caller = ThresholdCaller(ft, parse_mod_thresholds(getattr(args, "mod_thresholds", None)) or {}, default)
        elif args.in_bam in ("-", "stdin"):
            raise SystemExit(
                "must specify all thresholds with --filter-threshold "
                "when using stdin stream"
            )
        else:
            from .io.cram import open_alignment_reader
            from .thresholds import estimate_thresholds

            per_base = estimate_thresholds(
                open_alignment_reader(args.in_bam),
                num_reads=args.num_reads,
                sample_frac=args.sampling_frac, seed=args.seed,
                filter_percentile=args.filter_percentile,
                collapse=methods, edge_filter=edge_filter,
                region=args.sample_region,
            )
            caller = ThresholdCaller(per_base, {}, 0.0)
    stats = adjust_modbam(
        args.in_bam, args.out_bam, methods, caller, edge_filter,
        filter_only=True if args.filter_probs else False,
        motifs=motifs, discard_motifs=args.discard_motifs,
        fail_fast=args.fail_fast, output_sam=args.output_sam,
    )
    _print_errors(stats)
    return 0


def cmd_call_mods(args) -> int:
    from .caller import ThresholdCaller
    from .engines.adjust import adjust_modbam
    from .io.bam import BamReader

    ft = parse_filter_thresholds(args.filter_threshold)
    per_mod = parse_mod_thresholds(args.mod_thresholds) or {}
    if args.no_filtering:
        caller = ThresholdCaller.passthrough()
    elif ft is not None:
        default = ft.pop("default", 0.0)
        caller = ThresholdCaller(ft, per_mod, default)
    else:
        if args.in_bam in ("-", "stdin"):
            # sampling would consume the stream before the rewrite pass
            # (reference commands.rs:1589-1593)
            raise SystemExit(
                "must specify all thresholds with --filter-threshold and "
                "(optionally) --mod-threshold when using stdin stream"
            )
        from .io.cram import open_alignment_reader
        from .thresholds import estimate_thresholds

        per_base = estimate_thresholds(
            open_alignment_reader(args.in_bam),
            num_reads=args.num_reads,
            sample_frac=args.sampling_frac, seed=args.seed,
            include_unmapped=args.include_unmapped,
            filter_percentile=args.filter_percentile,
            region=args.sample_region,
        )
        caller = ThresholdCaller(per_base, per_mod, 0.0)
    edge_filter = (
        parse_edge_filter(args.edge_filter, args.invert_edge_filter)
        if args.edge_filter
        else None
    )
    stats = adjust_modbam(
        args.in_bam, args.out_bam, (), caller, edge_filter,
        filter_only=False, fail_fast=args.fail_fast,
        output_sam=args.output_sam,
    )
    _print_errors(stats)
    return 0


def cmd_update_tags(args) -> int:
    from .engines.adjust import adjust_modbam
    from .modtags import EXPLICIT, IMPLICIT

    # "ambiguous" is the clap alias of explicit '?' (commands.rs:1184-1188)
    if args.mode in ("explicit", "ambiguous"):
        new_mode = EXPLICIT
    elif args.mode == "implicit":
        new_mode = IMPLICIT
    elif args.no_implicit_probs:
        new_mode = EXPLICIT
    else:
        new_mode = IMPLICIT
    if args.no_implicit_probs and new_mode != EXPLICIT:
        raise SystemExit(
            "cannot change to implicit mode and skip implicit probs"
        )
    stats = adjust_modbam(
        args.in_bam, args.out_bam, new_mode=new_mode,
        drop_implicit=args.no_implicit_probs, force_mm_style="MM",
        output_sam=args.output_sam,
    )
    _print_errors(stats)
    return 0


def cmd_extract(args) -> int:
    import os

    from .caller import ThresholdCaller
    from .collapse import CollapseMethod
    from .engines.extract import run_extract
    from .modcodes import parse_mod_code

    if (
        args.out_path not in ("-", "stdout")
        and os.path.exists(args.out_path)
        and not args.force
    ):
        raise SystemExit(f"refusing to overwrite {args.out_path} (use --force)")
    collapse = []
    if args.ignore:
        collapse.append(CollapseMethod("dist", (parse_mod_code(args.ignore),)))
    edge_filter = (
        parse_edge_filter(args.edge_filter, args.invert_edge_filter)
        if args.edge_filter
        else None
    )
    caller = None
    if args.extract_mode == "calls":
        ft = parse_filter_thresholds(args.filter_threshold)
        per_mod = parse_mod_thresholds(args.mod_thresholds) or {}
        if args.no_filtering:
            caller = ThresholdCaller.passthrough()
        elif ft is not None:
            default = ft.pop("default", 0.0)
            caller = ThresholdCaller(ft, per_mod, default)
        else:
            from .io.cram import open_alignment_reader
            from .thresholds import estimate_thresholds

            per_base = estimate_thresholds(
                open_alignment_reader(args.in_bam),
                num_reads=args.num_reads,
                sample_frac=args.sampling_frac, seed=args.seed,
                include_unmapped=True,
                filter_percentile=args.filter_percentile,
                collapse=collapse, edge_filter=edge_filter,
                region=args.region,
            )
            caller = ThresholdCaller(per_base, per_mod, 0.0)
    run_extract(
        args.in_bam, args.out_path, mode=args.extract_mode,
        collapse=collapse, edge_filter=edge_filter, kmer_size=args.kmer_size,
        reference_fasta=args.reference_fasta, caller=caller,
        pass_only=getattr(args, "pass_only", False),
        mapped_only=args.mapped_only, region=args.region,
        allow_non_primary=args.allow_non_primary,
        include_header=not args.no_headers,
        bgzf=args.bgzf, threads=args.threads,
        ignore_implicit=args.ignore_implicit,
        out_threads=args.out_threads,
        include_bed=args.include_bed, exclude_bed=args.exclude_bed,
        motifs=[x for pair in (args.motif or []) for x in pair],
        cpg=args.cpg,
        queue_size=args.queue_size,
    )
    return 0


def _print_errors(stats: dict) -> None:
    if stats.get("errors"):
        from .errors import ErrorTally

        print(ErrorTally(stats["errors"]).format_table(), file=sys.stderr)


def _sample_common(args):
    from .collapse import CollapseMethod
    from .io.cram import open_alignment_reader
    from .modcodes import parse_mod_code
    from .position_filter import StrandedPositionFilter
    from .thresholds import sample_reads

    reader = open_alignment_reader(
        args.in_bam, getattr(args, "reference_fasta", None)
    )
    collapse = []
    if args.ignore:
        collapse.append(CollapseMethod("dist", (parse_mod_code(args.ignore),)))
    edge_filter = (
        parse_edge_filter(args.edge_filter, args.invert_edge_filter)
        if args.edge_filter
        else None
    )
    position_filter = None
    if getattr(args, "include_bed", None):
        position_filter = StrandedPositionFilter.from_bed_file(
            args.include_bed, dict(reader.header.name_to_tid)
        )
    num_reads = None if args.no_sampling else args.num_reads
    sample_frac = None if args.no_sampling else args.sampling_frac
    if sample_frac is not None:
        num_reads = None
    only_mapped = args.only_mapped or position_filter is not None
    sampled = sample_reads(
        reader,
        num_reads=num_reads,
        sample_frac=sample_frac,
        seed=args.seed,
        include_unmapped=not only_mapped,
        region=args.region,
        collapse=collapse,
        edge_filter=edge_filter,
        position_filter=position_filter,
        only_mapped=only_mapped,
    )
    return reader, sampled, collapse


def cmd_summary(args) -> int:
    from .caller import ThresholdCaller
    from .summary import (
        render_summary_table, render_summary_tsv, summarize_sampled,
    )
    from .thresholds import thresholds_from_sampled

    args.only_mapped = getattr(args, "only_mapped", False)
    reader, sampled, _ = _sample_common(args)
    ft = parse_filter_thresholds(args.filter_threshold)
    per_mod = parse_mod_thresholds(args.mod_thresholds) or {}
    if args.no_filtering:
        caller = ThresholdCaller.passthrough()
    elif ft is not None:
        default = ft.pop("default", 0.0)
        caller = ThresholdCaller(ft, per_mod, default)
    else:
        per_base = thresholds_from_sampled(sampled, args.filter_percentile)
        caller = ThresholdCaller(per_base, per_mod, 0.0)
    s = summarize_sampled(sampled, caller, args.region)
    # --table is the default rendering; it exists to be explicit and to
    # conflict-check against --tsv (commands.rs ModSummarize args)
    if args.tsv_format and args.table_format:
        raise SystemExit("--tsv and --table are mutually exclusive")
    if args.tsv_format:
        sys.stdout.write(render_summary_tsv(s))
    else:
        sys.stdout.write(render_summary_table(s))
    return 0


def cmd_sample_probs(args) -> int:
    import os

    from .summary import render_percentiles_table, sample_probs_percentiles

    args.only_mapped = getattr(args, "only_mapped", False)
    reader, sampled, _ = _sample_common(args)
    qs = [float(x) for x in args.percentiles.split(",")]
    per_base = sample_probs_percentiles(sampled, qs)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        prefix = f"{args.prefix}_" if args.prefix else ""
        targets = [f"{prefix}thresholds.tsv"]
        if args.histogram:
            targets += [
                f"{prefix}probabilities.tsv",
                f"{prefix}counts.html",
                f"{prefix}proportion.html",
            ]
        paths = [os.path.join(args.out_dir, t) for t in targets]
        for fp in paths:
            if os.path.exists(fp) and not args.force:
                raise SystemExit(f"refusing to overwrite {fp}")
        with open(paths[0], "w") as fh:
            fh.write(render_percentiles_table(per_base))
        if args.histogram:
            from .charts import bar_chart_html
            from .summary import (
                histogram_chart_data, prob_histograms,
                render_probabilities_tsv,
            )

            hists = prob_histograms(sampled)
            with open(paths[1], "w") as fh:
                fh.write(render_probabilities_tsv(hists))
            cats, counts_s, prop_s = histogram_chart_data(hists)
            # keys are the rendered label parts (chart labels format the
            # code as text, so ChEBI codes match by their digit string)
            overrides = {
                "dna": dict(args.dna_color or []),
                "mod": {c: col for c, col in (args.mod_color or [])},
            }
            with open(paths[2], "w") as fh:
                fh.write(
                    bar_chart_html(
                        "Counts", cats, counts_s, "counts", overrides
                    )
                )
            with open(paths[3], "w") as fh:
                fh.write(
                    bar_chart_html(
                        "Proportion", cats, prop_s, "proportion", overrides
                    )
                )
    else:
        if args.histogram:
            from .logging import get_logger

            get_logger().warning(
                "--hist requires an output directory (-o); only writing "
                "the thresholds table"
            )
        sys.stdout.write(render_percentiles_table(per_base))
    return 0


def cmd_modbam_check_tags(args) -> int:
    from .engines.modbam_util import run_check_tags

    return run_check_tags(args)


def cmd_modbam_sample_reads(args) -> int:
    from .engines.modbam_util import run_sample_reads

    return run_sample_reads(args)



def cmd_repair(args) -> int:
    from .engines.repair import run_repair

    return run_repair(args)


def cmd_pileup_hemi(args) -> int:
    from .engines.pileup_hemi import run_pileup_hemi

    return run_pileup_hemi(args)


def cmd_validate(args) -> int:
    from .engines.validate import run_validate

    return run_validate(args)


def cmd_stats(args) -> int:
    from .engines.bedmethyl_tools import run_stats

    return run_stats(args)


def cmd_localize(args) -> int:
    from .engines.bedmethyl_tools import run_localize

    return run_localize(args)


def cmd_bedmethyl_merge(args) -> int:
    from .engines.bedmethyl_tools import run_merge

    return run_merge(args)


def cmd_bedmethyl_tobigwig(args) -> int:
    from .engines.bedmethyl_tools import run_tobigwig

    return run_tobigwig(args)


def cmd_dmr_pair(args) -> int:
    from .engines.dmr import run_pair

    return run_pair(args)


def cmd_dmr_multi(args) -> int:
    from .engines.dmr import run_multi

    return run_multi(args)


def cmd_entropy(args) -> int:
    from .engines.entropy import run_entropy

    return run_entropy(args)


def cmd_motif_search(args) -> int:
    from .engines.find_motifs import run_motif_search

    return run_motif_search(args)


def cmd_motif_refine(args) -> int:
    from .engines.find_motifs import run_motif_refine

    return run_motif_refine(args)


def cmd_motif_evaluate(args) -> int:
    from .engines.find_motifs import run_motif_evaluate

    return run_motif_evaluate(args)


def cmd_motif_bed(args) -> int:
    from .engines.motif_bed import run_motif_bed

    return run_motif_bed(args)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    from .logging import init_logging

    init_logging(getattr(args, "log_filepath", None))
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
