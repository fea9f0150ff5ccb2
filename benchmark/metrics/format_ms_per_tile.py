"""Formatting (counts to rows: ``native.format_rows`` without a motif,
``engine.decode_counts`` and ``combine_strand_rows`` with one) in ms per
tile, summed over the tile workers."""

SPANS = {"format": [
    "modkit_tpu_torch.native:format_rows",
    "modkit_tpu_torch.pileup.engine:decode_counts",
    "modkit_tpu_torch.pileup.engine:decode_counts_columnar",
    "modkit_tpu_torch.pileup.engine:combine_strand_rows",
]}
COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}


def read(tr):
    return tr.ms_per_tile("format")
