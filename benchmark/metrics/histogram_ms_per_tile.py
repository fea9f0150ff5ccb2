"""Host histogram (``NativeTile.bincount_full``: per-event states into the
tile's count tensor) in ms per tile, summed over the tile workers."""

SPANS = {"histogram": ["modkit_tpu_torch.native:NativeTile.bincount_full"]}
COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}


def read(tr):
    return tr.ms_per_tile("histogram")
