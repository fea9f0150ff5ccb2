"""Host decode (``native.decode_tile_bgzf``: BGZF inflate and record decode
of a tile) in ms per tile, summed over the tile workers."""

SPANS = {"decode": ["modkit_tpu_torch.native:decode_tile_bgzf"]}
COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}


def read(tr):
    return tr.ms_per_tile("decode")
