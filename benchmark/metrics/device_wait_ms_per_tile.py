"""The wait for a tile's D2H copy of kernel A's states (the program's
``device_wait`` span: the copy's event synchronized in
``TileProcessor.assemble_counts``) in ms per tile, summed over the tile
workers. Nothing where the program has no tracer
(``modkit_tpu_torch.tracing``)."""

import importlib.util

COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}
if importlib.util.find_spec("modkit_tpu_torch.tracing") is not None:
    # emit(kind, name, tile, start_ns, end_ns, value)
    COUNTS["device_wait_ns"] = {"modkit_tpu_torch.tracing:emit":
                                lambda a: a[4] - a[3] if a[1] == "device_wait" else 0}


def read(tr):
    ns, tiles = tr.counts.get("device_wait_ns"), tr.counts.get("tiles")
    return None if ns is None or not tiles else ns / 1e6 / tiles
