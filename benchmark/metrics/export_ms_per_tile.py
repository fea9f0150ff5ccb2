"""Export of a tile's events into the upload layout (the program's
``export`` span: ``NativeTile.export_quals_t`` or ``export_events``) in ms
per tile, summed over the tile workers. Nothing where the program has no
tracer (``modkit_tpu_torch.tracing``)."""

import importlib.util

COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}
if importlib.util.find_spec("modkit_tpu_torch.tracing") is not None:
    # emit(kind, name, tile, start_ns, end_ns, value)
    COUNTS["export_ns"] = {"modkit_tpu_torch.tracing:emit":
                           lambda a: a[4] - a[3] if a[1] == "export" else 0}


def read(tr):
    ns, tiles = tr.counts.get("export_ns"), tr.counts.get("tiles")
    return None if ns is None or not tiles else ns / 1e6 / tiles
