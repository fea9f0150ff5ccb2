"""The ordered writer blocked on the next tile's result (the program's
``writer_wait`` span around the future's ``result()`` in
``runner.run_pileup``, on the main thread) in ms per tile. Nothing where
the program has no tracer (``modkit_tpu_torch.tracing``)."""

import importlib.util

COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}
if importlib.util.find_spec("modkit_tpu_torch.tracing") is not None:
    # emit(kind, name, tile, start_ns, end_ns, value)
    COUNTS["writer_wait_ns"] = {"modkit_tpu_torch.tracing:emit":
                                lambda a: a[4] - a[3] if a[1] == "writer_wait" else 0}


def read(tr):
    ns, tiles = tr.counts.get("writer_wait_ns"), tr.counts.get("tiles")
    return None if ns is None or not tiles else ns / 1e6 / tiles
