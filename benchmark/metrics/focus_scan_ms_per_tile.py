"""The focus scan on the main thread (the program's ``focus_scan`` span in
``runner.run_pileup``'s tile loop: the tile's CpG or motif positions found
in the reference, with ``--combine-strands`` the extension of the tile's
end, or the ``--include-bed`` rules) in ms per tile, before the tile is
submitted. Nothing where the program has no tracer
(``modkit_tpu_torch.tracing``) or its tracer has no ``focus_scan`` span."""

import importlib
import importlib.util

COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}
if (importlib.util.find_spec("modkit_tpu_torch.tracing") is not None
        and "focus_scan" in importlib.import_module("modkit_tpu_torch.tracing").SPANS):
    # emit(kind, name, tile, start_ns, end_ns, value)
    COUNTS["focus_scan_ns"] = {"modkit_tpu_torch.tracing:emit":
                               lambda a: a[4] - a[3] if a[1] == "focus_scan" else 0}


def read(tr):
    ns, tiles = tr.counts.get("focus_scan_ns"), tr.counts.get("tiles")
    return None if ns is None or not tiles else ns / 1e6 / tiles
