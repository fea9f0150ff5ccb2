"""The 95th percentile of a tile's wall time, from its submission to the
end of its write (the program's ``tile`` span), in ms, over the tiles of
the traced stretch (nearest rank). Nothing where the program has no
tracer (``modkit_tpu_torch.tracing``)."""

import importlib.util
import math

WALLS = []  # ns, one a tile


def _keep(a):
    # emit(kind, name, tile, start_ns, end_ns, value)
    if a[1] == "tile":
        WALLS.append(a[4] - a[3])
    return 0


COUNTS = {}
if importlib.util.find_spec("modkit_tpu_torch.tracing") is not None:
    COUNTS["tile_spans"] = {"modkit_tpu_torch.tracing:emit": _keep}


def read(tr):
    if not WALLS:
        return None
    w = sorted(WALLS)
    return w[math.ceil(0.95 * len(w)) - 1] / 1e6
