"""The threshold estimate in ms per job (the program's ``estimate`` span in
``runner.resolve_caller``: the sampling of reads, the pooling of their
confidences and the sort, on the main thread before the first tile is
submitted), summed over the traced jobs and divided by the number of such
spans. Nothing where the program has no tracer
(``modkit_tpu_torch.tracing``), its tracer has no ``estimate`` span, or no
job estimated."""

import importlib
import importlib.util

COUNTS = {}
if (importlib.util.find_spec("modkit_tpu_torch.tracing") is not None
        and "estimate" in importlib.import_module("modkit_tpu_torch.tracing").SPANS):
    # emit(kind, name, tile, start_ns, end_ns, value)
    COUNTS["estimate_ns"] = {"modkit_tpu_torch.tracing:emit":
                             lambda a: a[4] - a[3] if a[1] == "estimate" else 0}
    COUNTS["estimates"] = {"modkit_tpu_torch.tracing:emit":
                           lambda a: 1 if a[1] == "estimate" else 0}


def read(tr):
    ns, n = tr.counts.get("estimate_ns"), tr.counts.get("estimates")
    return None if ns is None or not n else ns / 1e6 / n
