"""Kernel A (``ops/state.py`` -> ``csrc/state.cu``, the quals or the f32
entry, whichever ran) as a share of its memory roofline, in %: the bytes
its launches need over the card's HBM bandwidth, divided by the kernels'
device time in the trace.

The bytes are counted on the two entries as the tile engine calls them:
the quals entry reads M class planes, the present and zero masks and the
base, and writes the state (M + 4 an event); the f32 entry reads M floats
and the base and writes the state (4M + 2)."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "peaks.json")) as _fh:
    PEAKS = json.load(_fh)

COUNTS = {"state_bytes": {
    "modkit_tpu_torch.pileup.engine:threshold_state_quals_t":
        lambda args: args[0].shape[1] * (args[0].shape[0] + 4),
    "modkit_tpu_torch.pileup.engine:threshold_state_f32":
        lambda args: args[0].shape[0] * (4 * args[0].shape[1] + 2),
}}


def read(tr):
    peak = PEAKS.get(tr.device_kind, {}).get("hbm_bytes_per_s")
    w0, w1 = tr.window
    t = sum(min(e, w1) - max(s, w0) for n, s, e in tr.device
            if "state_" in n and "kernel" in n and e > w0 and s < w1)
    nbytes = tr.counts.get("state_bytes")
    if not peak or t <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / peak / t
