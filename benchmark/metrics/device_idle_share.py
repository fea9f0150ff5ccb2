"""The card's idle share of the traced stretch, in %: 1 - the union of its
kernels, copies and memsets over the stretch's length (torch.profiler).
Nothing where the trace holds no device activity."""


def read(tr):
    w0, w1 = tr.window
    if w1 <= w0 or not tr.device:
        return None
    busy = sum(e - s for s, e in tr.busy())
    return 100.0 * (1.0 - busy / (w1 - w0))
