"""The run's reads per second (``run.py``'s ``pileup_reads_per_s``: every
read of every job over the window, traced half included), as a per-layer
reading where the rate is not an end-to-end metric of the cell."""


def read(tr):
    return tr.host.get("pileup_reads_per_s")
