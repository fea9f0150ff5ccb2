"""The ordered writer on the main thread (``writers.BedMethylWriter``'s
write methods: the rows' text into the output) in ms per tile."""

SPANS = {"write": [
    "modkit_tpu_torch.writers:BedMethylWriter.write_formatted",
    "modkit_tpu_torch.writers:BedMethylWriter.write_rows",
    "modkit_tpu_torch.writers:BedMethylWriter.write_columnar",
]}
COUNTS = {"tiles": {"modkit_tpu_torch.pileup.engine:TileProcessor.launch_tile": None}}


def read(tr):
    return tr.ms_per_tile("write")
