"""Device selection, the offload policy and the parallel paths of the port:
tiles round-robin over local devices, a [tiles, readers] grid of devices
for the sharded count (``sharded_pileup``), and a gloo process group for
multi-host shard runs (``devices.maybe_init_distributed``)."""
