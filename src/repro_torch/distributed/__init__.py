"""Sharding rules of the port: specs over shapes and dtypes, the degraded
layout a shard-degraded instance serves on, the DTensor placements the dry
run lays every tensor out with on a production mesh (``sharding``), and
the layout helpers the model's mesh paths use (``layout``)."""
