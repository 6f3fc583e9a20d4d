"""Sharding rules of the port: the layout a shard-degraded instance would
serve on, computed over shapes and dtypes (one card runs no tensor
parallelism)."""
