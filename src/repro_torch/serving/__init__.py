"""Serving stack of the port: paged KV pool, block transport, engine with
ring replication and failover, and the HTTP server."""
