"""Serving of the port: ``kv_cache.PagedKVPool`` (the resident KV pool and
its allocator glue) and ``engine.LibraEngine`` (continuous batching over
anchored pages)."""
