"""Serving (counterpart of ``repro.serve``): the greedy engine, paged by
default (block pool, chunked prefill, prefix cache) or contiguous."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache, paged_supported

__all__ = ["PagedKVCache", "Request", "ServeEngine", "paged_supported"]
