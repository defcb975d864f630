"""Serving (counterpart of ``repro.serve``): the engine, paged by default
(block pool, chunked prefill, prefix cache) or contiguous, greedy or
sampled; the open-stream front end; the trace-driven load generator;
per-host admission over expert-parallel ranks (``serve/distributed.py``)."""
from repro_torch.serve.distributed import (DistributedServeLoop,
                                           partition_requests)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.frontend import ServingFrontend
from repro_torch.serve.kv_cache import PagedKVCache, paged_supported
from repro_torch.serve.loadgen import (PATTERNS, TraceEvent, VirtualClock,
                                       make_virtual_obs, replay, synth_trace)

__all__ = ["DistributedServeLoop", "partition_requests", "PagedKVCache",
           "Request", "ServeEngine", "ServingFrontend", "paged_supported",
           "PATTERNS", "TraceEvent", "VirtualClock", "make_virtual_obs",
           "replay", "synth_trace"]
