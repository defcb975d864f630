"""Kernel autotuning (counterpart of ``repro.tuning``): the persistent tune
cache (``cache``), the sweeps that fill it on the card (``autotune``) and
the tool that builds it (``python -m repro_torch.tuning.build``)."""
from repro_torch.tuning.cache import (CACHE_VERSION, STATS, TuneCache,
                                      get_cache, local_cache_path,
                                      lookup_block_sizes, make_key,
                                      reset_cache, reset_stats,
                                      shape_bucket)
from repro_torch.tuning.autotune import (bench, candidate_configs,
                                         sweep_kernel, sweep_sub_block,
                                         tune_moe_layer)

__all__ = ["CACHE_VERSION", "STATS", "TuneCache", "get_cache",
           "local_cache_path", "lookup_block_sizes", "make_key",
           "reset_cache", "reset_stats", "shape_bucket", "bench",
           "candidate_configs", "sweep_kernel", "sweep_sub_block",
           "tune_moe_layer"]
