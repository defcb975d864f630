"""Model assembly (counterpart of ``repro.models``)."""
from repro_torch.models.lm import (LM, RunConfig, forward, init_cache,
                                   init_params)

__all__ = ["LM", "RunConfig", "forward", "init_cache", "init_params"]
