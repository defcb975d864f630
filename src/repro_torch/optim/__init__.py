"""Optimizers (counterpart of ``repro.optim``): AdamW."""
from repro_torch.optim.adamw import (OptConfig, apply_updates, global_norm,
                                     init_opt_state, schedule)

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule"]
