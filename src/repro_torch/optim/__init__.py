"""Optimizers (counterpart of ``repro.optim``): AdamW, and int8 gradient
compression with error feedback."""
from repro_torch.optim.adamw import (OptConfig, apply_updates, global_norm,
                                     init_opt_state, schedule)
from repro_torch.optim.compress import (compress_with_feedback, dequantize,
                                        init_error_state, quantize)

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule", "compress_with_feedback", "dequantize",
           "init_error_state", "quantize"]
