"""Synthetic training data (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import device_batch, make_batch, markov_tokens

__all__ = ["device_batch", "make_batch", "markov_tokens"]
