"""The ``QuantScheme`` contract and registry (counterpart of
``repro.quantization.base``).

A scheme registers under a name and owns one compressed layout: quantize,
dequantize at any granularity (the whole stack, one expert, a gathered
batch of blocks), the logical shape of a payload, the per-output-channel
scales the kernels read, and its declared accuracy contract
(``rel_error_bound``: the max relative inf-norm error of a MoE layer's
output against the fp32 dense one)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.quantization.tensor import QuantTensor

# the routed expert matrices every MoE param mapping carries
EXPERT_MATS = ("w_gate", "w_up", "w_down")


class QuantScheme:
    """Contract for one compressed expert-weight layout."""

    name: str = "?"
    bits: int = 32                  # logical bits per weight element
    rel_error_bound: float = 0.0    # declared layer-output inf-norm rel err
    kernel_format: str = "dense"    # in-kernel dequant: dense | int8 | int4

    def quantize(self, w: torch.Tensor):
        """(..., E, K, N) dense stack -> QuantTensor (or passthrough)."""
        raise NotImplementedError

    def dequantize(self, q: torch.Tensor, s: torch.Tensor, dtype):
        """Invert at any granularity over the leading axes."""
        raise NotImplementedError

    def logical_shape(self, q_shape) -> tuple:
        """Dense-stack shape from the stored payload's shape."""
        return tuple(q_shape)

    def channel_scales(self, qt: QuantTensor) -> torch.Tensor:
        """(E, N) f32 per-output-channel scales for the kernels.  A view of
        ``qt.s``, built without a copy: per-expert scales are expanded with a
        zero stride over N, which the kernels read as such."""
        E = qt.s.shape[0]
        N = self.logical_shape(tuple(qt.q.shape))[-1]
        return qt.s.reshape(E, -1).expand(E, N)


_SCHEMES: Dict[str, QuantScheme] = {}


def register_scheme(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register a QuantScheme."""
    def deco(cls: type) -> type:
        cls.name = name
        _SCHEMES[name] = cls()
        return cls
    return deco


def get_scheme(name) -> QuantScheme:
    if isinstance(name, QuantScheme):
        return name
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(f"unknown quant scheme {name!r}; "
                         f"available: {available_schemes()}") from None


def available_schemes():
    return sorted(_SCHEMES)
