"""The old names of the quantization API (counterpart of
``repro.core.quant``): thin aliases over ``repro_torch.quantization``."""
from __future__ import annotations

import torch

from repro_torch.quantization import (EXPERT_MATS, QuantTensor,  # noqa: F401
                                      expert_weights, get_scheme,
                                      is_quantized, params_scheme,
                                      quantize_model, quantize_moe_params)


def quantize_expert(w: torch.Tensor):
    """(E, K, N) -> int8 payload and (E, 1, 1) scales (``int8_expert``)."""
    qt = get_scheme("int8_expert").quantize(w)
    return qt.q, qt.s


def effective_expert_weights(moe_params: dict, dtype) -> dict:
    """The old name of ``expert_weights``."""
    return expert_weights(moe_params, dtype)
