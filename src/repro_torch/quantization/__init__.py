"""Expert-weight quantization (counterpart of ``repro.quantization``).

* ``QuantScheme`` and its registry (``base.py``, ``schemes.py``): ``none``,
  ``int8_expert``, ``int8_channel``, ``int4_packed``.
* ``QuantTensor`` (``tensor.py``): a compressed ``(E, K, N)`` stack.
* Param helpers (this module): ``quantize_moe_params`` on a MoE param
  mapping, ``quantize_model`` on the port's ``LM`` (the counterpart of
  ``quantize_params_tree``), ``params_scheme``, ``expert_weights``.

The router and the shared experts stay dense, as in the reference; only
the routed stacks ``EXPERT_MATS`` are compressed.  Executors take the
result through ``supports_scheme`` and ``prepare_weights``
(``execution/base.py``); the ``cuda`` executor hands the payloads and
scales to the kernels, which dequantize each weight tile on chip."""
from __future__ import annotations

import warnings

import torch

from repro_torch.quantization.base import (EXPERT_MATS, QuantScheme,  # noqa: F401
                                           available_schemes, get_scheme,
                                           register_scheme)
from repro_torch.quantization.schemes import (Int4PackedScheme,  # noqa: F401
                                              Int8ChannelScheme,
                                              Int8ExpertScheme, NoneScheme,
                                              pack_int4, unpack_int4)
from repro_torch.quantization.tensor import QuantTensor  # noqa: F401


def _quantized(name: str, cur, sch: QuantScheme) -> bool:
    """True when ``cur`` is already quantized under ``sch`` (nothing to
    do); raises when it is quantized under another scheme."""
    if not isinstance(cur, QuantTensor):
        return False
    if cur.scheme == sch.name:
        return True
    raise ValueError(f"param {name!r} is already quantized under "
                     f"{cur.scheme!r}; dequantize before re-quantizing as "
                     f"{sch.name!r}")


def quantize_moe_params(moe_params: dict, scheme: str = "int8_expert"
                        ) -> dict:
    """A copy of the mapping with its routed expert stacks replaced by
    ``QuantTensor``s under ``scheme``; idempotent."""
    sch = get_scheme(scheme)
    out = dict(moe_params)
    for name in EXPERT_MATS:
        if not _quantized(name, moe_params[name], sch):
            out[name] = sch.quantize(moe_params[name])
    return out


@torch.no_grad()
def quantize_model(model, scheme: str = "int8_expert"):
    """Quantize every MoE layer's routed stacks of the port's ``LM`` in
    place and return the model.  One stack at a time: each dense stack is
    released as soon as its payload exists, so the peak is the dense model
    plus one stack's temporaries, never a second whole copy.  Idempotent
    under the same scheme; ``"none"`` changes nothing."""
    sch = get_scheme(scheme)
    if sch.name == "none":
        return model
    for blk in model.layers:
        moe = getattr(blk, "moe", None)
        if moe is None:
            continue
        for name in EXPERT_MATS:
            cur = moe.expert_weight(name)
            if _quantized(name, cur, sch):
                continue
            qt = sch.quantize(cur)
            del cur
            moe.set_expert_weight(name, qt)      # drops the dense stack
            del qt
    return model


def routed_expert_bytes(model) -> int:
    """Stored bytes of every MoE layer's routed stacks (payload and scales
    when quantized): the weight bytes a decode step reads from."""
    total = 0
    for blk in model.layers:
        moe = getattr(blk, "moe", None)
        if moe is None:
            continue
        for name in EXPERT_MATS:
            w = moe.expert_weight(name)
            total += (w.nbytes if isinstance(w, QuantTensor)
                      else w.numel() * w.element_size())
    return total


def is_quantized(moe_params: dict) -> bool:
    return isinstance(moe_params.get("w_gate"), QuantTensor)


def params_scheme(moe_params: dict) -> str:
    """The scheme tag of a MoE param mapping ('none' for dense params)."""
    w = moe_params.get("w_gate")
    return w.scheme if isinstance(w, QuantTensor) else "none"


def expert_weights(moe_params: dict, dtype=None) -> dict:
    """{"w_gate", "w_up", "w_down"} for the dispatch pipeline.  ``dtype``
    retargets a QuantTensor's dequantization (no copy) and casts a dense
    stack, which the kernels take in the activations' dtype only (a no-op
    where it already is, as on the served path)."""
    out = {}
    for name in EXPERT_MATS:
        w = moe_params[name]
        if dtype is not None:
            w = w.with_dtype(dtype) if isinstance(w, QuantTensor) \
                else w.to(dtype)
        out[name] = w
    return out


def resolve_quant_cli(quant: str | None, quant_experts: bool = False) -> str:
    """One ``--quant <scheme>`` selector; maps the deprecated
    ``--quant-experts`` flag onto ``int8_expert``.  An explicit ``--quant``,
    ``none`` included, wins over the old flag."""
    if quant_experts:
        warnings.warn(
            "--quant-experts is deprecated; use --quant int8_expert "
            "(the equivalent scheme in the quantization registry)",
            DeprecationWarning, stacklevel=2)
        if quant is None:
            quant = "int8_expert"
    quant = quant or "none"
    get_scheme(quant)                   # uniform unknown-scheme error
    return quant
