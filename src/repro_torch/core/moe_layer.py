"""MoE layer: routed experts through ``moe_ffn`` plus the optional shared
experts (counterpart of ``repro.core.moe_layer``).  The shared experts are
one dense SwiGLU of width ``n_shared * d_ff_expert``, computed in fp32 and
cast to the layer's dtype, as in the reference."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
from repro_torch.execution import get_executor
from repro_torch.quantization import expert_weights, params_scheme


def dispatch_config(moe: MoEConfig, *, executor: str = "cuda",
                    fuse_gate_up: bool = True, fold_combine: bool = True,
                    schedule_policy: str = "fixed",
                    capacity_factor: Optional[float] = None,
                    block_m_min: int = 8,
                    emit_stats: bool = False,
                    autotune: bool = False) -> MoEDispatchConfig:
    """``capacity_factor`` None takes the architecture's
    (``moe.capacity_factor``)."""
    return MoEDispatchConfig(
        n_experts=moe.n_experts, top_k=moe.top_k, block_m=moe.block_m,
        executor=executor, fuse_gate_up=fuse_gate_up,
        fold_combine=fold_combine, gating=moe.gating,
        norm_topk=moe.norm_topk, routed_scale=moe.routed_scale,
        schedule_policy=schedule_policy,
        capacity_factor=(moe.capacity_factor if capacity_factor is None
                         else capacity_factor),
        block_m_min=block_m_min, emit_stats=emit_stats, autotune=autotune)


def shared_experts(sh, x2: torch.Tensor) -> torch.Tensor:
    """The shared experts' SwiGLU on the rows of x2 (n, d), in fp32."""
    xf = x2.float()
    g = torch.matmul(xf, sh["w_gate"].float())
    u = torch.matmul(xf, sh["w_up"].float())
    return torch.matmul((g * torch.sigmoid(g)) * u, sh["w_down"].float())


def apply_moe(params, x: torch.Tensor, cfg: MoEDispatchConfig):
    """params: mapping with "router", "w_gate", "w_up", "w_down" (dense
    stacks or ``QuantTensor``s under one scheme) and optionally "shared"
    {"w_gate", "w_up", "w_down"}.
    x: (..., d) -> (y, aux); leading dims are flattened for dispatch.

    Quantized params go through the executor's capability contract:
    ``supports_scheme`` gates them, and the routed stacks are retargeted to
    x's dtype without a copy (``expert_weights``)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    scheme = params_scheme(params)
    if not get_executor(cfg.executor).supports_scheme(scheme):
        raise ValueError(
            f"executor {cfg.executor!r} does not support quant scheme "
            f"{scheme!r}; requantize the params or pick another backend")
    w = expert_weights(params, x.dtype)
    y, aux = moe_ffn(x2, params["router"], w["w_gate"], w["w_up"],
                     w["w_down"], cfg)
    if "shared" in params:
        y = y + shared_experts(params["shared"], x2).to(y.dtype)
    return y.reshape(shape), aux
