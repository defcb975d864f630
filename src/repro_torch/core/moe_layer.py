"""MoE layer: routed experts through ``moe_ffn`` plus the optional shared
experts (counterpart of ``repro.core.moe_layer``).  The shared experts are
one dense SwiGLU of width ``n_shared * d_ff_expert``, computed in fp32 and
cast to the layer's dtype, as in the reference."""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn


def dispatch_config(moe: MoEConfig, *, executor: str = "cuda",
                    fuse_gate_up: bool = True, fold_combine: bool = True,
                    schedule_policy: str = "fixed",
                    block_m_min: int = 8) -> MoEDispatchConfig:
    return MoEDispatchConfig(
        n_experts=moe.n_experts, top_k=moe.top_k, block_m=moe.block_m,
        executor=executor, fuse_gate_up=fuse_gate_up,
        fold_combine=fold_combine, gating=moe.gating,
        norm_topk=moe.norm_topk, routed_scale=moe.routed_scale,
        schedule_policy=schedule_policy, block_m_min=block_m_min)


def apply_moe(params, x: torch.Tensor, cfg: MoEDispatchConfig):
    """params: mapping with "router", "w_gate", "w_up", "w_down" and
    optionally "shared" {"w_gate", "w_up", "w_down"}.
    x: (..., d) -> (y, aux); leading dims are flattened for dispatch."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    dt = x.dtype
    y, aux = moe_ffn(x2, params["router"], params["w_gate"].to(dt),
                     params["w_up"].to(dt), params["w_down"].to(dt), cfg)
    if "shared" in params:
        sh = params["shared"]
        xf = x2.float()
        g = torch.matmul(xf, sh["w_gate"].float())
        u = torch.matmul(xf, sh["w_up"].float())
        y_sh = torch.matmul((g * torch.sigmoid(g)) * u, sh["w_down"].float())
        y = y + y_sh.to(y.dtype)
    return y.reshape(shape), aux
