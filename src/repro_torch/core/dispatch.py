"""Single-device MoE dispatch, the paper's end-to-end pipeline (counterpart
of ``repro.core.dispatch``):

    router logits -> gating/top-k -> schedule -> permute
      -> fused gate+up grouped GEMM -> down grouped GEMM (folded combine)
      -> unpermute

``moe_ffn`` is ``plan_dispatch`` + ``execute`` on ``cfg.executor``: ``cuda``
(the kernels, the default), ``blocks`` or ``dense`` (``repro_torch.
execution``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.execution import execute, get_executor, plan_dispatch


class MoEDispatchConfig(NamedTuple):
    n_experts: int
    top_k: int
    block_m: int = 128
    executor: str = "cuda"           # any registered repro_torch backend
    fuse_gate_up: bool = True
    fold_combine: bool = True
    gating: str = "softmax"
    norm_topk: bool = False
    routed_scale: float = 1.0
    schedule_policy: str = "fixed"   # any registered repro_torch policy
    capacity_factor: float = 2.0     # the capacity_factor policy's headroom
    block_m_min: int = 8             # the dynamic policy's sub-block floor
    emit_stats: bool = False         # sched/* ScheduleStats in the aux
    autotune: bool = False           # cuda executor: B1/B2 tile shapes and
                                     # the dynamic floor from the tune
                                     # cache (repro_torch.tuning)


def route(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEDispatchConfig):
    """The router projection (an fp32 ``torch.matmul``) and the executor's
    gating/top-k.  Returns (weights (T, k) f32, indices (T, k) i32, logits
    (T, E) f32)."""
    logits = torch.matmul(x.float(), w_router.float())
    weights, indices = get_executor(cfg.executor).route(logits, cfg)
    return weights, indices, logits


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate, w_up, w_down,
            cfg: MoEDispatchConfig):
    """Full dispatch pipeline.  x: (T, d) -> (y: (T, d), aux dict).  The
    expert stacks are (E, K, N) tensors of x's dtype or ``QuantTensor``s."""
    plan = plan_dispatch(x, w_router, cfg)
    y = execute(plan, x, {"w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                cfg)
    return y.to(x.dtype), plan.aux
