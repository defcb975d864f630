"""Schedule-level wrappers for the five MoE kernels (counterpart of
``repro.kernels.ops``): each adapts a ``BlockSchedule`` to its kernel's
arguments.  Block sizes are the kernels' own (csrc/); nothing here carries
the TPU's (8, 128) tiling over.

``LAUNCHES`` holds one launch counter per kernel, the paged-attention
kernel's too (the wrappers increment it where they launch);
``reset_launches`` sets them all to 0."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_gate_up as _fgu
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import permute as _perm
from repro_torch.kernels import router_topk as _router
from repro_torch.kernels import unpermute as _unperm
from repro_torch.scheduling import BlockSchedule

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches


def router_topk(logits: torch.Tensor, *, top_k: int, gating: str = "softmax",
                norm_topk: bool = False, routed_scale: float = 1.0):
    return _router.router_topk(logits, top_k=top_k, gating=gating,
                               norm_topk=norm_topk, routed_scale=routed_scale)


def permute(x: torch.Tensor, sched: BlockSchedule) -> torch.Tensor:
    return _perm.permute(x, sched.src_tok)


def unpermute(y: torch.Tensor, sched: BlockSchedule,
              weights: Optional[torch.Tensor]) -> torch.Tensor:
    return _unperm.unpermute(y, sched.pos, weights)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, sched: BlockSchedule,
                 row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _gg.grouped_gemm(x, w, sched.block_expert, sched.block_active,
                            block_m=sched.block_m, row_scale=row_scale)


def fused_gate_up(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  sched: BlockSchedule) -> torch.Tensor:
    return _fgu.fused_gate_up(x, w_gate, w_up, sched.block_expert,
                              sched.block_active, block_m=sched.block_m)
