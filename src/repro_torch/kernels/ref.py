"""Plain PyTorch oracles for every kernel, on a ``BlockSchedule``
(counterpart of ``repro.kernels.ref``).

Each is the plain version that sits beside its kernel
(``router_topk_plain``, ``permute_plain``, ...), called on any device: the
CPU tests hold them against ``repro.kernels.ref`` and the interpret-mode
Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.  The GEMM helpers take dense stacks or ``QuantTensor``s, split as
the kernels' wrappers split them (``ops._weight_operands``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_gate_up import fused_gate_up_plain
from repro_torch.kernels.grouped_gemm import (grouped_gemm_plain,
                                              grouped_gemm_t_plain)
from repro_torch.kernels.grouped_wgrad import grouped_wgrad_plain
from repro_torch.kernels.ops import _weight_operands
from repro_torch.kernels.permute import permute_plain
from repro_torch.kernels.router_topk import router_topk_plain
from repro_torch.kernels.unpermute import unpermute_plain
from repro_torch.scheduling import BlockSchedule


def router_ref(logits: torch.Tensor, top_k: int, *, gating: str = "softmax",
               norm_topk: bool = False, routed_scale: float = 1.0):
    return router_topk_plain(logits, top_k, gating=gating,
                             norm_topk=norm_topk, routed_scale=routed_scale)


def permute_ref(x: torch.Tensor, sched: BlockSchedule) -> torch.Tensor:
    return permute_plain(x, sched.src_tok)


def unpermute_ref(y: torch.Tensor, sched: BlockSchedule,
                  weights: Optional[torch.Tensor]) -> torch.Tensor:
    return unpermute_plain(y, sched.pos, weights)


def grouped_gemm_ref(x: torch.Tensor, w, sched: BlockSchedule,
                     row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    wq, ws, fmt = _weight_operands(w)
    return grouped_gemm_plain(x, wq, sched.block_expert, sched.block_active,
                              block_m=sched.block_m, row_scale=row_scale,
                              w_scale=ws, w_format=fmt)


def fused_gate_up_ref(x: torch.Tensor, w_gate, w_up,
                      sched: BlockSchedule) -> torch.Tensor:
    wgq, wsg, fmt = _weight_operands(w_gate)
    wuq, wsu, _ = _weight_operands(w_up)
    return fused_gate_up_plain(x, wgq, wuq, sched.block_expert,
                               sched.block_active, block_m=sched.block_m,
                               wg_scale=wsg, wu_scale=wsu, w_format=fmt)


def grouped_gemm_t_ref(x: torch.Tensor, w: torch.Tensor,
                       sched: BlockSchedule) -> torch.Tensor:
    return grouped_gemm_t_plain(x, w, sched.block_expert, sched.block_active,
                                block_m=sched.block_m)


def grouped_wgrad_ref(x: torch.Tensor, dy: torch.Tensor,
                      sched: BlockSchedule, n_experts: int,
                      out_dtype=torch.float32) -> torch.Tensor:
    return grouped_wgrad_plain(x, dy, sched.block_expert, sched.block_active,
                               block_m=sched.block_m,
                               n_experts=n_experts).to(out_dtype)


def moe_ffn_dense_ref(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      weights: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, combined with the routing mask: y_t =
    sum_j w_tj * FFN_{e_tj}(x_t), in fp32, returned in x's dtype (the
    paper's "PyTorch reference" baseline; O(T*E*ffn) compute).  x: (T, d);
    w_gate/w_up: (E, d, f); w_down: (E, f, d); weights/indices: (T, k).

    The (T, k, E) mask compares ``indices`` with an ``arange`` of the
    experts: ``F.one_hot`` checks its index range on the host, which on
    the card waits for the device."""
    xf = x.float()
    g = torch.einsum("td,edf->tef", xf, w_gate.float())
    u = torch.einsum("td,edf->tef", xf, w_up.float())
    h = (g * torch.sigmoid(g)) * u
    y_all = torch.einsum("tef,efd->ted", h, w_down.float())       # (T, E, d)
    experts = torch.arange(w_gate.shape[0], device=indices.device)
    mask = (indices.long()[..., None] == experts).float()         # (T, k, E)
    combine = torch.einsum("tk,tke->te", weights.float(), mask)
    return torch.einsum("te,ted->td", combine, y_all).to(x.dtype)
