"""``cuda`` executor: the paper's technique as hand-written CUDA kernels
(counterpart of ``repro.execution.pallas``).

It composes the five kernels phase for phase: ``router_topk`` ->
``permute`` -> ``fused_gate_up`` (or, unfused, two ``grouped_gemm`` calls
and an fp32 SiLU product) -> ``grouped_gemm`` down projection with the
folded combine weights -> ``unpermute``.  The schedule arrays are kernel
arguments read by each thread block, so there is no host round trip.  On
CPU tensors every wrapper runs its plain version.

Quantized expert weights pass through ``prepare_weights`` untouched: the
GEMM kernels take the compressed payload and its per-channel scales and
dequantize each weight tile on chip, so no dense stack is ever built.

``cfg.autotune`` makes every B1 and B2 call, the unfused arm's too, run the
tune cache's tile shape for its shape key (``ops.grouped_gemm``).

Each phase goes through ``kernels.autograd``: where an input needs a
gradient (training), the backward runs on the kernels as well (B1 with its
weight read transposed for dX, B7 for every expert weight gradient);
otherwise the call is the plain ``ops`` wrapper, as when serving."""
from __future__ import annotations

import torch

from repro_torch.execution.base import Executor, register_executor
from repro_torch.kernels import autograd as ag


@register_executor("cuda")
class CudaExecutor(Executor):

    def prepare_weights(self, w, cfg):
        return w            # in-kernel dequant: ops splits payload + scales

    def route(self, logits, cfg):
        return ag.router_topk(logits, top_k=cfg.top_k, gating=cfg.gating,
                              norm_topk=cfg.norm_topk,
                              routed_scale=cfg.routed_scale)

    def permute(self, x, sched, cfg):
        return ag.permute(x, sched)

    def expert_ffn(self, xp, w, sched, cfg, row_scale=None):
        at = cfg.autotune
        if cfg.fuse_gate_up:
            h = ag.fused_gate_up(xp, w["w_gate"], w["w_up"], sched,
                                 autotune=at)
        else:
            g = ag.grouped_gemm(xp, w["w_gate"], sched, autotune=at)
            u = ag.grouped_gemm(xp, w["w_up"], sched, autotune=at)
            gf = g.float()
            h = ((gf * torch.sigmoid(gf)) * u.float()).to(xp.dtype)
        return ag.grouped_gemm(h, w["w_down"], sched, row_scale=row_scale,
                               autotune=at)

    def unpermute(self, y, sched, weights, cfg):
        return ag.unpermute(y, sched, weights)
