"""Autograd through the MoE kernels: one ``torch.autograd.Function`` per
schedule-level wrapper of ``ops``, whose forward launches the wrapper's
kernel and whose backward is built from the kernels too.

* ``router_topk``: forward B5; backward the (T, E) Jacobian product of the
  reference's gating (``repro.kernels.ref.router_ref``) at B5's indices:
  softmax (its max shift cancels) or sigmoid, the gather, the renorm
  ``/(sum + 1e-20)`` and ``routed_scale``, in torch.
* ``permute``: backward B4 unweighted, ``dx[t] = sum_c dxp[pos[t, c]]``.
* ``unpermute``: backward B3 of the output gradient (folded, unweighted);
  with combine weights, B3 scaled by each row's weight, and the weights'
  gradient ``<dout[t], y[pos[t, c]]>`` in torch.
* ``grouped_gemm`` (optional ``row_scale``): ``g = B1^T(dout, W)``,
  ``dx = row_scale * g``, ``d_row_scale = rowsum(x * g)`` (no recompute, no
  divide by a zero scale), ``dW = B7(x, row_scale * dout)``, written by B7
  in W's dtype (its fp32 sum rounded once, no separate cast pass).
* ``fused_gate_up``: recompute ``g = B1(x, Wg)`` and ``u = B1(x, Wu)``;
  ``dg = dh u silu'(g)`` and ``du = dh silu(g)`` in fp32; ``dWg = B7(x,
  dg)``, ``dWu = B7(x, du)``, ``dx = B1^T(dg, Wg) + B1^T(du, Wu)``.

``autotune`` (B1 and B2) picks the forward's tile shape from the tune
cache; the backward's kernels run at their own tiles and build their own
work lists (B1^T and B7 at 256 rows), so a tuned forward hands them
nothing cut at another row tile.

Each wrapper below calls ``ops`` directly when no input needs a gradient
(under ``torch.no_grad``, or with frozen weights), so serving launches
exactly what it launched before.  Quantized expert stacks have no
backward: the reference trains dense stacks.  On CPU tensors every kernel
call runs its plain version through the same formulas.  Nothing here
synchronises the host with the card."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.quantization import QuantTensor
from repro_torch.scheduling import BlockSchedule, combine_scale_rows


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _dense(*ws) -> None:
    if any(isinstance(w, QuantTensor) for w in ws):
        raise NotImplementedError(
            "quantized expert weights have no backward: train dense stacks "
            "and quantize for serving")


def router_vjp(logits: torch.Tensor, indices: torch.Tensor, dw: torch.Tensor,
               *, gating: str, norm_topk: bool, routed_scale: float
               ) -> torch.Tensor:
    """d loss / d logits from d loss / d weights, for weights = (renormed)
    gate scores at ``indices``, times ``routed_scale``."""
    x = logits.float()
    if gating == "softmax":
        s = torch.softmax(x, dim=-1)
    elif gating == "sigmoid":
        s = torch.sigmoid(x)
    else:
        raise ValueError(f"unknown gating {gating!r}")
    idx = indices.long()
    g = dw.float() * routed_scale
    if norm_topk:
        raw = s.gather(1, idx)
        tot = raw.sum(dim=-1, keepdim=True) + 1e-20
        g = g / tot - (g * raw).sum(dim=-1, keepdim=True) / (tot * tot)
    ds = torch.zeros_like(s).scatter_add_(1, idx, g)
    if gating == "softmax":
        dx = s * (ds - (ds * s).sum(dim=-1, keepdim=True))
    else:
        dx = ds * s * (1.0 - s)
    return dx.to(logits.dtype)


class _RouterTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, top_k, gating, norm_topk, routed_scale):
        weights, indices = ops.router_topk(logits, top_k=top_k, gating=gating,
                                           norm_topk=norm_topk,
                                           routed_scale=routed_scale)
        ctx.save_for_backward(logits, indices)
        ctx.kw = dict(gating=gating, norm_topk=norm_topk,
                      routed_scale=routed_scale)
        ctx.mark_non_differentiable(indices)
        return weights, indices

    @staticmethod
    def backward(ctx, dw, _):
        logits, indices = ctx.saved_tensors
        return (router_vjp(logits, indices, dw, **ctx.kw), None, None, None,
                None)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sched):
        ctx.sched = sched
        return ops.permute(x, sched)

    @staticmethod
    def backward(ctx, dxp):
        return ops.unpermute(dxp.contiguous(), ctx.sched, None), None


class _Unpermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, weights, sched):
        ctx.sched = sched
        ctx.save_for_backward(y, weights)
        return ops.unpermute(y, sched, weights)

    @staticmethod
    def backward(ctx, dout):
        y, weights = ctx.saved_tensors
        sched = ctx.sched
        dout = dout.contiguous()
        dy = ops.permute(dout, sched)
        if weights is None:
            return dy, None, None
        dw = None
        if ctx.needs_input_grad[1]:
            T, k = sched.pos.shape
            g = y.index_select(0, sched.pos.reshape(-1).long()).reshape(
                T, k, -1).float()
            dw = (g * dout.float()[:, None, :]).sum(dim=-1)
        rows = combine_scale_rows(sched, weights)
        dy = (dy.float() * rows[:, None]).to(y.dtype)
        return dy, dw, None


class _GroupedGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, row_scale, sched, autotune):
        ctx.sched = sched
        ctx.save_for_backward(x, w, row_scale)
        return ops.grouped_gemm(x, w, sched, row_scale=row_scale,
                                autotune=autotune)

    @staticmethod
    def backward(ctx, dout):
        x, w, rs = ctx.saved_tensors
        sched = ctx.sched
        need_x, need_w, need_rs = ctx.needs_input_grad[:3]
        dout = dout.contiguous()
        dx = dw = drs = None
        if need_x or need_rs:
            g = ops.grouped_gemm_t(dout, w, sched)
            if rs is None:
                dx = g
            else:
                gf = g.float()
                dx = (gf * rs[:, None]).to(x.dtype) if need_x else None
                drs = (x.float() * gf).sum(dim=-1) if need_rs else None
        if need_w:
            dy = dout if rs is None \
                else (dout.float() * rs[:, None]).to(dout.dtype)
            dw = ops.grouped_wgrad(x, dy, sched, w.shape[0],
                                   out_dtype=w.dtype)
        return dx, dw, drs, None, None


class _FusedGateUp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_gate, w_up, sched, autotune):
        ctx.sched = sched
        ctx.save_for_backward(x, w_gate, w_up)
        return ops.fused_gate_up(x, w_gate, w_up, sched, autotune=autotune)

    @staticmethod
    def backward(ctx, dh):
        x, wg, wu = ctx.saved_tensors
        sched = ctx.sched
        g = ops.grouped_gemm(x, wg, sched).float()
        u = ops.grouped_gemm(x, wu, sched).float()
        sig = torch.sigmoid(g)
        dhf = dh.float()
        du = (dhf * g * sig).to(x.dtype)
        dg = (dhf * u * sig * (1.0 + g * (1.0 - sig))).to(x.dtype)
        dx = dwg = dwu = None
        if ctx.needs_input_grad[0]:
            dx = (ops.grouped_gemm_t(dg, wg, sched).float()
                  + ops.grouped_gemm_t(du, wu, sched).float()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dwg = ops.grouped_wgrad(x, dg, sched, wg.shape[0],
                                    out_dtype=wg.dtype)
        if ctx.needs_input_grad[2]:
            dwu = ops.grouped_wgrad(x, du, sched, wu.shape[0],
                                    out_dtype=wu.dtype)
        return dx, dwg, dwu, None, None


def router_topk(logits: torch.Tensor, *, top_k: int, gating: str = "softmax",
                norm_topk: bool = False, routed_scale: float = 1.0):
    if not _needs_grad(logits):
        return ops.router_topk(logits, top_k=top_k, gating=gating,
                               norm_topk=norm_topk, routed_scale=routed_scale)
    return _RouterTopK.apply(logits, top_k, gating, norm_topk, routed_scale)


def permute(x: torch.Tensor, sched: BlockSchedule) -> torch.Tensor:
    if not _needs_grad(x):
        return ops.permute(x, sched)
    return _Permute.apply(x, sched)


def unpermute(y: torch.Tensor, sched: BlockSchedule,
              weights: Optional[torch.Tensor]) -> torch.Tensor:
    if not _needs_grad(y, weights):
        return ops.unpermute(y, sched, weights)
    return _Unpermute.apply(y, weights, sched)


def grouped_gemm(x: torch.Tensor, w, sched: BlockSchedule,
                 row_scale: Optional[torch.Tensor] = None, *,
                 autotune: bool = False) -> torch.Tensor:
    if not _needs_grad(x, w, row_scale):
        return ops.grouped_gemm(x, w, sched, row_scale=row_scale,
                                autotune=autotune)
    _dense(w)
    return _GroupedGemm.apply(x, w, row_scale, sched, autotune)


def fused_gate_up(x: torch.Tensor, w_gate, w_up, sched: BlockSchedule, *,
                  autotune: bool = False) -> torch.Tensor:
    if not _needs_grad(x, w_gate, w_up):
        return ops.fused_gate_up(x, w_gate, w_up, sched, autotune=autotune)
    _dense(w_gate, w_up)
    return _FusedGateUp.apply(x, w_gate, w_up, sched, autotune)
