"""Fused gating + iterative top-k router (counterpart of
``repro.kernels.router_topk``; kernel in ``csrc/router_topk.cu``).

Row-max-stable softmax or sigmoid over fp32 logits, then k rounds of argmax
with ties to the lowest expert index, each pick masked to -inf.  The weight
is the unmasked score; optional renormalisation ``/(sum + 1e-20)``, then
``* routed_scale``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def router_topk_plain(logits: torch.Tensor, top_k: int, *,
                      gating: str = "softmax", norm_topk: bool = False,
                      routed_scale: float = 1.0):
    """logits: (T, E) -> (weights (T, k) f32, indices (T, k) i32)."""
    x = logits.float()
    if gating == "softmax":
        x = x - x.max(dim=-1, keepdim=True).values
        e = torch.exp(x)
        scores = e / e.sum(dim=-1, keepdim=True)
    elif gating == "sigmoid":
        scores = torch.sigmoid(x)
    else:
        raise ValueError(f"unknown gating {gating!r}")
    T, E = scores.shape
    col = torch.arange(E, device=scores.device).expand(T, E)
    masked = scores
    idxs, ws = [], []
    for _ in range(top_k):
        mx = masked.max(dim=-1, keepdim=True).values
        idx = torch.where(masked == mx, col, E).min(dim=-1).values
        idxs.append(idx)
        ws.append(scores.gather(-1, idx[:, None])[:, 0])
        masked = masked.masked_fill(col == idx[:, None], float("-inf"))
    indices = torch.stack(idxs, dim=-1).to(torch.int32)
    weights = torch.stack(ws, dim=-1)
    if norm_topk:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    if routed_scale != 1.0:
        weights = weights * routed_scale
    return weights, indices


def router_topk(logits: torch.Tensor, *, top_k: int, gating: str = "softmax",
                norm_topk: bool = False, routed_scale: float = 1.0):
    """logits: (T, E) f32 -> (weights (T, k) f32, indices (T, k) i32).
    CPU tensors run the plain version; CUDA tensors the kernel."""
    if not _build.on_cuda(logits):
        return router_topk_plain(logits, top_k, gating=gating,
                                 norm_topk=norm_topk,
                                 routed_scale=routed_scale)
    _build.require(logits.dim() == 2 and logits.dtype == torch.float32
                   and logits.is_contiguous(),
                   "router_topk takes contiguous (T, E) float32 logits")
    T, E = logits.shape
    _build.require(E <= 256 and 0 < top_k <= min(E, 16),
                   f"router_topk takes E <= 256 and k <= 16 (E={E}, "
                   f"k={top_k})")
    _build.require(gating in ("softmax", "sigmoid"),
                   f"unknown gating {gating!r}")
    lib = _build.library()
    weights = torch.empty((T, top_k), dtype=torch.float32,
                          device=logits.device)
    indices = torch.empty((T, top_k), dtype=torch.int32, device=logits.device)
    err = lib.moe_router_topk(
        logits.data_ptr(), weights.data_ptr(), indices.data_ptr(), T, E,
        top_k, int(gating == "sigmoid"), int(norm_topk), float(routed_scale),
        _build.stream_ptr(logits.device))
    _build.check(err, "router_topk")
    _build.LAUNCHES["router_topk"] += 1
    return weights, indices
