"""Fused gating + top-k router (counterpart of ``repro.kernels.router_topk``;
kernel in ``csrc/router_topk.cu``).

Row-max-stable softmax or sigmoid over fp32 logits, then the k largest
scores with ties to the lowest expert index: the order of the reference's k
rounds of argmax, each pick masked to -inf.  The weight is the unmasked
score; optional renormalisation ``/(sum + 1e-20)``, then ``*
routed_scale``.  The kernel takes all k picks in one pass by ranking
(``router_topk_walk`` models it)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, shapes


def _gate(logits: torch.Tensor, gating: str) -> torch.Tensor:
    x = logits.float()
    if gating == "softmax":
        x = x - x.max(dim=-1, keepdim=True).values
        e = torch.exp(x)
        return e / e.sum(dim=-1, keepdim=True)
    if gating == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown gating {gating!r}")


def router_topk_plain(logits: torch.Tensor, top_k: int, *,
                      gating: str = "softmax", norm_topk: bool = False,
                      routed_scale: float = 1.0):
    """logits: (T, E) -> (weights (T, k) f32, indices (T, k) i32)."""
    scores = _gate(logits, gating)
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


def router_layout(E: int) -> tuple:
    """How the kernel lays out a row of ``E`` experts: (lanes a row, keys a
    lane).  E <= 32: the next power of two lanes, one key each (32 / lanes
    rows a warp); wider rows take a warp, expert ``lane + 32 c`` in key
    c."""
    if E <= 32:
        return 1 << (E - 1).bit_length(), 1
    return 32, -(-E // 32)


def router_topk_walk(logits: torch.Tensor, top_k: int, *,
                     gating: str = "softmax", norm_topk: bool = False,
                     routed_scale: float = 1.0):
    """The kernel's selection in plain PyTorch: each score and its expert as
    one key (the score's bits over ~expert, so equal scores order by the
    lower expert), the k largest keys by rank; past 32 experts only the keys
    at or above tau, the k-th largest of the 32 lanes' largest keys, are
    candidates, each ranked among the candidates.  Renormalises by the k
    weights summed in slot order.  Same result as ``router_topk_plain``."""
    scores = _gate(logits, gating)
    T, E = scores.shape
    lanes, per = router_layout(E)
    expert = torch.arange(lanes * per).reshape(per, lanes)
    live = expert < E
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    assert (bits >= 0).all(), "scores are never negative"
    row_keys = (bits << 32) | (0xFFFFFFFF - torch.arange(E))
    keys = torch.zeros((T, per, lanes), dtype=torch.int64)
    keys[:, live] = row_keys[:, expert[live]]
    if E <= 32:
        cand = keys.reshape(T, -1)
    else:
        lane_max = keys.max(dim=1).values                       # (T, 32)
        lane_rank = (lane_max[:, None, :] > lane_max[:, :, None]).sum(-1)
        tau = lane_max[lane_rank == top_k - 1]                  # one a row
        assert tau.shape == (T,)
        cand = torch.where(keys >= tau[:, None, None], keys, -1).reshape(T,
                                                                          -1)
        n = (cand >= 0).sum(-1)
        assert (n <= (top_k - 1) * per + 1).all()
    rank = (cand[:, None, :] > cand[:, :, None]).sum(-1)
    pick = (cand >= 0) & (rank < top_k)
    assert (pick.sum(-1) == top_k).all()
    order = torch.argsort(torch.where(pick, rank, top_k), dim=-1,
                          stable=True)[:, :top_k]
    chosen = cand.gather(-1, order)
    indices = (0xFFFFFFFF - (chosen & 0xFFFFFFFF)).to(torch.int32)
    weights = (chosen >> 32).to(torch.int32).view(torch.float32)
    if norm_topk:
        tot = torch.zeros(T)
        for j in range(top_k):
            tot = tot + weights[:, j]
        weights = weights / (tot + 1e-20)[:, None]
    if routed_scale != 1.0:
        weights = weights * routed_scale
    return weights, indices


def router_topk(logits: torch.Tensor, *, top_k: int, gating: str = "softmax",
                norm_topk: bool = False, routed_scale: float = 1.0):
    """logits: (T, E) f32 -> (weights (T, k) f32, indices (T, k) i32).
    CPU tensors run the plain version; CUDA tensors the kernel."""
    if shapes.is_fake(logits):
        return shapes.router_topk_shape(logits, top_k)
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
