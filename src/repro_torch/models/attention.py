"""Attention: q/k/v projections, causal prefill attention and decode
attention against contiguous cache rows (counterpart of
``repro.models.attention``).

The reference computes attention in pure jnp (chunked online softmax), so
there is no TPU kernel to port: this is plain PyTorch, with the scores in
fp32.  At the port's serving sizes the (S, S) or (1, capacity) score tensor
is small, so it is formed whole instead of chunked."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.blocks import dense_init

NEG_INF = -1e30  # finite -inf stand-in, as in the reference


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, gen, dtype, device):
        super().__init__()
        self.wq = dense_init(gen, (d_model, n_heads * head_dim), dtype, device)
        self.wk = dense_init(gen, (d_model, n_kv_heads * head_dim), dtype,
                             device)
        self.wv = dense_init(gen, (d_model, n_kv_heads * head_dim), dtype,
                             device)
        self.wo = dense_init(gen, (n_heads * head_dim, d_model), dtype, device)


def project_qkv(p: Attention, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                head_dim: int):
    """x: (B, S, d) -> q (B, S, H, D), k and v (B, S, Hkv, D)."""
    dt = x.dtype
    B, S, _ = x.shape
    q = torch.matmul(x, p.wq.to(dt)).reshape(B, S, n_heads, head_dim)
    k = torch.matmul(x, p.wk.to(dt)).reshape(B, S, n_kv_heads, head_dim)
    v = torch.matmul(x, p.wv.to(dt)).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, kv_limit: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); kv_limit: (B,) inclusive
    last attended key position (decode).  GQA groups Hq // Hkv query heads
    per key head.  Returns (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = torch.tensor(D ** -0.5, dtype=q.dtype, device=q.device)
    qg = (q * scale).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    mask = mask[None, None, None]
    if kv_limit is not None:
        mask = mask & (kpos[None, None, None, None, :]
                       <= kv_limit[:, None, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, Hq, -1).to(q.dtype)


def write_decode_rows(cache: torch.Tensor, val: torch.Tensor,
                      pos: torch.Tensor) -> None:
    """In place: cache[b, pos[b]] = val[b, 0].  cache: (B, S, ...); val:
    (B, 1, ...); pos: (B,).  A position past the cache is dropped, as the
    reference's scatter drops it (the engine retires such rows first)."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    idx = torch.clamp(pos, max=S - 1).long()
    new = val[:, 0].to(cache.dtype)
    keep = (pos < S).reshape((B,) + (1,) * (new.dim() - 1))
    cache[rows, idx] = torch.where(keep, new, cache[rows, idx])
