"""Attention: q/k/v projections, causal prefill attention, decode attention
against contiguous cache rows, and the paged write and read over a KV
block pool (counterpart of ``repro.models.attention``).

The reference computes attention in pure jnp (chunked online softmax), so
there is no TPU kernel to port for it: this is plain PyTorch, with the
scores in fp32.  At the port's serving sizes the (S, S) or (1, capacity)
score tensor is small, so it is formed whole instead of chunked.  The
paged read has two paths: the fused one runs the paged decode-attention
kernel over the pool (``kernels/paged_attention.py``); the gather path
reassembles each row's view with ``gather_block_kv`` and runs the plain
``attention``, the oracle."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.paged_attention import (gather_block_kv,
                                                  paged_decode_attention)
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
              causal: bool, kv_limit: Optional[torch.Tensor] = None,
              logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); kv_limit: (B,) inclusive
    last attended key position (decode).  GQA groups Hq // Hkv query heads
    per key head.  Returns (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = torch.tensor(D ** -0.5, dtype=q.dtype, device=q.device)
    qg = (q * scale).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
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
    # the reference's flash form: unnormalised p (cast to v's dtype for the
    # PV product), divided by its fp32 sum at the end
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)[..., None].movedim(3, 1)          # (B, Sq, Hkv, G, 1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = torch.where(l > 0, out / torch.clamp(l, min=1e-30),
                      torch.zeros_like(out))
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


def scatter_block_rows(pool: torch.Tensor, val: torch.Tensor,
                       tables: torch.Tensor, pos: torch.Tensor) -> None:
    """Paged write, in place: token b lands at physical ``(tables[b,
    pos[b] // bs], pos[b] % bs)``.  pool: (n_blocks, bs, ...); val: (B, 1,
    ...); tables: (B, nb); pos: (B,).  The engine keeps one step's (block,
    offset) pairs distinct.  A position past the row's table (nb * bs) is
    dropped, as the reference's scatter drops it: its row writes back what
    its clamped target already holds."""
    bs, nb = pool.shape[1], tables.shape[1]
    pos = pos.long()
    logical = pos // bs
    blk = torch.gather(tables.long(), 1,
                       torch.clamp(logical, 0, nb - 1)[:, None])[:, 0]
    off = pos % bs
    new = val[:, 0].to(pool.dtype)
    keep = (logical < nb).reshape((-1,) + (1,) * (new.dim() - 1))
    pool[blk, off] = torch.where(keep, new, pool[blk, off])


def paged_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pool: dict, tables: torch.Tensor, pos: torch.Tensor, *,
                 fused: bool, logit_softcap: Optional[float] = None
                 ) -> torch.Tensor:
    """One token per row over the block pool: write this step's K/V for
    every row first, then read.  q: (B, 1, H, D); k, v: (B, 1, Hkv, D);
    pool: {"k", "v"} (n_blocks, bs, Hkv, D); pos: (B,) positions, each
    row's inclusive kv_limit.  Returns (B, 1, H, Dv) in q's dtype.

    The fused read omits ``window``, exactly as the reference's fused call
    does (its decode flash call runs with query position 0, which makes the
    window term inert)."""
    scatter_block_rows(pool["k"], k, tables, pos)
    scatter_block_rows(pool["v"], v, tables, pos)
    B, _, H, D = q.shape
    if fused:
        Hkv = pool["k"].shape[2]
        qf = q[:, 0].reshape(B, Hkv, H // Hkv, D)
        out = paged_decode_attention(qf, pool["k"], pool["v"], tables, pos,
                                     scale=D ** -0.5,
                                     logit_softcap=logit_softcap)
        return out.reshape(B, 1, H, -1).to(q.dtype)
    kg = gather_block_kv(pool["k"], tables).to(q.dtype)
    vg = gather_block_kv(pool["v"], tables).to(q.dtype)
    return attention(q, kg, vg, causal=False, kv_limit=pos,
                     logit_softcap=logit_softcap)
