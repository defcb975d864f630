"""Attention: q/k/v projections, chunked ("flash") prefill attention,
decode attention against contiguous cache rows, and the paged write and
read over a KV block pool (counterpart of ``repro.models.attention``).

The reference computes attention in pure jnp (chunked online softmax), so
there is no TPU kernel to port for it: this is plain PyTorch, with the
scores in fp32.  ``flash_attention`` is the reference's chunked form: a
loop over query chunks, and for each an online softmax over KV chunks, so
a prompt's (S, S) score never exists whole.  ``attention`` forms the whole
score in one pass; it is the plain version the chunked form is held
against and the read of the paged gather path (the oracle).  The paged
read has two paths: the fused one runs the paged decode-attention kernel
over the pool (``kernels/paged_attention.py``); the gather path
reassembles each row's view with ``gather_block_kv`` and runs
``attention``."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.paged_attention import (gather_block_kv,
                                                  paged_decode_attention)
from repro_torch.models.blocks import dense_init, frozen, part, softcap

NEG_INF = -1e30  # finite -inf stand-in, as in the reference


class Attention(nn.Module):
    """The reference's ``init_attn`` leaves: ``wq``, ``wk``, ``wv``, ``wo``
    and, with ``bias``, zero ``bq``, ``bk``, ``bv``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, gen, dtype, device, bias: bool = False):
        super().__init__()
        self.wq = dense_init(gen, (d_model, n_heads * head_dim), dtype, device)
        self.wk = dense_init(gen, (d_model, n_kv_heads * head_dim), dtype,
                             device)
        self.wv = dense_init(gen, (d_model, n_kv_heads * head_dim), dtype,
                             device)
        self.wo = dense_init(gen, (n_heads * head_dim, d_model), dtype, device)
        if bias:
            for name, n in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
                setattr(self, name, frozen(torch.zeros(
                    n * head_dim, dtype=dtype, device=device)))


def project_qkv(p: Attention, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                head_dim: int, xkv: Optional[torch.Tensor] = None):
    """x: (B, S, d), the queries' source; xkv: (B, Skv, d), the keys' and
    values' source (x itself unless given: a cross-attention block passes
    the image embeddings) -> q (B, S, H, D), k and v (B, Skv, Hkv, D); the
    biases are added after the products, in x's dtype."""
    dt = x.dtype
    xkv = x if xkv is None else xkv
    B, S, _ = x.shape
    Skv = xkv.shape[1]
    q = torch.matmul(x, p.wq.to(dt))
    k = torch.matmul(xkv, p.wk.to(dt))
    v = torch.matmul(xkv, p.wv.to(dt))
    if hasattr(p, "bq"):
        q, k, v = q + p.bq.to(dt), k + p.bk.to(dt), v + p.bv.to(dt)
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, Skv, n_kv_heads, head_dim),
            v.reshape(B, Skv, n_kv_heads, head_dim))


def head_part(p: Attention, hs: slice, kvs: slice, head_dim: int):
    """``p``'s leaves for the query heads ``hs`` and the KV heads ``kvs``
    (a rank's heads under tensor-parallel heads): the columns of ``wq``,
    ``wk``, ``wv`` and their biases, the rows of ``wo``; ``project_qkv``
    and the output projection take it in ``p``'s place."""
    def ch(sl: slice) -> slice:
        return slice(sl.start * head_dim, sl.stop * head_dim)
    out = {"wq": part(p.wq, ch(hs)), "wk": part(p.wk, ch(kvs)),
           "wv": part(p.wv, ch(kvs)), "wo": part(p.wo, ch(hs), 0)}
    if hasattr(p, "bq"):
        out.update(bq=part(p.bq, ch(hs)), bk=part(p.bk, ch(kvs)),
                   bv=part(p.bv, ch(kvs)))
    return SimpleNamespace(**out)


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """``q * D**-0.5`` with the scale rounded to q's dtype, as the
    reference's ``q * asarray(scale, q.dtype)``."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype,
                            device=q.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0,
                    kv_limit: Optional[torch.Tensor] = None,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    return_stats: bool = False):
    """The reference's chunked online-softmax attention.  q: (B, Sq, Hq,
    D); k, v: (B, Skv, Hkv, D | Dv); kv_limit: (B,) inclusive last attended
    key position.  Query i and key j sit at positions ``q_offset + i`` and
    ``kv_offset + j`` (a rank's sequence block passes its global offsets):
    ``causal`` keeps key positions <= the query's, ``window`` keeps those
    > the query's - window.  Returns (B, Sq, Hq, Dv) in q's dtype; with
    ``return_stats`` the unnormalised fp32 (acc (B, Hkv, G, Sq, Dv), sum
    of exponentials l and row max m (B, Hkv, G, Sq)) instead, for
    ``combine_stats`` over KV blocks.

    The reference's order of operations: q scaled in its dtype, scores in
    fp32, the softcap, the masks, ``p`` rounded to V's dtype before the PV
    product, and at the end the ``l > 0`` divide.  Two differences, neither
    of which moves a float beyond summation order:

    * chunks of ``q_chunk`` and ``kv_chunk`` positions with a ragged last
      one (the reference cuts each axis into its largest divisor <= the
      target, which is one position for a prime length);
    * a KV chunk that the causal or window mask removes whole is skipped:
      in the reference it leaves the running (max, sum, acc) unchanged, and
      skipping it keeps a windowed layer O(S x window); a chunk the masks
      keep whole is not masked."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    qc, kc = max(1, min(q_chunk, Sq)), max(1, min(kv_chunk, Skv))
    dev = q.device
    # q as a (B, Hkv, G, Sq, D) view in its dtype; a query chunk of it and
    # a KV chunk of k and v are cast to fp32 as the loops reach them (every
    # product of the dtype's values is exact there, the sums fp32), so no
    # fp32 copy of the whole q, k or v exists
    qs = _scaled_q(q).reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    lim = None if kv_limit is None else kv_limit.reshape(B, 1, 1, 1, 1)
    outs, stats = [], []
    for q0 in range(0, Sq, qc):
        q1 = min(q0 + qc, Sq)
        n = q1 - q0
        qb = qs[:, :, :, q0:q1].float().reshape(B, Hkv, G * n, D)
        p0, p1 = q_offset + q0, q_offset + q1      # the chunk's positions
        qpos = torch.arange(p0, p1, device=dev)
        m = torch.full((B, Hkv, G, n), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, n, Dv), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Skv, kc):
            k1 = min(k0 + kc, Skv)
            j0, j1 = kv_offset + k0, kv_offset + k1
            if causal and j0 > p1 - 1:
                break                          # past every query: all masked
            if window is not None and j1 - 1 <= p0 - window:
                continue                       # before every query's window
            kb = k[:, k0:k1].float().permute(0, 2, 3, 1)   # (B, Hkv, D, kc)
            s = torch.matmul(qb, kb)
            s = softcap(s, logit_softcap).reshape(B, Hkv, G, n, k1 - k0)
            # the causal or window mask cuts this chunk somewhere
            partial = ((causal and j1 - 1 > p0)
                       or (window is not None and j0 <= p1 - 1 - window))
            mask = None
            if partial or lim is not None:
                kpos = torch.arange(j0, j1, device=dev)
            if partial:
                mask = torch.ones((n, k1 - k0), dtype=torch.bool, device=dev)
                if causal:
                    mask = mask & (kpos[None, :] <= qpos[:, None])
                if window is not None:
                    mask = mask & (kpos[None, :] > qpos[:, None] - window)
            if lim is not None:
                within = kpos <= lim
                mask = within if mask is None else mask & within
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).float().reshape(B, Hkv, G * n,
                                                           k1 - k0),
                              v[:, k0:k1].float().permute(0, 2, 1, 3))
            acc = corr[..., None] * acc + pv.reshape(B, Hkv, G, n, Dv)
            m = m_new
        if return_stats:
            stats.append((acc, l, m))
            continue
        o = torch.where(l[..., None] > 0,
                        acc / torch.clamp(l[..., None], min=1e-30),
                        torch.zeros_like(acc))
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, n, Hq, Dv)
                    .to(q.dtype))
    if return_stats:
        acc, l, m = (torch.cat(t, dim=3) for t in zip(*stats))
        return acc, l, m
    return torch.cat(outs, dim=1)


def combine_stats(acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                  group) -> torch.Tensor:
    """LSE-combine partial attention stats over the ranks of ``group``
    (flash-decode): each rank holds ``flash_attention(...,
    return_stats=True)`` of its KV block; the result, (B, Hkv, G, Sq, Dv)
    fp32, is attention over the whole KV.  The max runs over the group,
    then two sums."""
    m_g = group.all_reduce(m, "max")
    corr = torch.exp(m - m_g)
    l_g = group.all_reduce(l * corr)
    acc_g = group.all_reduce(acc * corr[..., None])
    return torch.where(l_g[..., None] > 0,
                       acc_g / torch.clamp(l_g[..., None], min=1e-30),
                       torch.zeros_like(acc_g))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, kv_limit: Optional[torch.Tensor] = None,
              window: Optional[int] = None,
              logit_softcap: Optional[float] = None) -> torch.Tensor:
    """The whole score in one pass, the plain version of
    ``flash_attention`` (same masks and positions).  q: (B, Sq, Hq, D); k,
    v: (B, Skv, Hkv, D); kv_limit: (B,) inclusive last attended key
    position (decode).  GQA groups Hq // Hkv query heads per key head.
    Returns (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _scaled_q(q).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = softcap(s, logit_softcap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
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

    Neither read applies a sliding window, as in the reference (ROADMAP
    C1): its fused call omits ``window``, and its gather path's decode
    flash call runs with query position 0, where the window term is
    inert."""
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
