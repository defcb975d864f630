"""DeepSeek-V2 multi-head latent attention, MLA (counterpart of
``repro.models.mla``).

Prefill and training decompress the latent into per-head keys and values
and run the chunked causal ``flash_attention`` over the sequence, so that
no (S, S) score exists whole.  On a grid of ranks (sequence parallel over
'model') each rank gathers the latent (``c_kv`` and the rotated ``k_rope``,
576 values a token) over 'model' and decompresses every position itself:
decompression is per token, so this is the decompressed K and V of the
whole sequence at 1/71 of their bytes.  Decode keeps only the compressed
latent ``ckv`` (kv_lora_rank wide, RMS-normalised) and the shared rope key
``kr`` per position, and attends in the absorbed form: the no-rope query
is projected into the latent space (``q_eff``), so a score is ``q_eff .
ckv + q_rope . kr`` and the context stays in the latent space until the
final value projection.  The absorbed query is scaled twice in its own
dtype, as in the reference: by ``((r + dr) / (dn + dr)) ** 0.5`` here,
then by the attention's ``(r + dr) ** -0.5``; in bf16 each product
rounds.

The cache is written in place: ``{"ckv": (slots, capacity, r), "kr":
(slots, capacity, dr)}`` rows, or the same leaves as paged block pools
(n_blocks, block_size, ...) written through block tables.  The paged read
either gathers each row's latent view and runs the plain absorbed decode
(the oracle), or runs the paged decode-attention kernel straight off the
pools with ``kr`` as its second score operand and ``ckv`` as both key and
value (``_mla_fused_paged_decode``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import MLAConfig
from repro_torch.distributed.ctx import block_offset, constrain
from repro_torch.kernels.paged_attention import (gather_block_kv,
                                                  paged_decode_attention,
                                                  scale_q)
from repro_torch.models.attention import (attention, flash_attention,
                                          scatter_block_rows,
                                          write_decode_rows)
from repro_torch.models.blocks import RMSNorm, apply_norm, dense_init, rope

ROPE_THETA = 10_000.0      # the reference's MLA rope, whatever the config's


class MLA(nn.Module):
    """The reference's ``init_mla`` leaves, under the same names."""

    def __init__(self, d_model: int, n_heads: int, mla: MLAConfig, gen, dtype,
                 device):
        super().__init__()
        dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
        r = mla.kv_lora_rank
        self.wq_a = dense_init(gen, (d_model, mla.q_lora_rank), dtype, device)
        self.q_norm = RMSNorm(mla.q_lora_rank, device)
        self.wq_b = dense_init(gen, (mla.q_lora_rank, n_heads * (dn + dr)),
                               dtype, device)
        self.wkv_a = dense_init(gen, (d_model, r + dr), dtype, device)
        self.kv_norm = RMSNorm(r, device)
        self.wkv_b = dense_init(gen, (r, n_heads * (dn + dv)), dtype, device)
        self.wo = dense_init(gen, (n_heads * dv, d_model), dtype, device)


def _project_q(p: MLA, x: torch.Tensor, n_heads: int, mla: MLAConfig,
               positions):
    """x (B, S, d) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr)."""
    dn, dr = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    B, S, _ = x.shape
    cq = apply_norm(p.q_norm.scale, torch.matmul(x, p.wq_a.to(x.dtype)))
    q = torch.matmul(cq, p.wq_b.to(x.dtype)).reshape(B, S, n_heads, dn + dr)
    return q[..., :dn], rope(q[..., dn:], positions, ROPE_THETA)


def _latent(p: MLA, x: torch.Tensor, mla: MLAConfig, positions):
    """x -> (c_kv normalised (B, S, r), k_rope (B, S, dr))."""
    r = mla.kv_lora_rank
    ckv_full = torch.matmul(x, p.wkv_a.to(x.dtype))
    c_kv = apply_norm(p.kv_norm.scale, ckv_full[..., :r])
    k_rope = rope(ckv_full[..., r:][:, :, None, :], positions,
                  ROPE_THETA)[:, :, 0, :]
    return c_kv, k_rope


def _absorb(p: MLA, q_nope: torch.Tensor, n_heads: int, mla: MLAConfig):
    """-> (q_eff (B, 1, H, r), w_v (r, H, dv), the compensation scale,
    which ``scale_q`` applies in q's dtype)."""
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    r = mla.kv_lora_rank
    wkv_b = p.wkv_b.to(q_nope.dtype).reshape(r, n_heads, dn + dv)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    q_eff = torch.einsum("bthd,rhd->bthr", q_nope, w_k)
    # the absorbed attention scales by (r + dr)^-0.5; MLA by the
    # decompressed head's (dn + dr)^-0.5: pre-scale to compensate
    return q_eff, w_v, (r + dr) ** 0.5 / (dn + dr) ** 0.5


def mla_block(p: MLA, x: torch.Tensor, *, n_heads: int, mla: MLAConfig,
              positions, cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              paged_fused: bool = False, q_chunk: int = 512,
              kv_chunk: int = 512) -> torch.Tensor:
    """Returns the block's output (B, S, d).

    Without ``cache_pos`` (prefill and train): decompressed causal
    ``flash_attention`` over the S positions in chunks of ``q_chunk`` and
    ``kv_chunk``; the cache is not touched (``prefill_mla_cache`` writes
    it).  On a grid ``x`` is this rank's sequence block at ``positions``:
    the latent is gathered over 'model' (``constrain("kv_full")``, whose
    backward reduce-scatters) and the queries sit at the block's offset.
    With ``cache_pos`` (B,) (decode, S = 1): this step's latent row is
    written in place at each row's position, into ``cache``'s (B, S, ...)
    rows, or with ``block_tables`` (B, nb) into the pools, and the row
    attends to positions <= its own in the absorbed form."""
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    B, S, _ = x.shape
    dt = x.dtype
    q_nope, q_rope = _project_q(p, x, n_heads, mla, positions)
    c_kv, k_rope = _latent(p, x, mla, positions)

    if cache_pos is None:
        c_kv, k_rope = constrain("kv_full", c_kv), constrain("kv_full", k_rope)
        Skv = c_kv.shape[1]
        kv = torch.matmul(c_kv, p.wkv_b.to(dt)).reshape(B, Skv, n_heads,
                                                        dn + dv)
        k = torch.cat([kv[..., :dn],
                       k_rope[:, :, None, :].expand(B, Skv, n_heads, dr)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        out = flash_attention(q, k, kv[..., dn:], causal=True,
                              q_offset=block_offset(1, S), q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        return torch.matmul(out.reshape(B, S, n_heads * dv), p.wo.to(dt))

    kw = dict(n_heads=n_heads, mla=mla)
    if block_tables is not None:
        scatter_block_rows(cache["ckv"], c_kv, block_tables, cache_pos)
        scatter_block_rows(cache["kr"], k_rope, block_tables, cache_pos)
        if paged_fused:
            out = _mla_fused_paged_decode(p, q_nope, q_rope, cache["ckv"],
                                          cache["kr"], block_tables,
                                          cache_pos, **kw)
        else:
            out = mla_absorbed_decode(
                p, q_nope, q_rope,
                gather_block_kv(cache["ckv"], block_tables).to(dt),
                gather_block_kv(cache["kr"], block_tables).to(dt),
                kv_limit=cache_pos, **kw)
    else:
        write_decode_rows(cache["ckv"], c_kv, cache_pos)
        write_decode_rows(cache["kr"], k_rope, cache_pos)
        out = mla_absorbed_decode(p, q_nope, q_rope, cache["ckv"].to(dt),
                                  cache["kr"].to(dt), kv_limit=cache_pos,
                                  **kw)
    return torch.matmul(out.reshape(B, S, n_heads * dv), p.wo.to(dt))


def prefill_mla_cache(p: MLA, x: torch.Tensor, mla: MLAConfig, cache: dict,
                      positions) -> None:
    """The prompt's latent rows into cache rows [0, S), in place (the
    reference's ``_prefill_mla_cache``)."""
    c_kv, k_rope = _latent(p, x, mla, positions)
    S = x.shape[1]
    cache["ckv"][:, :S] = c_kv.to(cache["ckv"].dtype)
    cache["kr"][:, :S] = k_rope.to(cache["kr"].dtype)


def mla_absorbed_decode(p: MLA, q_nope: torch.Tensor, q_rope: torch.Tensor,
                        ckv: torch.Tensor, kr: torch.Tensor, *, n_heads: int,
                        mla: MLAConfig, kv_limit: torch.Tensor
                        ) -> torch.Tensor:
    """Absorbed attention over contiguous latent views.  q_nope (B, 1, H,
    dn), q_rope (B, 1, H, dr); ckv (B, S, r); kr (B, S, dr); kv_limit (B,)
    -> (B, 1, H, dv).  One KV head of depth r + dr serves all H query heads;
    ``ckv`` is also the value."""
    q_eff, w_v, comp = _absorb(p, q_nope, n_heads, mla)
    q_cat = scale_q(torch.cat([q_eff, q_rope], -1), comp)   # (B, 1, H, r+dr)
    k_cat = torch.cat([ckv, kr], -1)[:, :, None, :]         # (B, S, 1, r+dr)
    ctx = attention(q_cat, k_cat, ckv[:, :, None, :], causal=False,
                    kv_limit=kv_limit)                      # (B, 1, H, r)
    return torch.einsum("bthr,rhd->bthd", ctx, w_v)


def _mla_fused_paged_decode(p: MLA, q_nope: torch.Tensor,
                            q_rope: torch.Tensor, ckv_pool: torch.Tensor,
                            kr_pool: torch.Tensor, tables: torch.Tensor,
                            kv_limit: torch.Tensor, *, n_heads: int,
                            mla: MLAConfig) -> torch.Tensor:
    """Absorbed decode straight off the latent pools: the same absorbed
    query and the same two-step scale as ``mla_absorbed_decode`` over
    gathered views, with the scores in the paged decode-attention kernel
    (``q_eff . ckv + q_rope . kr``, ``ckv`` as the value).  Returns (B, 1,
    H, dv)."""
    dr, r = mla.qk_rope_head_dim, mla.kv_lora_rank
    q_eff, w_v, comp = _absorb(p, q_nope, n_heads, mla)
    # (B, 1, H, *) is the kernel's (B, Hkv=1, G=H, *) layout
    ckv4 = ckv_pool[:, :, None, :]
    ctx = paged_decode_attention(scale_q(q_eff, comp), ckv4, ckv4, tables,
                                 kv_limit, scale=(r + dr) ** -0.5,
                                 q2=scale_q(q_rope, comp),
                                 k2_pool=kr_pool[:, :, None, :])
    return torch.einsum("bthr,rhd->bthd", ctx.to(q_nope.dtype), w_v)
