"""RWKV6 "Finch": data-dependent-decay linear attention and channel mix
(counterpart of ``repro.models.rwkv6``).

Time-mix recurrence (per head, k/v head size n):
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with the data-dependent decay w_t = exp(-exp(w0 + tanh(x~_t A) B)) and
static token-shift mixes, one per projection (r, k, v, w, g).

The reference runs the recurrence as an exact ``lax.scan`` over time with
fp32 state; here it is one loop over time in plain PyTorch, the same
arithmetic in fp32, a few tensor ops a step over (B, H, n, n).  Prefill
and decode run the same function; a decode step is a loop of one.  No
(B, S, H, n, n) tensor is formed.  The chunked reformulation (GLA) and a
recurrence kernel are later work (ROADMAP).

The caches are functional, as in the reference: ``time_mix`` and
``channel_mix`` return the new ``{"shift", "state"}`` / ``{"shift"}``;
``models/lm.py`` writes them into the block's flat cache (``tm_shift``,
``tm_state``, ``cm_shift``; ``init_rwkv_cache``).

Training runs the same loop under autograd (one step a position, as the
reference's scan).  On a grid under the family's rules (``heads4``:
heads over 'model') ``time_mix`` computes this rank's heads: r, k, v, the
decay and the gate from the columns of its heads, the recurrence over
them, ``ln_x`` (a layernorm over all d channels) with its mean and
variance summed over the ranks, and the output projection's rows of its
channels, summed over the ranks (``distributed.ctx.head_sum``).  The
channel mix has no hook in the reference: every rank computes it whole."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RWKVConfig
from repro_torch.distributed.ctx import head_slice, head_sum
from repro_torch.kernels import shapes
from repro_torch.models.blocks import (LayerNorm, apply_layernorm,
                                       dense_init, frozen, normal_init, part)


class TimeMix(nn.Module):
    """The reference's ``init_time_mix`` leaves: ``mu`` (5, d), ``w0`` (d,)
    and ``u`` (H, n) in fp32 whatever ``dtype`` is; ``w_lora_a`` (d, lora),
    ``w_lora_b`` (lora, d), ``wr``, ``wk``, ``wv``, ``wg``, ``wo`` (d, d) in
    ``dtype``; ``ln_x`` a layernorm over all d channels."""

    def __init__(self, d: int, rwkv: RWKVConfig, gen, dtype, device):
        super().__init__()
        n = rwkv.head_size
        f32 = torch.float32
        self.mu = frozen(torch.full((5, d), 0.5, dtype=f32, device=device))
        self.w0 = frozen(torch.full((d,), -1.0, dtype=f32, device=device))
        self.w_lora_a = dense_init(gen, (d, rwkv.decay_lora), dtype, device)
        self.w_lora_b = normal_init(gen, (rwkv.decay_lora, d), 0.01, dtype,
                                    device)
        self.u = frozen(torch.zeros((d // n, n), dtype=f32, device=device))
        for name in ("wr", "wk", "wv", "wg"):
            setattr(self, name, dense_init(gen, (d, d), dtype, device))
        self.ln_x = LayerNorm(d, device)
        self.wo = dense_init(gen, (d, d), dtype, device)


class ChannelMix(nn.Module):
    """The reference's ``init_channel_mix`` leaves: ``mu`` (2, d) fp32,
    ``wk`` (d, d_ff), ``wv`` (d_ff, d), ``wr`` (d, d)."""

    def __init__(self, d: int, d_ff: int, gen, dtype, device):
        super().__init__()
        self.mu = frozen(torch.full((2, d), 0.5, dtype=torch.float32,
                                    device=device))
        self.wk = dense_init(gen, (d, d_ff), dtype, device)
        self.wv = dense_init(gen, (d_ff, d), dtype, device)
        self.wr = dense_init(gen, (d, d), dtype, device)


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1}: zeros (or the cached last token) at t = 0.  x: (B, S, d);
    last: (B, 1, d) or None."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last.to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mixer(mu: torch.Tensor, x: torch.Tensor, xx: torch.Tensor):
    """``mix(i) = x + (xx - x) * mu[i]`` in x's dtype."""
    d = xx - x
    return lambda i: x + d * mu[i].to(x.dtype)


def wkv_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """The WKV6 recurrence, one step at a time, in fp32.  r, k, v, w: (B,
    S, H, n) fp32; u: (H, n); state: (B, H, n, n) fp32.  Returns (o (B, S,
    H, n), final state).  Fake or meta tensors (the dry run) take the
    shape-only op of ``kernels/shapes.py``."""
    if shapes.is_fake(r, state):
        o, state = shapes.wkv_recurrence_shape(r, k, v, w, u, state)
        return o, state
    u_col = u[None, :, :, None]                              # (1, H, n, 1)
    outs = []
    # one view a position (unbind: under autograd one stack of the
    # positions' gradients a tensor, where slicing would add a zero-filled
    # (B, S, H, n) gradient a position)
    for r_t, k_t, v_t, w_t in zip(*(x.unbind(1) for x in (r, k, v, w))):
        kv = k_t[:, :, :, None] * v_t[:, :, None, :]         # (B, H, n, n)
        outs.append(torch.matmul(r_t[:, :, None, :],
                                 torch.addcmul(state, u_col, kv)))
        state = torch.addcmul(kv, w_t[:, :, :, None], state)
    return torch.cat(outs, dim=2).transpose(1, 2), state


def time_mix(p: TimeMix, x: torch.Tensor, rwkv: RWKVConfig, *,
             cache: Optional[dict] = None):
    """Returns (out (B, S, d) in x's dtype, new_cache).  cache: {"shift":
    (B, 1, d), "state": (B, H, n, n) fp32} or None (zeros, and no new
    cache).  Under tensor-parallel heads (the module docstring) ``out`` is
    the sum of every rank's heads' share, and a cache holds this rank's
    heads."""
    B, S, d = x.shape
    dt = x.dtype
    n = rwkv.head_size
    hs = head_slice("heads4", 2, d // n)         # this rank's heads
    cs = slice(hs.start * n, hs.stop * n)        # and their channels
    H = hs.stop - hs.start
    xx = _token_shift(x, cache["shift"] if cache is not None else None)
    mix = _mixer(p.mu, x, xx)

    def proj(i: int, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(mix(i), part(w, cs).to(dt))
    r = proj(0, p.wr).reshape(B, S, H, n)
    k = proj(1, p.wk).reshape(B, S, H, n)
    v = proj(2, p.wv).reshape(B, S, H, n)
    # Finch: data-dependent decay
    lora = torch.matmul(torch.tanh(torch.matmul(mix(3), p.w_lora_a.to(dt))),
                        part(p.w_lora_b, cs).to(dt))
    w = torch.exp(-torch.exp(part(p.w0, cs) + lora.float())
                  ).reshape(B, S, H, n)
    g = F.silu(proj(4, p.wg).float())
    state0 = (torch.zeros((B, H, n, n), dtype=torch.float32,
                          device=x.device) if cache is None
              else cache["state"].float())
    o, state = wkv_recurrence(r.float(), k.float(), v.float(), w,
                              part(p.u, hs, 0), state0)
    # ln_x runs over all d channels: its statistics summed over the ranks
    o = apply_layernorm(part(p.ln_x.scale, cs), part(p.ln_x.bias, cs),
                        o.reshape(B, S, H * n).to(dt),
                        reduce=lambda t: head_sum(t, "heads4", 2), d=d)
    o = o.float() * g
    out = torch.matmul(o.to(dt), part(p.wo, cs, 0).to(dt))
    out = head_sum(out, "heads4", 2)
    new_cache = None
    if cache is not None:
        new_cache = {"shift": x[:, -1:].to(cache["shift"].dtype),
                     "state": state}
    return out, new_cache


def channel_mix(p: ChannelMix, x: torch.Tensor, *,
                cache: Optional[dict] = None):
    """Returns (out, new_cache).  cache: {"shift": (B, 1, d)} or None."""
    dt = x.dtype
    xx = _token_shift(x, cache["shift"] if cache is not None else None)
    mix = _mixer(p.mu, x, xx)
    k = torch.matmul(mix(0), p.wk.to(dt))
    k = torch.square(torch.relu(k.float())).to(dt)
    kv = torch.matmul(k, p.wv.to(dt))
    r = torch.sigmoid(torch.matmul(mix(1), p.wr.to(dt)).float())
    out = (r * kv.float()).to(dt)
    new_cache = ({"shift": x[:, -1:].to(cache["shift"].dtype)}
                 if cache is not None else None)
    return out, new_cache


def init_rwkv_cache(batch: int, d_model: int, rwkv: RWKVConfig,
                    dtype=torch.float32, device="cpu") -> dict:
    """One ``rwkv`` block's flat cache: the time-mix and channel-mix token
    shifts (B, 1, d) in ``dtype`` and the WKV state (B, H, n, n) in fp32."""
    n = rwkv.head_size
    H = d_model // n
    return {"tm_shift": torch.zeros((batch, 1, d_model), dtype=dtype,
                                    device=device),
            "tm_state": torch.zeros((batch, H, n, n), dtype=torch.float32,
                                    device=device),
            "cm_shift": torch.zeros((batch, 1, d_model), dtype=dtype,
                                    device=device)}
