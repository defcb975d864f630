"""Mamba2 (SSD) mixer: the chunked scan for prefill and decode (counterpart
of ``repro.models.ssm``).

The SSD scan is the Mamba2 paper's chunked algorithm: inside a chunk of L
positions an attention-like (L, L) product, across chunks a (H, P, N)
state carried in fp32.  The reference cuts the sequence into chunks of the
largest divisor of S that is <= ``ssm.chunk``, which is one position for a
prime S (ROADMAP C12); here the chunks are ``ssm.chunk`` long with a
ragged last one, so S positions take ceil(S / chunk) chunks whatever S is.
The last chunk is padded to full length with dt = 0: a padded position
adds nothing to the state (its x * dt is 0) and leaves the cumulative
decay unchanged (its dt * a is 0), and its output is dropped, so the
result is the ragged chunk's.

The reference scans chunk by chunk (``lax.scan``).  Here the within-chunk
products of up to ``CHUNK_GROUP`` chunks run at once, and only the state's
hand-over from chunk to chunk is a loop (two tensor ops a chunk), so the
results differ from the reference's only in the order of summation.  A
decode step is a sequence of one position: one chunk of length 1.

``ssm_block`` returns its new cache, as the reference does; ``models/lm.py``
writes it into the block's flat cache (``conv``, ``state``;
``init_ssm_cache``).

Training runs the same scan under autograd.  On a grid under the family's
rules (``channels3``, ``heads4``: channels and heads over 'model')
``ssm_block`` computes this rank's heads: of ``in_proj`` the columns of
their z and x channels and of their dt, with the B and C columns whole
(G = 1 group, read by every head), the depthwise conv over those channels,
the scan over its heads, the gated ``out_norm`` (an RMSNorm over all
d_in channels) with its mean square summed over the ranks, and the
output projection's rows of its channels, summed over the ranks
(``distributed.ctx.head_sum``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed.ctx import head_slice, head_sum
from repro_torch.models.blocks import (RMSNorm, apply_norm, dense_init,
                                       frozen, part)

# chunks whose within-chunk products run in one pass: bounds the (G, L, L,
# H) fp32 temporaries (235 MB each at zamba2-7b's L = 128, H = 112)
CHUNK_GROUP = 32


class Mamba2(nn.Module):
    """The reference's ``init_ssm`` leaves: ``in_proj`` (d, 2 d_in + 2 G N +
    H), ``conv_w`` (K, C), ``conv_b`` (C,) and ``out_proj`` (d_in, d) in
    ``dtype``; ``a_log``, ``dt_bias``, ``d_skip`` (H,) in fp32;
    ``out_norm`` an RMSNorm over d_in."""

    def __init__(self, d: int, ssm: SSMConfig, gen, dtype, device):
        super().__init__()
        d_in = ssm.expand * d
        H = d_in // ssm.head_dim
        GN = ssm.n_groups * ssm.d_state
        C = d_in + 2 * GN
        f32 = torch.float32
        self.in_proj = dense_init(gen, (d, 2 * d_in + 2 * GN + H), dtype,
                                  device)
        conv = torch.randn((ssm.conv_kernel, C), generator=gen, device=device,
                           dtype=f32) * 0.1
        self.conv_w = frozen(conv.to(dtype))
        self.conv_b = frozen(torch.zeros(C, dtype=dtype, device=device))
        self.a_log = frozen(torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                                     device=device)))
        self.dt_bias = frozen(torch.zeros(H, dtype=f32, device=device))
        self.d_skip = frozen(torch.ones(H, dtype=f32, device=device))
        self.out_norm = RMSNorm(d_in, device)
        self.out_proj = dense_init(gen, (d_in, d), dtype, device)


def _split_proj(p: Mamba2, x: torch.Tensor, ssm: SSMConfig, d_model: int,
                hs: slice):
    """in_proj, cut into z, xBC (x, then the 2 G N columns of B and C) and
    dt, for the heads ``hs`` (all of them: z d_in, xBC d_in + 2 G N, dt
    H)."""
    d_in = ssm.expand * d_model
    n_heads = d_in // ssm.head_dim
    GN = ssm.n_groups * ssm.d_state
    w = p.in_proj
    if hs.stop - hs.start < n_heads:            # this rank's heads' columns
        P = ssm.head_dim
        c0, c1 = hs.start * P, hs.stop * P
        w = torch.cat([w[:, c0:c1], w[:, d_in + c0:d_in + c1],
                       w[:, 2 * d_in:2 * d_in + 2 * GN],
                       w[:, 2 * d_in + 2 * GN + hs.start:
                         2 * d_in + 2 * GN + hs.stop]], dim=1)
        d_in, n_heads = c1 - c0, hs.stop - hs.start
    zxbcdt = torch.matmul(x, w.to(x.dtype))
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * GN]
    dt = zxbcdt[..., -n_heads:]
    return z, xbc, dt


def _conv_channels(w: torch.Tensor, d_in: int, cs: slice) -> torch.Tensor:
    """The conv weight's (or bias's) last dim for the x channels ``cs`` and
    all of B and C."""
    if cs.stop - cs.start == d_in:
        return w
    return torch.cat([w[..., cs], w[..., d_in:]], dim=-1)


def _causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                 xbc: torch.Tensor, conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv1d over the sequence, then SiLU; returns (out,
    the last K - 1 inputs: the new conv state)."""
    K = conv_w.shape[0]
    S = xbc.shape[1]
    pad = (torch.zeros_like(xbc[:, :K - 1]) if conv_state is None
           else conv_state.to(xbc.dtype))
    xp = torch.cat([pad, xbc], dim=1)                       # (B, S+K-1, C)
    w = conv_w.to(xbc.dtype)
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    out = F.silu((out + conv_b.to(xbc.dtype)).float()).to(xbc.dtype)
    return out, xp[:, S:]


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, a: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None):
    """SSD chunked scan.  xh: (B, S, H, P); dt: (B, S, H) (after softplus);
    B_, C_: (B, S, G, N); a: (H,) < 0.  Chunks of ``chunk`` positions, the
    last one ragged.  Returns (y (B, S, H, P) fp32, final state (B, H, P,
    N) fp32)."""
    Bb, S, H, P = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    L = max(1, min(chunk, S))
    nc = -(-S // L)
    pad = nc * L - S
    rep = H // G
    f32 = torch.float32

    def chunks(t: torch.Tensor) -> torch.Tensor:
        t = t.to(f32)
        if pad:
            t = torch.cat([t, t.new_zeros((Bb, pad) + t.shape[2:])], dim=1)
        return t.reshape((Bb, nc, L) + t.shape[2:])

    xc, dtc = chunks(xh), chunks(dt)                         # dt = 0 pads
    Bg, Cg = chunks(B_), chunks(C_)                          # (B,nc,L,G,N)
    cum = torch.cumsum(dtc * a, dim=2)                       # (B,nc,L,H)
    xdt = xc * dtc[..., None]                                # (B,nc,L,H,P)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xh.device))[:, :, None]

    state = (torch.zeros((Bb, H, P, N), dtype=f32, device=xh.device)
             if state0 is None else state0.to(f32))
    ys = []
    for c0 in range(0, nc, CHUNK_GROUP):
        c1 = min(c0 + CHUNK_GROUP, nc)
        cb, xb = cum[:, c0:c1], xdt[:, c0:c1]
        Bc = torch.repeat_interleave(Bg[:, c0:c1], rep, dim=3)  # (B,g,L,H,N)
        Cc = torch.repeat_interleave(Cg[:, c0:c1], rep, dim=3)
        # within each chunk: (L, L) decayed scores against x * dt
        seg = cb[:, :, :, None, :] - cb[:, :, None, :, :]    # (B,g,L,L,H)
        decay = torch.where(causal, torch.exp(torch.clamp_max(seg, 0.0)),
                            0.0)
        sc = torch.einsum("bclhn,bcmhn->bclmh", Cc, Bc) * decay
        y = torch.einsum("bclmh,bcmhp->bclhp", sc, xb)
        # each chunk's own contribution to the state at its end
        tail = torch.exp(cb[:, :, -1:, :] - cb)              # (B,g,L,H)
        own = torch.einsum("bclhn,bclhp->bchpn", Bc * tail[..., None], xb)
        last = torch.exp(cb[:, :, -1])[..., None, None]      # (B,g,H,1,1)
        # hand the state over chunk by chunk: the state entering each
        entering = []
        for j in range(c1 - c0):
            entering.append(state)
            state = torch.addcmul(own[:, j], state, last[:, j])
        entering = torch.stack(entering, dim=1)              # (B,g,H,P,N)
        y = y + torch.einsum("bclhn,bchpn->bclhp", Cc, entering) \
            * torch.exp(cb)[..., None]
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(Bb, nc * L, H, P)[:, :S]
    return y, state


def ssm_block(p: Mamba2, x: torch.Tensor, ssm: SSMConfig, *,
              cache: Optional[dict] = None):
    """Mamba2 mixer.  Returns (out in x's dtype, new_cache).  cache:
    {"conv": (B, K-1, C), "state": (B, H, P, N) fp32} or None (zeros, and
    no new cache).  Under tensor-parallel heads (the module docstring)
    ``out`` is the sum of every rank's heads' share, and a cache holds this
    rank's heads."""
    B, S, d_model = x.shape
    d_full = ssm.expand * d_model
    P = ssm.head_dim
    hs = head_slice("heads4", 2, d_full // P)    # this rank's heads
    cs = slice(hs.start * P, hs.stop * P)        # and their channels
    H, d_in = hs.stop - hs.start, (hs.stop - hs.start) * P
    GN = ssm.n_groups * ssm.d_state
    z, xbc, dt = _split_proj(p, x, ssm, d_model, hs)
    xbc, new_conv = _causal_conv(
        _conv_channels(p.conv_w, d_full, cs),
        _conv_channels(p.conv_b, d_full, cs), xbc,
        cache["conv"] if cache is not None else None)
    xh = xbc[..., :d_in].reshape(B, S, H, P)
    B_ = xbc[..., d_in:d_in + GN].reshape(B, S, ssm.n_groups, ssm.d_state)
    C_ = xbc[..., d_in + GN:].reshape(B, S, ssm.n_groups, ssm.d_state)
    dt = F.softplus(dt.float() + part(p.dt_bias, hs))
    a = -torch.exp(part(p.a_log, hs))
    y, state = ssd_chunked(xh, dt, B_, C_, a, ssm.chunk,
                           cache["state"] if cache is not None else None)
    y = y + xh.float() * part(p.d_skip, hs)[:, None]
    y = y.reshape(B, S, d_in)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float())
    # its mean square runs over all d_in channels, summed over the ranks
    y = apply_norm(part(p.out_norm.scale, cs), y.to(x.dtype),
                   reduce=lambda t: head_sum(t, "heads4", 2), d=d_full)
    out = torch.matmul(y, part(p.out_proj, cs, 0).to(x.dtype))
    out = head_sum(out, "heads4", 2)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "state": state.to(cache["state"].dtype)}
    return out, new_cache


def init_ssm_cache(batch: int, d_model: int, ssm: SSMConfig,
                   dtype=torch.float32, device="cpu") -> dict:
    """One ``mamba`` block's flat cache: the conv inputs (B, K-1, C) in
    ``dtype`` and the SSD state (B, H, P, N) in fp32."""
    d_in = ssm.expand * d_model
    H, P = d_in // ssm.head_dim, ssm.head_dim
    C = d_in + 2 * ssm.n_groups * ssm.d_state
    return {"conv": torch.zeros((batch, ssm.conv_kernel - 1, C), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, H, P, ssm.d_state),
                                 dtype=torch.float32, device=device)}
