"""Shared building blocks: RMSNorm and layernorm, rotary embeddings, the
logit softcap, parameter init (counterpart of ``repro.models.blocks``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference-only parameter."""
    return nn.Parameter(t, requires_grad=False)


def normal_init(gen: torch.Generator, shape, scale: float, dtype, device
                ) -> nn.Parameter:
    """``N(0, 1) * scale`` drawn from ``gen`` on ``device``, cast to dtype."""
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return frozen((t * scale).to(dtype))


def dense_init(gen, shape, dtype, device) -> nn.Parameter:
    """The reference's ``dense_init``: fan-in scaled normal."""
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    return normal_init(gen, shape, fan_in ** -0.5, dtype, device)


class RMSNorm(nn.Module):
    """RMSNorm in the ``(1 + scale)`` form; ``scale`` starts at zero."""

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = frozen(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return apply_norm(self.scale, x, eps)


class LayerNorm(nn.Module):
    """Layernorm with ``scale`` (ones) and ``bias`` (zeros), the
    reference's ``norm="layernorm"``."""

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = frozen(torch.ones(d, dtype=torch.float32, device=device))
        self.bias = frozen(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return apply_layernorm(self.scale, self.bias, x, eps)


def make_norm(kind: str, d: int, device) -> nn.Module:
    """The reference's ``init_norm(d, kind)``: ``rmsnorm`` or
    ``layernorm``."""
    if kind == "rmsnorm":
        return RMSNorm(d, device)
    if kind == "layernorm":
        return LayerNorm(d, device)
    raise ValueError(f"norm {kind!r}: expected rmsnorm | layernorm")


def apply_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
               reduce: Optional[Callable] = None, d: Optional[int] = None
               ) -> torch.Tensor:
    """RMSNorm, computed in fp32, cast back to x's dtype.  With ``reduce``,
    ``x`` holds some of the ``d`` channels the norm runs over (``scale``
    the same ones) and ``reduce`` sums a statistic's partial sums over the
    holders of the others (``distributed.ctx.head_sum``)."""
    xf = x.float()
    if reduce is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = reduce(torch.sum(xf * xf, dim=-1, keepdim=True)) / d
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return out.to(x.dtype)


def apply_layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    eps: float = 1e-6, reduce: Optional[Callable] = None,
                    d: Optional[int] = None) -> torch.Tensor:
    """Layernorm over the population variance, computed in fp32, cast back
    to x's dtype.  ``reduce`` and ``d`` as in ``apply_norm``."""
    xf = x.float()
    if reduce is None:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    else:
        mu = reduce(torch.sum(xf, dim=-1, keepdim=True)) / d
        var = reduce(torch.sum(torch.square(xf - mu), dim=-1,
                               keepdim=True)) / d
    out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def part(w: torch.Tensor, sl: slice, dim: int = -1) -> torch.Tensor:
    """Entries ``sl`` of ``w`` on ``dim`` (a rank's heads or channels under
    tensor-parallel heads, ``distributed.ctx.head_slice``): ``w`` itself
    where ``sl`` covers the whole dim."""
    if sl.start == 0 and sl.stop == w.shape[dim]:
        return w
    return w.narrow(dim, sl.start, sl.stop - sl.start)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``cap * tanh(x / cap)``, or x where ``cap`` is None."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotate-half rotary embedding.  x: (B, S, H, D); positions: (S,) or
    (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs                 # (..., S, half)
    if ang.dim() == 2:
        ang = ang[None]                                        # (1, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
