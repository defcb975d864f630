"""Dense SwiGLU feed-forward (counterpart of ``repro.models.ffn``, the
``swiglu`` variant the served MoE model's dense layer uses)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.blocks import dense_init


class SwiGLU(nn.Module):
    def __init__(self, d: int, f: int, gen, dtype, device):
        super().__init__()
        self.w_gate = dense_init(gen, (d, f), dtype, device)
        self.w_up = dense_init(gen, (d, f), dtype, device)
        self.w_down = dense_init(gen, (f, d), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        g = torch.matmul(x, self.w_gate.to(dt))
        u = torch.matmul(x, self.w_up.to(dt))
        gf = g.float()
        h = (gf * torch.sigmoid(gf) * u.float()).to(dt)
        return torch.matmul(h, self.w_down.to(dt))
