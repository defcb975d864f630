"""Dense feed-forward variants (counterpart of ``repro.models.ffn``):
``swiglu`` and ``geglu`` (gate and up projections, the nonlinearity of the
gate in fp32) and the ungated ``gelu_mlp`` with optional biases."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.blocks import dense_init, frozen

ACTS = ("swiglu", "geglu", "gelu_mlp")


class FFN(nn.Module):
    """The reference's ``init_ffn`` leaves, under the same names:
    ``w_gate``, ``w_up``, ``w_down`` (gated), or ``w_up``, ``w_down``
    (``gelu_mlp``); with ``bias`` a zero ``b_down``, and for ``gelu_mlp``
    a zero ``b_up``."""

    def __init__(self, d: int, f: int, act: str, bias: bool, gen, dtype,
                 device):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"act {act!r}: expected one of {ACTS}")
        self.act = act
        if act != "gelu_mlp":
            self.w_gate = dense_init(gen, (d, f), dtype, device)
        self.w_up = dense_init(gen, (d, f), dtype, device)
        if bias and act == "gelu_mlp":
            self.b_up = frozen(torch.zeros(f, dtype=dtype, device=device))
        self.w_down = dense_init(gen, (f, d), dtype, device)
        if bias:
            self.b_down = frozen(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The nonlinearity in fp32 (GELU in its tanh form), the hidden
        rounded to x's dtype before ``w_down``."""
        dt = x.dtype
        if self.act != "gelu_mlp":
            g = torch.matmul(x, self.w_gate.to(dt))
            u = torch.matmul(x, self.w_up.to(dt))
            gf = g.float()
            nl = (gf * torch.sigmoid(gf) if self.act == "swiglu"
                  else F.gelu(gf, approximate="tanh"))
            h = (nl * u.float()).to(dt)
        else:
            h = torch.matmul(x, self.w_up.to(dt))
            if hasattr(self, "b_up"):
                h = h + self.b_up.to(dt)
            h = F.gelu(h.float(), approximate="tanh").to(dt)
        out = torch.matmul(h, self.w_down.to(dt))
        if hasattr(self, "b_down"):
            out = out + self.b_down.to(dt)
        return out
