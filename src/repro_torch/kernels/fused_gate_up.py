"""Fused gate+up grouped GEMM with the SiLU product in the epilogue
(counterpart of ``repro.kernels.fused_gate_up``, dense weight format;
kernel in ``csrc/fused_gate_up.cu``):
``silu(x @ w_gate[e]) * (x @ w_up[e])`` per schedule block, zeros for
inactive blocks."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_gemm import (_block_products,
                                              check_gemm_operands)


def fused_gate_up_plain(x: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, block_expert: torch.Tensor,
                        block_active: torch.Tensor, *, block_m: int
                        ) -> torch.Tensor:
    """x: (capacity, K); w_gate/w_up: (E, K, F) -> (capacity, F)."""
    g, u = _block_products(x, [w_gate, w_up], block_expert, block_active,
                           block_m)
    out = (g * torch.sigmoid(g)) * u
    return out.reshape(x.shape[0], -1).to(x.dtype)


def fused_gate_up(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  block_expert: torch.Tensor, block_active: torch.Tensor, *,
                  block_m: int) -> torch.Tensor:
    """CPU tensors run the plain version; CUDA tensors the kernel."""
    if not _build.on_cuda(x, w_gate, w_up, block_expert, block_active):
        return fused_gate_up_plain(x, w_gate, w_up, block_expert,
                                   block_active, block_m=block_m)
    code, cap, K, F = check_gemm_operands(x, [w_gate, w_up], block_expert,
                                          block_active, block_m)
    lib = _build.library()
    out = torch.empty((cap, F), dtype=x.dtype, device=x.device)
    err = lib.moe_fused_gate_up(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        block_expert.data_ptr(), block_active.data_ptr(), out.data_ptr(),
        cap, K, F, block_m, code, _build.stream_ptr(x.device))
    _build.check(err, "fused_gate_up")
    _build.LAUNCHES["fused_gate_up"] += 1
    return out
