"""Block-scheduled grouped GEMM (counterpart of ``repro.kernels.grouped_gemm``,
dense weight format; kernel in ``csrc/grouped_gemm.cu``).

``out[block m] = x[block m] @ w[block_expert[m]]`` with fp32 accumulation,
an optional ``row_scale`` epilogue (the folded combine weights), and zeros
for inactive blocks.  ``block_m`` is any multiple of 8: the ``fixed``
policy's 128-row blocks and the ``dynamic`` policy's 8-row sub-blocks."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build


def _block_products(x, ws, block_expert, block_active, block_m):
    """fp32 ``x[block] @ w[expert(block)]`` for each weight in ``ws``, as
    (num_blocks, block_m, N): computed for the active blocks only (their
    expert weights gathered once per block), exact zeros for the others.
    Finding the active blocks reads ``block_active`` on the host, which the
    plain version may do: the kernels never do."""
    cap, K = x.shape
    nb = cap // block_m
    act = torch.nonzero(block_active).reshape(-1)
    xa = x.reshape(nb, block_m, K).index_select(0, act).float()
    idx = block_expert.index_select(0, act).long()
    outs = []
    for w in ws:
        out = torch.zeros((nb, block_m, w.shape[-1]), dtype=torch.float32,
                          device=x.device)
        outs.append(out.index_copy_(
            0, act, torch.bmm(xa, w.index_select(0, idx).float())))
    return outs


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       block_expert: torch.Tensor, block_active: torch.Tensor,
                       *, block_m: int,
                       row_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x: (capacity, K); w: (E, K, N); row_scale: (capacity,) f32 or None
    -> (capacity, N) in x's dtype."""
    (out,) = _block_products(x, [w], block_expert, block_active, block_m)
    out = out.reshape(x.shape[0], -1)
    if row_scale is not None:
        out = out * row_scale[:, None].float()
    return out.to(x.dtype)


def check_gemm_operands(x, ws, block_expert, block_active, block_m):
    """Shape, type and layout checks shared with fused_gate_up."""
    code = _build.dtype_code(x.dtype)
    _build.require(x.dim() == 2 and x.is_contiguous(),
                   "grouped GEMM takes a contiguous (capacity, K) x")
    cap, K = x.shape
    N = ws[0].shape[-1]
    for w in ws:
        _build.require(w.dim() == 3 and w.dtype == x.dtype
                       and w.is_contiguous() and w.shape[1] == K
                       and w.shape == ws[0].shape,
                       f"grouped GEMM takes contiguous (E, {K}, N) weights "
                       f"of x's dtype {x.dtype}")
    _build.require(K % 16 == 0 and N % 16 == 0,
                   f"grouped GEMM takes K and N multiples of 16 (K={K}, "
                   f"N={N})")
    _build.require(block_m % 8 == 0 and cap % block_m == 0,
                   f"grouped GEMM takes block_m a multiple of 8 dividing "
                   f"capacity (block_m={block_m}, capacity={cap})")
    nb = cap // block_m
    for t in (block_expert, block_active):
        _build.require(t.dtype == torch.int32 and t.shape == (nb,)
                       and t.is_contiguous(),
                       f"grouped GEMM takes contiguous int32 ({nb},) "
                       "schedule arrays")
    return code, cap, K, N


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                 block_active: torch.Tensor, *, block_m: int,
                 row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CPU tensors run the plain version; CUDA tensors the kernel."""
    if not _build.on_cuda(x, w, block_expert, block_active, row_scale):
        return grouped_gemm_plain(x, w, block_expert, block_active,
                                  block_m=block_m, row_scale=row_scale)
    code, cap, K, N = check_gemm_operands(x, [w], block_expert, block_active,
                                          block_m)
    if row_scale is not None:
        _build.require(row_scale.dtype == torch.float32
                       and row_scale.shape == (cap,)
                       and row_scale.is_contiguous(),
                       f"grouped GEMM takes a contiguous float32 ({cap},) "
                       "row_scale")
    lib = _build.library()
    out = torch.empty((cap, N), dtype=x.dtype, device=x.device)
    err = lib.moe_grouped_gemm(
        x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
        block_active.data_ptr(),
        None if row_scale is None else row_scale.data_ptr(), out.data_ptr(),
        cap, K, N, block_m, code, _build.stream_ptr(x.device))
    _build.check(err, "grouped_gemm")
    _build.LAUNCHES["grouped_gemm"] += 1
    return out
