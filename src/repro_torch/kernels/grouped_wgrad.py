"""Grouped weight gradient of the block-scheduled GEMM (counterpart of
``repro.kernels.grouped_wgrad``; kernel in ``csrc/grouped_wgrad.cu``):
``dW[e] = sum over the rows of e's active blocks of x_r^T dy_r``, summed in
fp32 and rounded once to ``out_dtype`` (fp32 by default, as the reference's
``out_dtype``), with exact zeros for experts that received no rows (the
reference's ops wrapper zeroes them; here the kernel writes them)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, shapes
from repro_torch.kernels import expert_tiles as _tiles
from repro_torch.kernels.grouped_gemm import active_block_chunks


def grouped_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                        block_expert: torch.Tensor,
                        block_active: torch.Tensor, *, block_m: int,
                        n_experts: int) -> torch.Tensor:
    """x: (capacity, K); dy: (capacity, N) -> (E, K, N) fp32: the per-block
    ``x_b^T dy_b`` of the active blocks, index-added by ``block_expert``
    (``repro.kernels.ref.grouped_wgrad_ref``).  An expert no active block
    names keeps its zeros."""
    cap, K = x.shape
    N, nb = dy.shape[1], cap // block_m
    xb, dyb = x.reshape(nb, block_m, K), dy.reshape(nb, block_m, N)
    dw = torch.zeros((n_experts, K, N), dtype=torch.float32, device=x.device)
    for idx in active_block_chunks(block_active, K * N * 4):
        per_block = torch.bmm(xb.index_select(0, idx).float().transpose(1, 2),
                              dyb.index_select(0, idx).float())
        dw.index_add_(0, block_expert.index_select(0, idx).long(), per_block)
    return dw


def grouped_wgrad(x: torch.Tensor, dy: torch.Tensor, seg_start: torch.Tensor,
                  block_expert: torch.Tensor, block_active: torch.Tensor, *,
                  block_m: int, n_experts: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """CPU tensors run the plain version, rounded to ``out_dtype``; CUDA
    tensors the kernel, which reduces each expert's run of blocks from
    ``seg_start[e] // block_m`` (the schedule's per-expert base row)."""
    if shapes.is_fake(x, dy):
        return shapes.grouped_wgrad_shape(x, dy, n_experts, out_dtype)
    if not _build.on_cuda(x, dy, seg_start, block_expert, block_active):
        return grouped_wgrad_plain(x, dy, block_expert, block_active,
                                   block_m=block_m,
                                   n_experts=n_experts).to(out_dtype)
    code = _build.dtype_code(x.dtype)
    out_code = _build.dtype_code(out_dtype)
    _build.require(x.dim() == 2 and dy.dim() == 2 and x.is_contiguous()
                   and dy.is_contiguous() and dy.dtype == x.dtype
                   and dy.shape[0] == x.shape[0],
                   "grouped_wgrad takes contiguous (capacity, K) x and "
                   "(capacity, N) dy of one dtype")
    _build.require(_build.aligned(x, dy),
                   "grouped_wgrad takes x and dy on 16-byte boundaries")
    cap, K = x.shape
    N = dy.shape[1]
    _build.require(K % 16 == 0 and N % 16 == 0,
                   f"grouped_wgrad takes K and N multiples of 16 (K={K}, "
                   f"N={N})")
    _build.require(block_m % 8 == 0 and cap % block_m == 0,
                   f"grouped_wgrad takes block_m a multiple of 8 dividing "
                   f"capacity (block_m={block_m}, capacity={cap})")
    nb = cap // block_m
    for t, n in ((block_expert, nb), (block_active, nb),
                 (seg_start, n_experts)):
        _build.require(t.dtype == torch.int32 and t.shape == (n,)
                       and t.is_contiguous(),
                       f"grouped_wgrad takes contiguous int32 schedule "
                       f"arrays ({n},)")
    lib = _build.library()
    buf = _tiles.scratch(cap, n_experts, x.device)
    out = torch.empty((n_experts, K, N), dtype=out_dtype, device=x.device)
    err = lib.moe_grouped_wgrad(
        x.data_ptr(), dy.data_ptr(), seg_start.data_ptr(),
        block_expert.data_ptr(), block_active.data_ptr(), buf.data_ptr(),
        out.data_ptr(), cap, K, N, n_experts, block_m, code, out_code,
        _build.stream_ptr(x.device))
    _build.check(err, "grouped_wgrad")
    _build.LAUNCHES["grouped_wgrad"] += 1
    return out
