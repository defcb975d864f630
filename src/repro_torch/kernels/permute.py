"""Token permutation into the padded expert-contiguous layout (counterpart
of ``repro.kernels.permute``; kernel in ``csrc/permute.cu``):
``out[i] = x[src_tok[i]]``, zeros where ``src_tok[i] == -1``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, shapes


def permute_plain(x: torch.Tensor, src_tok: torch.Tensor) -> torch.Tensor:
    """x: (T, d); src_tok: (capacity,) int32 -> (capacity, d)."""
    valid = src_tok >= 0
    rows = x.index_select(0, torch.clamp(src_tok, min=0).long())
    return torch.where(valid[:, None], rows, torch.zeros_like(rows))


def permute(x: torch.Tensor, src_tok: torch.Tensor) -> torch.Tensor:
    """CPU tensors run the plain version; CUDA tensors the kernel."""
    if shapes.is_fake(x, src_tok):
        return shapes.permute_shape(x, src_tok)
    if not _build.on_cuda(x, src_tok):
        return permute_plain(x, src_tok)
    _build.require(x.dim() == 2 and x.is_contiguous(),
                   "permute takes a contiguous (T, d) x")
    _build.require(src_tok.dtype == torch.int32 and src_tok.dim() == 1
                   and src_tok.is_contiguous(),
                   "permute takes a contiguous int32 (capacity,) src_tok")
    row_bytes = x.shape[1] * x.element_size()
    _build.require(row_bytes % 16 == 0,
                   f"permute copies 16-byte vectors: a row of {row_bytes} "
                   "bytes is not a multiple of 16")
    lib = _build.library()
    capacity = src_tok.shape[0]
    out = torch.empty((capacity, x.shape[1]), dtype=x.dtype, device=x.device)
    err = lib.moe_permute(x.data_ptr(), src_tok.data_ptr(), out.data_ptr(),
                          capacity, row_bytes, _build.stream_ptr(x.device))
    _build.check(err, "permute")
    _build.LAUNCHES["permute"] += 1
    return out
