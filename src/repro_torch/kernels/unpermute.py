"""Unpermute + combine back to token order (counterpart of
``repro.kernels.unpermute``; kernel in ``csrc/unpermute.cu``):
``out[t] = sum_c w[t, c] * y[pos[t, c]]`` summed in fp32 in c order, cast to
``y.dtype``.  ``weights=None`` is the folded case (weights already applied
in the down projection's epilogue): an unweighted sum."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, shapes


def unpermute_plain(y: torch.Tensor, pos: torch.Tensor,
                    weights: Optional[torch.Tensor]) -> torch.Tensor:
    """y: (capacity, d); pos: (T, k) int32; weights: (T, k) or None ->
    (T, d)."""
    T, k = pos.shape
    g = y.index_select(0, pos.reshape(-1).long()).reshape(T, k, -1).float()
    acc = torch.zeros((T, y.shape[1]), dtype=torch.float32, device=y.device)
    for c in range(k):
        term = g[:, c]
        if weights is not None:
            term = term * weights[:, c:c + 1].float()
        acc = acc + term
    return acc.to(y.dtype)


def unpermute(y: torch.Tensor, pos: torch.Tensor,
              weights: Optional[torch.Tensor]) -> torch.Tensor:
    """CPU tensors run the plain version; CUDA tensors the kernel."""
    if shapes.is_fake(y, pos, weights):
        return shapes.unpermute_shape(y, pos, weights)
    if not _build.on_cuda(y, pos, weights):
        return unpermute_plain(y, pos, weights)
    code = _build.dtype_code(y.dtype)
    _build.require(y.dim() == 2 and y.is_contiguous() and y.shape[1] % 8 == 0,
                   "unpermute takes a contiguous (capacity, d) y with d a "
                   "multiple of 8")
    _build.require(pos.dtype == torch.int32 and pos.dim() == 2
                   and pos.is_contiguous(),
                   "unpermute takes a contiguous int32 (T, k) pos")
    _build.require(_build.aligned(y),
                   "unpermute loads y's rows as 16-byte vectors: y must "
                   "start on a 16-byte boundary")
    if weights is not None:
        _build.require(weights.dtype == torch.float32
                       and weights.shape == pos.shape
                       and weights.is_contiguous(),
                       "unpermute takes contiguous float32 (T, k) weights")
    lib = _build.library()
    T, k = pos.shape
    out = torch.empty((T, y.shape[1]), dtype=y.dtype, device=y.device)
    err = lib.moe_unpermute(
        y.data_ptr(), pos.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        T, k, y.shape[1], code, _build.stream_ptr(y.device))
    _build.check(err, "unpermute")
    _build.LAUNCHES["unpermute"] += 1
    return out
