"""Fused gate+up grouped GEMM with the SiLU product in the epilogue
(counterpart of ``repro.kernels.fused_gate_up``; kernel in
``csrc/fused_gate_up.cu``): ``silu(x @ w_gate[e]) * (x @ w_up[e])`` per
schedule block, zeros for inactive blocks.  Weight formats as in
``grouped_gemm``: both operands in one format, with ``wg_scale`` and
``wu_scale`` for int8 and int4.  In bf16 a CUDA call needs the
schedule's ``seg_start``, as ``grouped_gemm``'s does, and takes a tile
shape from ``grouped_gemm.TILE_SHAPES`` (``block_n`` counts output
columns: a dense item multiplies 2 ``block_n`` product columns, gate's and
up's)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, shapes
from repro_torch.kernels.grouped_gemm import (_block_products, _ptr,
                                              check_gemm_operands,
                                              launch_key, resolve_tile,
                                              scale_args, work_list_args)


def fused_gate_up_plain(x: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, block_expert: torch.Tensor,
                        block_active: torch.Tensor, *, block_m: int,
                        wg_scale: Optional[torch.Tensor] = None,
                        wu_scale: Optional[torch.Tensor] = None,
                        w_format: str = "dense") -> torch.Tensor:
    """x: (capacity, K); w_gate/w_up: (E, K, F) or their payloads;
    w*_scale: (E, F) f32 or None -> (capacity, F)."""
    scales = None if wg_scale is None else [wg_scale, wu_scale]
    g, u = _block_products(x, [w_gate, w_up], block_expert, block_active,
                           block_m, scales, w_format)
    out = (g * torch.sigmoid(g)) * u
    return out.reshape(x.shape[0], -1).to(x.dtype)


def fused_gate_up(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  block_expert: torch.Tensor, block_active: torch.Tensor, *,
                  block_m: int, wg_scale: Optional[torch.Tensor] = None,
                  wu_scale: Optional[torch.Tensor] = None,
                  w_format: str = "dense",
                  seg_start: Optional[torch.Tensor] = None,
                  tile_rows: Optional[int] = None,
                  block_n: Optional[int] = None) -> torch.Tensor:
    """CPU tensors run the plain version (``seg_start`` and the tile shape
    unused, the shape checked all the same); CUDA tensors the kernel, which
    in bf16 needs the schedule's ``seg_start`` and runs at ``(tile_rows,
    block_n)`` (None: the default)."""
    tile = resolve_tile("fused_gate_up", w_format, x.dtype, tile_rows,
                        block_n)
    if shapes.is_fake(x, w_gate, w_up):
        return shapes.fused_gate_up_shape(x, w_gate, w_up, wg_scale,
                                          wu_scale, w_format)
    if not _build.on_cuda(x, w_gate, w_up, block_expert, block_active,
                          wg_scale, wu_scale, seg_start):
        return fused_gate_up_plain(x, w_gate, w_up, block_expert,
                                   block_active, block_m=block_m,
                                   wg_scale=wg_scale, wu_scale=wu_scale,
                                   w_format=w_format)
    scales = None if wg_scale is None and wu_scale is None \
        else [wg_scale, wu_scale]
    code, cap, K, F, fmt = check_gemm_operands(
        x, [w_gate, w_up], block_expert, block_active, block_m, w_format,
        scales)
    seg, buf = work_list_args(x, [w_gate, w_up], seg_start,
                              "fused_gate_up", tile[0])
    lib = _build.library()
    out = torch.empty((cap, F), dtype=x.dtype, device=x.device)
    _, s_e, s_n = scale_args(scales)
    err = lib.moe_fused_gate_up(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        None if scales is None else wg_scale.data_ptr(),
        None if scales is None else wu_scale.data_ptr(), _ptr(seg),
        block_expert.data_ptr(), block_active.data_ptr(), _ptr(buf),
        out.data_ptr(), cap, K, F, w_gate.shape[0], block_m, code, fmt, s_e,
        s_n, _build.stream_ptr(x.device), *tile)
    key = launch_key("fused_gate_up", w_format)
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    return out
