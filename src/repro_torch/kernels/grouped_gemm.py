"""Block-scheduled grouped GEMM (counterpart of ``repro.kernels.grouped_gemm``;
kernel in ``csrc/grouped_gemm.cu``).

``out[block m] = x[block m] @ w[block_expert[m]]`` with fp32 accumulation,
an optional ``row_scale`` epilogue (the folded combine weights), and zeros
for inactive blocks.  ``block_m`` is any multiple of 8: the ``fixed``
policy's 128-row blocks and the ``dynamic`` policy's 8-row sub-blocks.
In bf16 the kernel is a Hopper one over tiles of each expert's run of
rows, found from the schedule's ``seg_start`` (see ``expert_tiles``),
which a CUDA call must then pass, in every weight format.

Weight formats (``w_format``), as the reference's: ``"dense"`` (w of x's
dtype), ``"int8"`` (w an (E, K, N) int8 payload) and ``"int4"`` (w an
(E, K/2, N) int8 payload, two nibbles per byte along K), the last two with
(E, N) f32 per-channel scales ``w_scale``.  Each gathered weight block is
dequantized as ``dequant_weight_block`` does: ``(q.float() * s).to(x's
dtype)``, so the kernel and the plain version differ only in the order of
summation.

Tile shapes.  The bf16 Hopper kernels take their tile shape, ``(tile_rows,
block_n)`` (rows of an expert's run a work item covers, output columns an
item), per call from the instantiated set ``TILE_SHAPES`` (the first of
each is the default, the shape the kernels had before they took one); any
other shape raises, on the CPU too.  No shape splits K, so the tile shape
does not change the function: the plain versions ignore it.  fp32 runs one
tile of its own (``csrc/grouped_gemm.cuh``), which reads neither, and takes
the default alone."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, shapes
from repro_torch.kernels import expert_tiles as _tiles
from repro_torch.quantization.schemes import unpack_int4

W_FORMATS = ("dense", "int8", "int4")

# (kernel, weight format) -> the bf16 kernels' instantiated tile shapes
# (tile_rows, block_n), the default first: csrc/grouped_gemm_hopper.cuh's
# launch_hopper_shape on dense weights; on int8/int4 the work lists' row
# tile at grouped_gemm_hopper_quant.cuh's QBN = 128 columns
TILE_SHAPES = {
    ("grouped_gemm", "dense"): ((256, 128), (256, 64), (128, 128),
                                (128, 256)),
    ("fused_gate_up", "dense"): ((256, 64), (128, 64), (128, 128)),
}
for _k in ("grouped_gemm", "fused_gate_up"):
    for _f in ("int8", "int4"):
        TILE_SHAPES[_k, _f] = ((256, 128), (128, 128))


def tile_shapes(kernel: str, w_format: str, dtype) -> tuple:
    """The tile shapes ``kernel`` takes in ``w_format`` and ``dtype``: the
    instantiated set in bf16, the default alone in fp32."""
    shapes = TILE_SHAPES.get((kernel, w_format))
    _build.require(shapes is not None,
                   f"grouped GEMM weight format {w_format!r} not in "
                   f"{W_FORMATS}")
    return shapes if dtype == torch.bfloat16 else shapes[:1]


def resolve_tile(kernel: str, w_format: str, dtype,
                 tile_rows: Optional[int], block_n: Optional[int]):
    """(tile_rows, block_n) with None taken from the default; raises on a
    shape outside ``tile_shapes``."""
    shapes = tile_shapes(kernel, w_format, dtype)
    shape = (shapes[0][0] if tile_rows is None else int(tile_rows),
             shapes[0][1] if block_n is None else int(block_n))
    _build.require(shape in shapes,
                   f"{kernel} ({w_format}, {dtype}) takes the tile shapes "
                   f"(tile_rows, block_n) {list(shapes)}, not {shape}")
    return shape


def launch_key(kernel: str, w_format: str) -> str:
    """The launch counter of ``kernel`` in ``w_format``: each format is its
    own compiled kernel and has its own count."""
    return kernel if w_format == "dense" else f"{kernel}_{w_format}"


def dequant_weight_block(wq: torch.Tensor, ws: Optional[torch.Tensor],
                         w_format: str, dtype) -> torch.Tensor:
    """Expand gathered weight blocks to ``dtype``: wq (..., K, N) dense,
    (..., K, N) int8 or (..., K/2, N) nibble-packed int8; ws (..., 1, N) f32
    per-output-channel scales (None for dense)."""
    if w_format == "dense":
        return wq
    if w_format == "int4":
        wq = unpack_int4(wq)
    return (wq.float() * ws).to(dtype)


def active_block_chunks(block_active: torch.Tensor, block_bytes: int,
                        budget: int = 1 << 30):
    """The indices of the active blocks, in order, cut into chunks whose
    gathered per-block operands (``block_bytes`` each) stay within
    ``budget`` bytes: the plain versions gather one weight matrix per
    block, which at a training shape on 8-row blocks would otherwise take
    tens of GB.  Reads ``block_active`` on the host, which the plain
    versions may do."""
    act = torch.nonzero(block_active).reshape(-1)
    step = max(1, budget // max(block_bytes, 1))
    return act.split(step)


def _block_products(x, ws, block_expert, block_active, block_m,
                    scales=None, w_format="dense"):
    """fp32 ``x[block] @ w[expert(block)]`` for each weight in ``ws``, as
    (num_blocks, block_m, N): computed for the active blocks only (their
    expert weights gathered, and dequantized, once per block, a chunk of
    blocks at a time), exact zeros for the others.  Finding the active
    blocks reads ``block_active`` on the host, which the plain version may
    do: the kernels never do."""
    cap, K = x.shape
    nb = cap // block_m
    xb = x.reshape(nb, block_m, K)
    outs = [torch.zeros((nb, block_m, w.shape[-1]), dtype=torch.float32,
                        device=x.device) for w in ws]
    for act in active_block_chunks(block_active, K * ws[0].shape[-1] * 4):
        xa = xb.index_select(0, act).float()
        idx = block_expert.index_select(0, act).long()
        for i, w in enumerate(ws):
            ws_i = None if scales is None else \
                scales[i].index_select(0, idx)[:, None, :]
            wb = dequant_weight_block(w.index_select(0, idx), ws_i, w_format,
                                      x.dtype)
            outs[i].index_copy_(0, act, torch.bmm(xa, wb.float()))
    return outs


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       block_expert: torch.Tensor, block_active: torch.Tensor,
                       *, block_m: int,
                       row_scale: Optional[torch.Tensor] = None,
                       w_scale: Optional[torch.Tensor] = None,
                       w_format: str = "dense") -> torch.Tensor:
    """x: (capacity, K); w: (E, K, N) or its payload; row_scale: (capacity,)
    f32 or None; w_scale: (E, N) f32 or None -> (capacity, N) in x's
    dtype."""
    (out,) = _block_products(x, [w], block_expert, block_active, block_m,
                             None if w_scale is None else [w_scale], w_format)
    out = out.reshape(x.shape[0], -1)
    if row_scale is not None:
        out = out * row_scale[:, None].float()
    return out.to(x.dtype)


def grouped_gemm_t_plain(x: torch.Tensor, w: torch.Tensor,
                         block_expert: torch.Tensor,
                         block_active: torch.Tensor, *,
                         block_m: int) -> torch.Tensor:
    """The backward's dX product: ``out[block m] = x[block m] @
    w[block_expert[m]]^T`` in fp32, zeros for inactive blocks.  x:
    (capacity, K); w: (E, N, K), the forward's (E, in, out) stack -> (capacity,
    N) in x's dtype."""
    cap, K = x.shape
    nb, N = cap // block_m, w.shape[1]
    xb = x.reshape(nb, block_m, K)
    out = torch.zeros((nb, block_m, N), dtype=torch.float32, device=x.device)
    for idx in active_block_chunks(block_active, N * K * 4):
        wb = w.index_select(0, block_expert.index_select(0, idx).long())
        out.index_copy_(0, idx, torch.bmm(xb.index_select(0, idx).float(),
                                          wb.float().transpose(1, 2)))
    return out.reshape(cap, N).to(x.dtype)


def check_gemm_operands(x, ws, block_expert, block_active, block_m,
                        w_format="dense", scales=None):
    """Shape, type and layout checks shared with fused_gate_up.  A dense
    weight has x's dtype; an int8 payload is (E, K, N) and an int4 one
    (E, K/2, N), each with (E, N) f32 scales, which may have any
    non-negative strides (per-expert scales come with a zero stride over
    N).  Returns (dtype code, capacity, K, N, format code)."""
    code = _build.dtype_code(x.dtype)
    _build.require(w_format in W_FORMATS,
                   f"grouped GEMM weight format {w_format!r} not in "
                   f"{W_FORMATS}")
    _build.require(x.dim() == 2 and x.is_contiguous(),
                   "grouped GEMM takes a contiguous (capacity, K) x")
    cap, K = x.shape
    N = ws[0].shape[-1]
    rows = K // 2 if w_format == "int4" else K
    wdt = x.dtype if w_format == "dense" else torch.int8
    for w in ws:
        _build.require(w.dim() == 3 and w.dtype == wdt
                       and w.is_contiguous() and w.shape[1] == rows
                       and w.shape == ws[0].shape,
                       f"grouped GEMM ({w_format}) takes contiguous (E, "
                       f"{rows}, N) weights of dtype {wdt}")
    E = ws[0].shape[0]
    if w_format == "dense":
        _build.require(scales is None, "dense weights take no w_scale")
    else:
        _build.require(scales is not None and len(scales) == len(ws)
                       and all(s is not None for s in scales),
                       f"{w_format} weights need their (E, N) w_scale")
        for s in scales:
            _build.require(s.dtype == torch.float32 and s.shape == (E, N)
                           and min(s.stride()) >= 0
                           and s.stride() == scales[0].stride(),
                           f"grouped GEMM takes float32 ({E}, {N}) w_scale "
                           "of one layout")
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
    return code, cap, K, N, W_FORMATS.index(w_format)


def work_list_args(x, ws, seg_start, kernel: str,
                   tile_rows: int = _tiles.TILE_ROWS):
    """(seg_start, scratch) for the C call when a Hopper kernel runs (bf16,
    on dense, int8 or int4 weights ``ws``): the schedule's seg_start, from
    which it finds each expert's run, and the work lists' scratch (for
    tiles of ``tile_rows`` rows).  It
    refuses a call without seg_start, or with x or a weight (or payload)
    off a 16-byte boundary (TMA).  (None, None) in fp32, which reads
    neither."""
    if x.dtype != torch.bfloat16:
        return None, None
    E = ws[0].shape[0]
    _build.require(seg_start is not None,
                   f"{kernel} in bf16 walks each expert's run of rows from "
                   "the schedule's seg_start: pass it")
    _build.require(seg_start.dtype == torch.int32
                   and seg_start.shape == (E,) and seg_start.is_contiguous(),
                   f"{kernel} takes a contiguous int32 ({E},) seg_start")
    _build.require(_build.aligned(x, *ws),
                   f"{kernel} takes x and the weights on 16-byte boundaries")
    return seg_start, _tiles.scratch(x.shape[0], E, x.device, tile_rows)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def scale_args(scales):
    """(pointer, stride over E, stride over N) of the first scale operand
    (all share one layout), or (None, 0, 0) for dense weights."""
    if scales is None:
        return None, 0, 0
    s = scales[0]
    return s.data_ptr(), s.stride(0), s.stride(1)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                 block_active: torch.Tensor, *, block_m: int,
                 row_scale: Optional[torch.Tensor] = None,
                 w_scale: Optional[torch.Tensor] = None,
                 w_format: str = "dense",
                 seg_start: Optional[torch.Tensor] = None,
                 tile_rows: Optional[int] = None,
                 block_n: Optional[int] = None) -> torch.Tensor:
    """CPU tensors run the plain version (``seg_start`` and the tile shape
    unused, the shape checked all the same); CUDA tensors the kernel, which
    in bf16 needs the schedule's ``seg_start`` and runs at ``(tile_rows,
    block_n)`` (None: the default, ``TILE_SHAPES``)."""
    tile = resolve_tile("grouped_gemm", w_format, x.dtype, tile_rows,
                        block_n)
    if shapes.is_fake(x, w):
        return shapes.grouped_gemm_shape(x, w, w_scale, w_format)
    if not _build.on_cuda(x, w, block_expert, block_active, row_scale,
                          w_scale, seg_start):
        return grouped_gemm_plain(x, w, block_expert, block_active,
                                  block_m=block_m, row_scale=row_scale,
                                  w_scale=w_scale, w_format=w_format)
    scales = None if w_scale is None else [w_scale]
    code, cap, K, N, fmt = check_gemm_operands(
        x, [w], block_expert, block_active, block_m, w_format, scales)
    if row_scale is not None:
        _build.require(row_scale.dtype == torch.float32
                       and row_scale.shape == (cap,)
                       and row_scale.is_contiguous(),
                       f"grouped GEMM takes a contiguous float32 ({cap},) "
                       "row_scale")
    seg, buf = work_list_args(x, [w], seg_start, "grouped_gemm", tile[0])
    lib = _build.library()
    out = torch.empty((cap, N), dtype=x.dtype, device=x.device)
    s_ptr, s_e, s_n = scale_args(scales)
    err = lib.moe_grouped_gemm(
        x.data_ptr(), w.data_ptr(), s_ptr, _ptr(seg),
        block_expert.data_ptr(), block_active.data_ptr(), _ptr(row_scale),
        _ptr(buf), out.data_ptr(), cap, K, N, w.shape[0], block_m, code, fmt,
        s_e, s_n, _build.stream_ptr(x.device), *tile)
    key = launch_key("grouped_gemm", w_format)
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    return out


def grouped_gemm_t(x: torch.Tensor, w: torch.Tensor, seg_start: torch.Tensor,
                   block_expert: torch.Tensor, block_active: torch.Tensor, *,
                   block_m: int) -> torch.Tensor:
    """``x @ w[e]^T`` per schedule block (``grouped_gemm_t_plain``), w
    dense (E, N, K) in x's dtype.  CPU tensors run the plain version; CUDA
    tensors the kernel: in bf16 a Hopper kernel over tiles of each expert's
    run of rows (from ``seg_start``, see ``expert_tiles``), in fp32 B1's
    template with the weight read transposed in place."""
    if shapes.is_fake(x, w):
        return shapes.grouped_gemm_t_shape(x, w)
    if not _build.on_cuda(x, w, seg_start, block_expert, block_active):
        return grouped_gemm_t_plain(x, w, block_expert, block_active,
                                    block_m=block_m)
    code = _build.dtype_code(x.dtype)
    _build.require(x.dim() == 2 and x.is_contiguous(),
                   "grouped_gemm_t takes a contiguous (capacity, K) x")
    cap, K = x.shape
    _build.require(w.dim() == 3 and w.dtype == x.dtype and w.is_contiguous()
                   and w.shape[2] == K,
                   f"grouped_gemm_t takes a contiguous (E, N, {K}) weight "
                   f"of dtype {x.dtype}")
    _build.require(_build.aligned(x, w),
                   "grouped_gemm_t takes x and w on 16-byte boundaries")
    E, N = w.shape[0], w.shape[1]
    _build.require(K % 16 == 0 and N % 16 == 0,
                   f"grouped_gemm_t takes K and N multiples of 16 (K={K}, "
                   f"N={N})")
    _build.require(block_m % 8 == 0 and cap % block_m == 0,
                   f"grouped_gemm_t takes block_m a multiple of 8 dividing "
                   f"capacity (block_m={block_m}, capacity={cap})")
    nb = cap // block_m
    for t, n in ((block_expert, nb), (block_active, nb), (seg_start, E)):
        _build.require(t.dtype == torch.int32 and t.shape == (n,)
                       and t.is_contiguous(),
                       f"grouped_gemm_t takes contiguous int32 schedule "
                       f"arrays ({n},)")
    lib = _build.library()
    buf = _tiles.scratch(cap, E, x.device)
    out = torch.empty((cap, N), dtype=x.dtype, device=x.device)
    err = lib.moe_grouped_gemm_t(
        x.data_ptr(), w.data_ptr(), seg_start.data_ptr(),
        block_expert.data_ptr(), block_active.data_ptr(), buf.data_ptr(),
        out.data_ptr(), cap, K, N, E, block_m, code,
        _build.stream_ptr(x.device))
    _build.check(err, "grouped_gemm_t")
    _build.LAUNCHES["grouped_gemm_t"] += 1
    return out
