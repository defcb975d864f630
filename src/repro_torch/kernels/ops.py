"""Schedule-level wrappers for the MoE kernels (counterpart of
``repro.kernels.ops``): each adapts a ``BlockSchedule`` to its kernel's
arguments.  The forward's five, and the backward's two: ``grouped_gemm_t``
(B1 with the weight read transposed) and ``grouped_wgrad`` (B7).  The four
GEMMs pass the schedule's ``seg_start``, from which their Hopper kernels
find each expert's run of rows.  Block sizes are the kernels' own (csrc/);
nothing here carries the TPU's (8, 128) tiling over.  The GEMM wrappers take an expert stack as
a dense tensor or a ``QuantTensor``; ``_weight_operands`` splits the latter
into the payload, its (E, N) channel scales and the kernel's weight format.

``LAUNCHES`` holds one launch counter per kernel, the paged-attention
kernel's too (the wrappers increment it where they launch);
``reset_launches`` sets them all to 0.

``grouped_gemm`` and ``fused_gate_up`` take ``autotune``: True looks up
this call's shape key in the tune cache (``repro_torch.tuning``) and runs
the kernel at the recorded tile shape; a miss keeps the default.  The key's
M is the routed rows T·k, ``sched.pos.numel()``, which the host knows
without a sync (the reference keys its lookup on the schedule's capacity,
which its sweeps never record: ROADMAP C9)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_gate_up as _fgu
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import grouped_wgrad as _wg
from repro_torch.kernels import permute as _perm
from repro_torch.kernels import router_topk as _router
from repro_torch.kernels import unpermute as _unperm
from repro_torch.quantization import QuantTensor, get_scheme
from repro_torch.scheduling import BlockSchedule
from repro_torch.tuning.cache import dtype_name, lookup_block_sizes

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches

def _tuned_tile(kernel: str, x: torch.Tensor, sched: BlockSchedule, K: int,
                N: int, E: int, fmt: str):
    """(tile_rows, block_n) of this call's shape key's record, or (None,
    None) on a miss (the kernel's default)."""
    rec = lookup_block_sizes(kernel, M=sched.pos.numel(), K=K, N=N, E=E,
                             dtype=dtype_name(x.dtype), scheme=fmt)
    if rec is None:
        return None, None
    return rec["block_m"], rec["block_n"]


def router_topk(logits: torch.Tensor, *, top_k: int, gating: str = "softmax",
                norm_topk: bool = False, routed_scale: float = 1.0):
    return _router.router_topk(logits, top_k=top_k, gating=gating,
                               norm_topk=norm_topk, routed_scale=routed_scale)


def permute(x: torch.Tensor, sched: BlockSchedule) -> torch.Tensor:
    return _perm.permute(x, sched.src_tok)


def unpermute(y: torch.Tensor, sched: BlockSchedule,
              weights: Optional[torch.Tensor]) -> torch.Tensor:
    return _unperm.unpermute(y, sched.pos, weights)


def _weight_operands(w):
    """An expert stack -> (weights, (E, N) f32 scales or None, format).

    A dense tensor passes as is.  A ``QuantTensor`` gives its payload and
    its scheme's channel scales, a view of its own scales (per-expert ones
    with a zero stride over N), so nothing is built per call.  A padded
    layout (int4 with an odd K) has no in-kernel path and is materialized,
    as in the reference."""
    if isinstance(w, QuantTensor):
        if w.meta:
            return w.materialize(), None, "dense"
        sch = get_scheme(w.scheme)
        return w.q, sch.channel_scales(w), sch.kernel_format
    return w, None, "dense"


def grouped_gemm(x: torch.Tensor, w, sched: BlockSchedule,
                 row_scale: Optional[torch.Tensor] = None, *,
                 autotune: bool = False) -> torch.Tensor:
    """``w``: an (E, K, N) tensor or a QuantTensor (in-kernel dequant).
    ``autotune`` runs the tune cache's tile shape for this call's key."""
    wq, ws, fmt = _weight_operands(w)
    tile_rows = block_n = None
    if autotune:
        K, N = x.shape[1], wq.shape[-1]
        tile_rows, block_n = _tuned_tile("grouped_gemm", x, sched, K, N,
                                         wq.shape[0], fmt)
    return _gg.grouped_gemm(x, wq, sched.block_expert, sched.block_active,
                            block_m=sched.block_m, row_scale=row_scale,
                            w_scale=ws, w_format=fmt,
                            seg_start=sched.seg_start, tile_rows=tile_rows,
                            block_n=block_n)


def fused_gate_up(x: torch.Tensor, w_gate, w_up,
                  sched: BlockSchedule, *,
                  autotune: bool = False) -> torch.Tensor:
    """``w_gate``/``w_up``: (E, K, F) tensors or QuantTensors under one
    scheme.  ``autotune`` as in ``grouped_gemm``."""
    wgq, wsg, fmt = _weight_operands(w_gate)
    wuq, wsu, fmt_u = _weight_operands(w_up)
    if fmt != fmt_u:
        raise ValueError(f"fused_gate_up takes both weights in one format, "
                         f"not {fmt!r} and {fmt_u!r}")
    tile_rows = block_n = None
    if autotune:
        K, F = x.shape[1], wgq.shape[-1]
        tile_rows, block_n = _tuned_tile("fused_gate_up", x, sched, K, F,
                                         wgq.shape[0], fmt)
    return _fgu.fused_gate_up(x, wgq, wuq, sched.block_expert,
                              sched.block_active, block_m=sched.block_m,
                              wg_scale=wsg, wu_scale=wsu, w_format=fmt,
                              seg_start=sched.seg_start, tile_rows=tile_rows,
                              block_n=block_n)


def _seg_start(sched: BlockSchedule, kernel: str) -> torch.Tensor:
    if sched.seg_start is None:
        raise ValueError(f"{kernel} walks each expert's blocks from the "
                         "schedule's seg_start, which this schedule lacks")
    return sched.seg_start


def grouped_gemm_t(x: torch.Tensor, w: torch.Tensor,
                   sched: BlockSchedule) -> torch.Tensor:
    """The dX product ``x[block] @ w[e]^T``: x (capacity, N) against the
    forward's dense (E, K, N) stack -> (capacity, K)."""
    return _gg.grouped_gemm_t(x, w, _seg_start(sched, "grouped_gemm_t"),
                              sched.block_expert, sched.block_active,
                              block_m=sched.block_m)


def grouped_wgrad(x: torch.Tensor, dy: torch.Tensor, sched: BlockSchedule,
                  n_experts: int, out_dtype=torch.float32) -> torch.Tensor:
    """Training-backward tgmm: ``dW[e] = x_e^T dy_e`` over the padded
    layout, (E, K, N) summed in fp32 and rounded once to ``out_dtype``,
    exact zeros for experts with no rows."""
    return _wg.grouped_wgrad(x, dy, _seg_start(sched, "grouped_wgrad"),
                             sched.block_expert, sched.block_active,
                             block_m=sched.block_m, n_experts=n_experts,
                             out_dtype=out_dtype)
