"""The kernels' shape-only path, for fake and meta tensors (the dry run,
``launch/dryrun.py``).

A wrapper handed fake tensors (``torch._subclasses.FakeTensor``, as under
``FakeTensorMode``) or tensors on the meta device calls the matching op
here instead of its plain version or its kernel.  Each op is a
``torch.library.custom_op`` in the ``repro_torch`` namespace whose fake
implementation gives every output's shape and dtype and computes nothing,
and whose flop formula (``torch.utils.flop_counter``) gives the FLOPs the
kernel does: for B1, B2, B1ᵀ and B7, ``2 * rows * K * N`` over every row
of the schedule's static capacity, padding included, B1 and B2 on dense,
int8 or int4 weights alike (the schedule's
waste, which ``analysis/flops.py``'s dispatch FLOPs model); for B6 its
score and value products over every position of the rows' tables; none
for B3, B4, B5, which do no matrix product.  ``FlopCounterMode`` then
counts a dry step's kernels as it counts its ``aten`` products.

Real tensors never come here: a CPU tensor runs the plain version and a
CUDA tensor the kernel, as before.  The ops' eager bodies raise.

The WKV6 recurrence of ``models/rwkv6.py`` (no kernel: a loop over the
positions in plain PyTorch) takes the same path under fake tensors, with
an autograd formula: a full-size sequence is tens of thousands of
positions a layer, each a few ops through fake-tensor dispatch.
Its flop formula is the loop's own matrix products (a position's (1 x n)
by (n x n) product a head, and the two a position in its backward), so a
dry step counts what ``FlopCounterMode`` counts of the loop; its memory is
its outputs only (the loop's per-position tensors are not modelled)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula


def is_fake(*tensors) -> bool:
    """True when every one of ``tensors`` (None aside) is a fake tensor or
    lies on the meta device: the shape-only path runs.  A mix with real
    tensors is not fake: the wrapper's device check refuses it."""
    seen = False
    for t in tensors:
        if t is None:
            continue
        if not (isinstance(t, FakeTensor) or t.is_meta):
            return False
        seen = True
    return seen


def _eager(name: str):
    raise RuntimeError(f"repro_torch::{name} is the shape-only path of a "
                       "kernel: it runs on fake or meta tensors only")


# ---------------------------------------------------------------- B5
@custom_op("repro_torch::router_topk_shape", mutates_args=())
def router_topk_shape(logits: torch.Tensor,
                      top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _eager("router_topk_shape")


@router_topk_shape.register_fake
def _(logits, top_k):
    T = logits.shape[0]
    return (logits.new_empty((T, top_k), dtype=torch.float32),
            logits.new_empty((T, top_k), dtype=torch.int32))


# ---------------------------------------------------------------- B3
@custom_op("repro_torch::permute_shape", mutates_args=())
def permute_shape(x: torch.Tensor, src_tok: torch.Tensor) -> torch.Tensor:
    _eager("permute_shape")


@permute_shape.register_fake
def _(x, src_tok):
    return x.new_empty((src_tok.shape[0], x.shape[1]))


# ---------------------------------------------------------------- B4
@custom_op("repro_torch::unpermute_shape", mutates_args=())
def unpermute_shape(y: torch.Tensor, pos: torch.Tensor,
                    weights: Optional[torch.Tensor]) -> torch.Tensor:
    _eager("unpermute_shape")


@unpermute_shape.register_fake
def _(y, pos, weights):
    return y.new_empty((pos.shape[0], y.shape[1]))


# ---------------------------------------------------------------- B1, B2
# The weights come as the kernels take them: a dense (E, K, N) stack, or
# a quantized payload ((E, K, N) int8, or (E, K/2, N) nibble pairs for
# int4) with its (E, N) fp32 scales and ``w_format``; the FLOPs are the
# dense product's over every scheduled row whatever the format.
_PACKED_ROWS = {"dense": 1, "int8": 1, "int4": 2}


def _check_weight(name: str, x, w, w_scale, w_format: str) -> None:
    if w_format not in _PACKED_ROWS:
        raise ValueError(f"{name}: unknown weight format {w_format!r}")
    K = x.shape[1]
    if w.dim() != 3 or w.shape[1] * _PACKED_ROWS[w_format] != K:
        raise ValueError(f"{name}: {w_format} weights {tuple(w.shape)} "
                         f"for rows of {K}")
    if (w_scale is None) != (w_format == "dense"):
        raise ValueError(f"{name}: {w_format} weights "
                         + ("take no scales" if w_format == "dense"
                            else "need their (E, N) scales"))
    if w_scale is not None and tuple(w_scale.shape) != (w.shape[0],
                                                        w.shape[2]):
        raise ValueError(f"{name}: scales {tuple(w_scale.shape)} for "
                         f"weights {tuple(w.shape)}")


@custom_op("repro_torch::grouped_gemm_shape", mutates_args=())
def grouped_gemm_shape(x: torch.Tensor, w: torch.Tensor,
                       w_scale: Optional[torch.Tensor],
                       w_format: str) -> torch.Tensor:
    _eager("grouped_gemm_shape")


@grouped_gemm_shape.register_fake
def _(x, w, w_scale, w_format):
    _check_weight("grouped_gemm", x, w, w_scale, w_format)
    return x.new_empty((x.shape[0], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.grouped_gemm_shape)
def _(x_shape, w_shape, *args, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[2]


@custom_op("repro_torch::fused_gate_up_shape", mutates_args=())
def fused_gate_up_shape(x: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, wg_scale: Optional[torch.Tensor],
                        wu_scale: Optional[torch.Tensor],
                        w_format: str) -> torch.Tensor:
    _eager("fused_gate_up_shape")


@fused_gate_up_shape.register_fake
def _(x, w_gate, w_up, wg_scale, wu_scale, w_format):
    for w, ws in ((w_gate, wg_scale), (w_up, wu_scale)):
        _check_weight("fused_gate_up", x, w, ws, w_format)
    return x.new_empty((x.shape[0], w_gate.shape[2]))


@register_flop_formula(torch.ops.repro_torch.fused_gate_up_shape)
def _(x_shape, wg_shape, *args, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * 2 * wg_shape[2]


# ---------------------------------------------------------------- B1ᵀ
@custom_op("repro_torch::grouped_gemm_t_shape", mutates_args=())
def grouped_gemm_t_shape(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _eager("grouped_gemm_t_shape")


@grouped_gemm_t_shape.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], w.shape[1]))


@register_flop_formula(torch.ops.repro_torch.grouped_gemm_t_shape)
def _(x_shape, w_shape, *args, **kwargs) -> int:
    return 2 * x_shape[0] * w_shape[1] * w_shape[2]


# ---------------------------------------------------------------- B7
@custom_op("repro_torch::grouped_wgrad_shape", mutates_args=())
def grouped_wgrad_shape(x: torch.Tensor, dy: torch.Tensor, n_experts: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    _eager("grouped_wgrad_shape")


@grouped_wgrad_shape.register_fake
def _(x, dy, n_experts, out_dtype):
    return x.new_empty((n_experts, x.shape[1], dy.shape[1]),
                       dtype=out_dtype)


@register_flop_formula(torch.ops.repro_torch.grouped_wgrad_shape)
def _(x_shape, dy_shape, *args, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * dy_shape[1]


# ---------------------------------------------------------------- B6
@custom_op("repro_torch::paged_attention_shape", mutates_args=())
def paged_attention_shape(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          q2: Optional[torch.Tensor],
                          k2_pool: Optional[torch.Tensor]) -> torch.Tensor:
    _eager("paged_attention_shape")


@paged_attention_shape.register_fake
def _(q, k_pool, v_pool, tables, q2, k2_pool):
    return q.new_empty(tuple(q.shape[:3]) + (v_pool.shape[-1],))


@register_flop_formula(torch.ops.repro_torch.paged_attention_shape)
def _(q_shape, k_shape, v_shape, t_shape, q2_shape, k2_shape, *args,
      **kwargs) -> int:
    B, Hkv, G, D = q_shape
    d_score = D + (q2_shape[3] if q2_shape is not None else 0)
    positions = t_shape[1] * k_shape[1]          # nb blocks of bs positions
    return 2 * B * Hkv * G * positions * (d_score + v_shape[-1])


# ---------------------------------------------------------------- WKV6
@custom_op("repro_torch::wkv_recurrence_shape", mutates_args=())
def wkv_recurrence_shape(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor,
                         state: torch.Tensor) -> List[torch.Tensor]:
    _eager("wkv_recurrence_shape")


@wkv_recurrence_shape.register_fake
def _(r, k, v, w, u, state):
    return [r.new_empty(r.shape), state.new_empty(state.shape)]


@register_flop_formula(torch.ops.repro_torch.wkv_recurrence_shape)
def _(r_shape, *args, **kwargs) -> int:
    B, S, H, n = r_shape
    return 2 * B * S * H * n * n


@custom_op("repro_torch::wkv_recurrence_grad_shape", mutates_args=())
def wkv_recurrence_grad_shape(r: torch.Tensor, state: torch.Tensor,
                              u: torch.Tensor) -> List[torch.Tensor]:
    _eager("wkv_recurrence_grad_shape")


@wkv_recurrence_grad_shape.register_fake
def _(r, state, u):
    return [r.new_empty(r.shape) for _ in range(4)] \
        + [u.new_empty(u.shape), state.new_empty(state.shape)]


@register_flop_formula(torch.ops.repro_torch.wkv_recurrence_grad_shape)
def _(r_shape, *args, **kwargs) -> int:
    B, S, H, n = r_shape
    return 2 * 2 * B * S * H * n * n


def _wkv_setup(ctx, inputs, output):
    r, k, v, w, u, state = inputs
    ctx.save_for_backward(r, state, u)


def _wkv_backward(ctx, grads):
    r, state, u = ctx.saved_tensors
    dr, dk, dv, dw, du, ds = wkv_recurrence_grad_shape(r, state, u)
    return dr, dk, dv, dw, du, ds


wkv_recurrence_shape.register_autograd(_wkv_backward, setup_context=_wkv_setup)
