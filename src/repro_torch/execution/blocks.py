"""``blocks`` executor: the paper's block schedule as a loop over M-tiles
in plain PyTorch (counterpart of ``repro.execution.xla``, whose
``lax.scan`` over the blocks this loop is).

Each step gathers its block's expert weight with the device index
``block_expert[i]`` and zeroes an inactive block by ``block_active[i]``:
the block count, ``capacity // block_m``, is a Python int, so the loop
reads nothing from the device, and no ``(blocks, K, N)`` weight gather is
ever built.  The products take the operands' values exactly and sum in
fp32 (``preferred_element_type=jnp.float32``), then SiLU times up in fp32,
as the reference's.  Differentiable through autograd alone: a second
training path beside ``cuda``'s kernels.

Quantized expert stacks pass through ``prepare_weights``: the per-step
``w[e]`` of a ``QuantTensor`` gathers the compressed block and its scales
and dequantizes that one expert (``QuantTensor.__getitem__``), any
registered scheme.

Where it differs from ``cuda``: the folded combine weights (``row_scale``)
are rounded to the output dtype before the multiply, as
``grouped_gemm_xla`` does, where B1 applies them in fp32.  ``autotune`` is
ignored (no tiles to tune).  It launches none of the port's kernels."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.execution.base import Executor, register_executor
from repro_torch.kernels import ref
from repro_torch.scheduling import BlockSchedule


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 products and sums."""
    return torch.matmul(a.float(), b.float())


def _gemm_blocks(x: torch.Tensor, sched: BlockSchedule,
                 step_fn: Callable) -> torch.Tensor:
    """``step_fn(x_block, w_index)`` on every block, inactive ones zeroed;
    ``w_index`` is the (1,) device index of the block's expert, and each
    step returns x's dtype."""
    M = sched.block_m
    xb = x.reshape(sched.capacity // M, M, x.shape[-1])
    experts = sched.block_expert.long()
    active = sched.block_active.to(x.dtype)
    outs = [step_fn(xb[i], experts[i:i + 1]) * active[i]
            for i in range(xb.shape[0])]
    return torch.cat(outs).reshape(sched.capacity, -1)


def fused_gate_up_blocks(x: torch.Tensor, w_gate, w_up,
                         sched: BlockSchedule) -> torch.Tensor:
    """silu(x @ Wg[e]) * (x @ Wu[e]) a block, in fp32, cast to x's dtype.
    x: (capacity, K); w_*: (E, K, N) or ``QuantTensor`` -> (capacity, N)."""
    def step(xblk, e):
        g = _dot(xblk, w_gate[e][0])
        u = _dot(xblk, w_up[e][0])
        return ((g * torch.sigmoid(g)) * u).to(x.dtype)
    return _gemm_blocks(x, sched, step)


def grouped_gemm_blocks(x: torch.Tensor, w, sched: BlockSchedule,
                        row_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """x[block] @ W[e] a block, cast to x's dtype; ``row_scale``
    (capacity,) is rounded to that dtype and multiplied in after the cast,
    as the reference's ``grouped_gemm_xla``.  -> (capacity, N)."""
    out = _gemm_blocks(x, sched,
                       lambda xblk, e: _dot(xblk, w[e][0]).to(x.dtype))
    if row_scale is not None:
        out = out * row_scale[:, None].to(out.dtype)
    return out


@register_executor("blocks")
class BlocksExecutor(Executor):

    def prepare_weights(self, w, cfg):
        return w            # per-block dequant: w[e] expands one expert

    def permute(self, x, sched, cfg):
        return ref.permute_ref(x, sched)

    def expert_ffn(self, xp, w, sched, cfg, row_scale=None):
        if cfg.fuse_gate_up:
            h = fused_gate_up_blocks(xp, w["w_gate"], w["w_up"], sched)
        else:
            g = grouped_gemm_blocks(xp, w["w_gate"], sched)
            u = grouped_gemm_blocks(xp, w["w_up"], sched)
            gf = g.float()
            h = ((gf * torch.sigmoid(gf)) * u.float()).to(xp.dtype)
        return grouped_gemm_blocks(h, w["w_down"], sched,
                                   row_scale=row_scale)

    def unpermute(self, y, sched, weights, cfg):
        return ref.unpermute_ref(y, sched, weights)
