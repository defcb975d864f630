"""Activation layouts on a grid of ranks (counterpart of
``repro.distributed.ctx``).

In the reference ``constrain("<hook>", x)`` hints a layout to GSPMD at
its hook points (``residual``, ``q_seq``, ``kv_full``, ``moe_tokens``,
``moe_dispatch``), which moves the data.  In the port the tensor a rank
holds IS its block: the train path's activations are local blocks in the
``residual`` rule's layout (the batch over the data axes, the sequence
over 'model', trailing dims whole), which is already the layout of
``q_seq`` and ``moe_tokens``, and the dispatch buffer is built on the rank
from what it holds.  So only ``kv_full`` moves anything, and the port calls
``constrain`` there alone: it gathers K and V over 'model' (every query of
a rank's sequence block attends to the whole sequence), and its backward
reduce-scatters dK and dV.  Outside a ``use_rules`` context it is a no-op,
so the one-device path never sees a grid.

``global_sum`` is the all-reduce that turns per-rank partial sums (the
loss's, the router's statistics) into the global value every rank holds.
Each rank backpropagates that same replicated value with seed 1, so the
gradient of the sum is each rank's own: its backward is the identity."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from repro_torch.distributed.sharding import (_axes, _gather_dim, _norm,
                                              _scatter_dim)

# Process-wide, not thread-local as the reference's: the autograd engine
# runs a CUDA backward on a thread of its own, and under remat the layers'
# forward (and its hooks) runs again there.
_STATE = [None, None]              # rules, grid


def current_rules():
    """(rules, grid) of the innermost ``use_rules``, or (None, None)."""
    return _STATE[0], _STATE[1]


@contextlib.contextmanager
def use_rules(grid, rules: Dict[str, tuple]):
    prev = current_rules()
    _STATE[:] = [rules, grid]
    try:
        yield
    finally:
        _STATE[:] = list(prev)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, grid):
        ctx.dim, ctx.ax, ctx.grid = dim, ax, grid
        return _gather_dim(x, dim, ax, grid)

    @staticmethod
    def backward(ctx, grad):
        g = _scatter_dim(grad.float(), ctx.dim, ctx.ax, ctx.grid)
        return g.to(grad.dtype), None, None, None


def gather_dim(x: torch.Tensor, dim: int, ax, grid) -> torch.Tensor:
    """All-gather ``x``'s blocks on ``dim`` over the axes ``ax``;
    differentiable (the backward reduce-scatters, in fp32)."""
    if grid.size(_axes(ax)) == 1:
        return x
    return _GatherDim.apply(x, dim, ax, grid)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; differentiable under
    the convention that every rank backpropagates the same replicated
    value (the backward is the identity)."""
    if group is None or group.size == 1:
        return x
    return _GlobalSum.apply(x, group)


def constrain(name: str, x: torch.Tensor) -> torch.Tensor:
    """Bring a (B, S, ...) block in the ``residual`` layout to the layout of
    rule ``name``: all-gather the sequence over the axes ``residual`` cuts
    it by and the rule does not (``kv_full``: every rank's K and V; the
    backward reduce-scatters).  The port calls it only where it moves data:
    the train path's other hooks find their layout already in place."""
    rules, grid = current_rules()
    if rules is None:
        return x
    have, want = _axes(rules["residual"][1]), _axes(rules[name][1])
    drop = tuple(a for a in have if a not in want)
    return gather_dim(x, 1, _norm(drop), grid) if drop else x


def block_offset(dim: int, n_local: int) -> int:
    """Where this rank's block starts on ``dim`` of the ``residual``
    layout, a block being ``n_local`` long (0 outside ``use_rules``): a
    rank's first sequence position is ``m * S_local``."""
    rules, grid = current_rules()
    if rules is None:
        return 0
    ax = rules["residual"][dim]
    return 0 if ax is None else grid.index(_axes(ax)) * n_local


def token_ids(B_local: int, S_local: int, device) -> torch.Tensor:
    """(B_local * S_local,) int32: each local token's index in the whole
    batch's (b, s) flatten order under the ``residual`` layout."""
    rules, grid = current_rules()
    S = S_local * (1 if rules is None else
                   grid.size(_axes(rules["residual"][1])))
    b = torch.arange(B_local, dtype=torch.int32, device=device) \
        + block_offset(0, B_local)
    s = torch.arange(S_local, dtype=torch.int32, device=device) \
        + block_offset(1, S_local)
    return (b[:, None] * S + s[None, :]).reshape(-1)
