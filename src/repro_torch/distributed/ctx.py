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
gradient of the sum is each rank's own: its backward is the identity.

The recurrent families' rules (``ssm``, ``hybrid``) keep whole sequences
on every 'model' rank (``residual`` cuts the batch only) and split heads
and channels over 'model' instead (``heads4``, ``channels3``, ``qkv``):
tensor-parallel heads.  ``head_slice`` is this rank's block of a head or
channel dim under such a rule, and ``head_sum`` the all-reduce over the
ranks that split it: after a row-split output projection (each rank's
heads' share of the output), and inside the norms whose statistics run
over every channel.  The gradients keep one convention throughout: a
parameter's gradient is the sum over ranks of each rank's share (the
layer gathers reduce-scatter, ``train.step.reduce_grads`` all-reduces
over the rest).  So the 'model' ranks that hold the same tokens count
their loss once between them (``token_replicas``: ``models.lm.loss_fn``
divides by it), a value every rank computes alike (the residual, its
norms, the MLPs) passes each rank's share of its gradient back, and
``head_sum`` is its own adjoint: its backward all-reduces too.  Where the
whole residual enters a head-split projection no collective is needed:
each rank's share of the residual's gradient is its heads' part, and the
sums downstream of the residual add the shares up."""
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
    the train path's other hooks find their layout already in place.  The
    recurrent families' rules have no ``kv_full`` (their ranks hold whole
    sequences): there it leaves ``x`` as it is."""
    rules, grid = current_rules()
    if rules is None or (name == "kv_full" and name not in rules):
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


def _split_axes(rule: str, dim: int) -> tuple:
    rules, grid = current_rules()
    if rules is None or rule not in rules:
        return ()
    return tuple(a for a in _axes(rules[rule][dim]) if grid.sizes[a] > 1)


def head_slice(rule: str, dim: int, n: int) -> slice:
    """This rank's block of the ``n`` entries of ``dim`` (heads or
    channels) in rule ``rule``'s layout: ``slice(0, n)`` outside
    ``use_rules`` and where the rule does not cut ``dim``."""
    axes = _split_axes(rule, dim)
    if not axes:
        return slice(0, n)
    _, grid = current_rules()
    m = grid.size(axes)
    if n % m:
        raise ValueError(f"{n} heads or channels do not split over the "
                         f"{m} ranks of {axes} (rule {rule!r})")
    i = grid.index(axes)
    return slice(i * (n // m), (i + 1) * (n // m))


class _HeadSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.float()).to(grad.dtype), None


def head_sum(x: torch.Tensor, rule: str, dim: int) -> torch.Tensor:
    """The sum of every rank's ``x`` over the ranks that split ``dim`` of
    rule ``rule`` (each rank's heads' share of an output, or of a norm's
    statistics), summed in fp32 and returned in ``x``'s dtype; ``x``
    itself where nothing splits it.  Its backward all-reduces the gradient
    too (the module docstring's convention)."""
    axes = _split_axes(rule, dim)
    if not axes:
        return x
    return _HeadSum.apply(x, current_rules()[1].group(axes))


def token_replicas() -> int:
    """How many ranks hold each token of the batch: the grid's ranks over
    those the ``residual`` rule's batch and sequence dims cut (1 outside
    ``use_rules``, and under sequence parallelism; the 'model' size under
    the recurrent families' rules)."""
    rules, grid = current_rules()
    if rules is None:
        return 1
    res = rules["residual"]
    return grid.world.size // grid.size(_axes(res[0]) + _axes(res[1]))
