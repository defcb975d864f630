"""Partition rules: parameters, optimizer state, batches, caches and
activations (counterpart of ``repro.distributed.sharding``), and the moves
between a full tensor and this rank's block of it.

Scheme (``DESIGN.md`` §5), on a grid of ranks (``distributed.group.Grid``):
  data axis  -> batch DP + FSDP storage of every weight matrix
  model axis -> EP (the routed expert stacks) and SP (the sequence of the
                residual stream)
  pod axis   -> extra DP (the gradient reduction crosses pods)

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names (the dim cut row-major over them, the first axis the
major one), as a ``PartitionSpec`` is.  Any axis that does not divide its
dim is dropped (the dim stays whole), as in the reference.  The rules are
pure functions of names, shapes and axis sizes: ``mesh`` is a ``Grid`` or
a mapping ``{axis name: size}``.

The reference keys its rules on the leaves of its stacked parameter tree;
the port keys the same rules on ``LM.named_parameters()`` names, one layer
a module, so the stacked leading dim of the reference's ``body`` leaves
does not appear here.

``shard`` cuts this rank's block out of a full tensor, ``unshard``
all-gathers the blocks back, and ``gather_param`` is ``unshard`` as an
autograd Function: its backward reduce-scatters the gradient over the same
axes, in fp32, into the block's gradient."""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


def _sizes(mesh) -> dict:
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def _axes(ax) -> tuple:
    return () if ax is None else ((ax,) if isinstance(ax, str)
                                  else tuple(ax))


def _norm(ax):
    """A 1-tuple of axes is its axis, an empty one None (as PartitionSpec
    normalizes them)."""
    if isinstance(ax, tuple):
        return None if not ax else (ax[0] if len(ax) == 1 else ax)
    return ax


def dp_axes(mesh):
    """Data-parallel axes: ('pod', 'data') with pods, ('data',) without."""
    return ("pod", "data") if "pod" in _sizes(mesh) else ("data",)


def _fits(dim: int, mesh, axes) -> bool:
    sizes = _sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return dim % n == 0


def _clean(spec, shape, mesh) -> tuple:
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        out.append(_norm(ax) if (ax is not None and _fits(dim, mesh, ax))
                   else None)
    return tuple(out)


def spec_axes(spec) -> tuple:
    """Every axis a spec shards over, in order."""
    return tuple(a for ax in spec for a in _axes(ax))


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------
_TP_COL = {"wq", "wk", "wv", "wg", "w_gate", "w_up", "wq_a", "wkv_a",
           "wq_b", "wkv_b", "in_proj", "wr", "w_lora_a", "w_lora_b"}
_TP_ROW = {"wo", "w_down", "out_proj"}
_REPLICATED = {"mu", "u", "w0", "a_log", "dt_bias", "d_skip", "scale", "bias",
               "mask_emb"}


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def is_expert_stack(shape, cfg: ModelConfig) -> bool:
    """A routed expert stack: rank 3 with the expert count leading."""
    shape = _shape(shape)
    return (len(shape) == 3 and cfg.is_moe
            and shape[0] == cfg.moe.n_experts)


def param_specs(params, cfg: ModelConfig, mesh,
                mode: str = "fsdp") -> Dict[str, tuple]:
    """``{name: spec}`` for ``params``, a mapping of names to tensors or
    shapes (``LM.named_parameters()``, or its buffers too).

    mode="fsdp"     - training: every matrix storage-sharded over (data,
                      model), gathered per layer (ZeRO-3); the routed
                      expert stacks ('model', 'data', None): EP ownership
                      and FSDP.
    mode="serve_tp" - decode: dense matrices feature-split over 'model'
                      (column for up/qkv projections, row for down/output)
                      and whole over 'data'; expert stacks as in fsdp."""
    if mode not in ("fsdp", "serve_tp"):
        raise ValueError(f"param_specs mode {mode!r}: fsdp or serve_tp")
    fsdp = dp_axes(mesh)[-1]                       # 'data'
    tp = mode == "serve_tp"
    out = {}
    for full, leaf in params.items():
        name = full.rsplit(".", 1)[-1]
        core = _shape(leaf)
        if len(core) <= 1 or name in _REPLICATED:
            spec = (None,) * len(core)
        elif name == "embed":
            spec = ("model", None if tp else fsdp)
        elif name == "head":
            spec = (None, "model") if tp else (fsdp, "model")
        elif name == "router":
            spec = (None, None)
        elif is_expert_stack(core, cfg):
            # dense stacks and quantized payloads: EP ownership + FSDP;
            # quantized scales: EP only
            spec = (("model", None, None)
                    if name == "s" or name.endswith("_s")
                    else ("model", fsdp, None))
        elif name == "conv_w":
            spec = (None, "model")
        elif tp and len(core) == 2:
            spec = (("model", None) if name in _TP_ROW
                    else (None, "model") if name in _TP_COL
                    else (None, None))
        else:                                      # generic matrices
            spec = (fsdp, "model") + (None,) * (len(core) - 2)
        out[full] = _clean(spec, core, mesh)
    return out


def opt_state_specs(param_spec_tree):
    """Adam moments share the parameters' layout."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}


# ----------------------------------------------------------------------
# Batches
# ----------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, mesh, mode: str, global_batch: int,
                microbatched: bool = False) -> Dict[str, tuple]:
    dp = dp_axes(mesh)
    bdp = dp if _fits(global_batch, mesh, dp) else \
        (dp[-1:] if _fits(global_batch, mesh, dp[-1]) else ())
    b = _norm(tuple(bdp)) if bdp else None
    seq_ax = "model" if (cfg.family not in ("ssm", "hybrid")
                         and mode != "decode") else None
    lead = (None,) if microbatched else ()
    specs = {}
    if cfg.encoder_only:
        specs["features"] = (*lead, b, seq_ax, None)
        specs["labels"] = (*lead, b, seq_ax)
        specs["mask"] = (*lead, b, seq_ax)
    else:
        specs["tokens"] = (*lead, b, seq_ax)
    if cfg.cross_attn_every:
        specs["image_embeds"] = (*lead, b, None, None)
    return specs


# ----------------------------------------------------------------------
# Decode caches
# ----------------------------------------------------------------------
def cache_specs(cache, cfg: ModelConfig, mesh, batch: int):
    """Sequence-sharded KV caches (flash-decode) for the port's cache, a
    list of one ``{name: tensor}`` mapping a layer; returns the same
    structure of specs."""
    dp = dp_axes(mesh)
    b_ok = _fits(batch, mesh, dp)
    b = _norm(tuple(dp)) if b_ok else None
    # when the batch cannot shard, the cache's sequence spreads over data too
    seq = "model" if b_ok else (tuple(dp) + ("model",))

    def rule(name, leaf):
        core = _shape(leaf)
        if name.startswith(("tm_", "cm_")):        # an rwkv block's time-mix
            name = name[3:]                        # and channel-mix leaves
        if name in ("k", "v", "ckv", "kr"):        # (B, S, ...) kv caches
            spec = (b, seq) + (None,) * (len(core) - 2)
        elif name == "state":                      # (B, H, ...) states
            spec = (b, "model") + (None,) * (len(core) - 2)
        elif name == "conv":                       # (B, K-1, C)
            spec = (b, None, "model")
        elif name == "shift":                      # (B, 1, d)
            spec = (b, None, None)
        else:
            spec = (None,) * len(core)
        return _clean(spec, core, mesh)

    return [{name: rule(name, leaf) for name, leaf in layer.items()}
            for layer in cache]


# ----------------------------------------------------------------------
# Activation rules (read by distributed/ctx.py's hooks)
# ----------------------------------------------------------------------
def activation_rules(cfg: ModelConfig, mesh, mode: str,
                     global_batch: int) -> Dict[str, tuple]:
    dp = dp_axes(mesh)
    b = dp if _fits(global_batch, mesh, dp) else \
        (dp[-1:] if _fits(global_batch, mesh, dp[-1]) else None)
    b = _norm(tuple(b)) if b else None
    if cfg.family in ("ssm", "hybrid"):
        return {
            "residual": (b, None, None),
            "heads4": (b, None, "model", None),
            "channels3": (b, None, "model"),
            "qkv": (b, None, "model", None),
        }
    # "moe_dispatch": the permuted (capacity, d) expert-contiguous buffer,
    # a data-dependent row order: never sharded over 'model'
    if mode == "decode":
        return {
            "residual": (b, None, None),
            "qkv": (b, None, None, None),
            "moe_dispatch": (b, None),
        }
    # train/prefill: SP, the sequence over model
    return {
        "residual": (b, "model", None),
        "q_seq": (b, "model", None, None),
        "kv_full": (b, None, None, None),
        "moe_tokens": (b, "model", None),
        "moe_dispatch": (b, None),
    }


# ----------------------------------------------------------------------
# Full tensor <-> this rank's block
# ----------------------------------------------------------------------
def _member_blocks(ax, grid) -> list:
    """For each member of ``grid.group(ax)``, in rank order, the index of
    its block on a dim cut over ``ax`` (in ``ax``'s order)."""
    axes = _axes(ax)
    canon = [a for a in ("pod", "data", "model") if a in axes]
    sizes = [grid.sizes[a] for a in canon]
    out = []
    for coords in itertools.product(*(range(n) for n in sizes)):
        c = dict(zip(canon, coords))
        i = 0
        for a in axes:
            i = i * grid.sizes[a] + c[a]
        out.append(i)
    return out


def block_slices(shape, spec, grid) -> tuple:
    """One slice a dim: where this rank's block of a full tensor of
    ``shape`` lies under ``spec``."""
    out = []
    for dim, n_full in enumerate(shape):
        ax = spec[dim] if dim < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        n = grid.size(_axes(ax))
        if n_full % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not cut "
                             f"into {n} blocks over {ax}")
        step = n_full // n
        i = grid.index(_axes(ax))
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def full_shape(shape, spec, grid) -> tuple:
    """The full tensor's shape from a block's."""
    return tuple(n * (1 if i >= len(spec) or spec[i] is None
                      else grid.size(_axes(spec[i])))
                 for i, n in enumerate(shape))


def shard(t: torch.Tensor, spec, grid) -> torch.Tensor:
    """This rank's block of the full ``t`` under ``spec``, a contiguous
    copy (so the full tensor can be freed)."""
    return t[block_slices(t.shape, spec, grid)].clone(
        memory_format=torch.contiguous_format)


def _gather_dim(t: torch.Tensor, dim: int, ax, grid) -> torch.Tensor:
    g = grid.group(_axes(ax))
    if g.size == 1:
        return t
    parts = g.all_gather(t).unbind(0)
    order = _member_blocks(ax, grid)
    blocks = [None] * len(parts)
    for member, blk in enumerate(order):
        blocks[blk] = parts[member]
    return torch.cat(blocks, dim=dim)


def _scatter_dim(t: torch.Tensor, dim: int, ax, grid) -> torch.Tensor:
    g = grid.group(_axes(ax))
    if g.size == 1:
        return t
    order = _member_blocks(ax, grid)
    if order != sorted(order):        # blocks to rank order first
        chunks = t.chunk(g.size, dim=dim)
        t = torch.cat([chunks[blk] for blk in order], dim=dim)
    return g.reduce_scatter(t, dim=dim)


@torch.no_grad()
def unshard(t: torch.Tensor, spec, grid) -> torch.Tensor:
    """The full tensor from every rank's block (all-gathers over each
    sharded dim's axes)."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = _gather_dim(t, dim, ax, grid)
    return t


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, grid, dtype):
        ctx.spec, ctx.grid, ctx.dtype = spec, grid, block.dtype
        t = block.to(dtype)
        for dim, ax in enumerate(spec):
            if ax is not None:
                t = _gather_dim(t, dim, ax, grid)
        return t

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        for dim in reversed(range(len(ctx.spec))):
            ax = ctx.spec[dim]
            if ax is not None:
                g = _scatter_dim(g, dim, ax, ctx.grid)
        return g.to(ctx.dtype), None, None, None


def gather_param(block: torch.Tensor, spec, grid,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The full parameter in ``dtype`` (default the block's) from every
    rank's block, differentiable: the backward reduce-scatters the full
    gradient, in fp32, over the same axes.  A cast is elementwise, so
    gathering in the compute dtype equals casting the gathered fp32 tensor,
    at half the bytes."""
    dtype = block.dtype if dtype is None else dtype
    if all(ax is None for ax in spec):
        return block.to(dtype)
    return _GatherParam.apply(block, tuple(spec), grid, dtype)


def replicated_axes(spec, grid) -> tuple:
    """The grid's axes of more than one rank that ``spec`` does not shard
    over: a parameter's gradient sums over them."""
    used = set(spec_axes(spec))
    return tuple(a for a in grid.axis_names
                 if grid.sizes[a] > 1 and a not in used)


def gather_spec(spec, shape, cfg: ModelConfig) -> tuple:
    """The part of a parameter's spec that its layer gathers: all of it,
    but for a routed expert stack, whose 'model' axis is ownership (each
    model rank computes its own experts)."""
    if is_expert_stack(shape, cfg) and spec and spec[0] == "model":
        return (None,) + tuple(spec[1:])
    return tuple(spec)
