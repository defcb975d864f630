"""Carry the JAX package's parameters over to the port.

``from_jax_params(cfg, tree)`` takes the reference's parameter tree
(``repro.models.lm.init_params`` layout) with every leaf already a numpy
array (the caller runs ``jax.tree.map(np.asarray, params)``; this module
does not import JAX) and returns the port's ``LM`` holding the same
weights; ``from_jax_tree`` maps any tree of that layout (gradients,
updated parameters) onto the port's parameter names.  The stacked
``body`` leaves are unstacked along axis 0: group g's blocks ``b0``,
``b1``, ... become one layer each, in that order, followed by the
``suffix`` blocks; every ``(in, out)`` matrix keeps its layout, and biases,
norms, post norms, ``ln0`` and an encoder's ``mask_emb`` map by name, and
a vlm's ``cross`` blocks by the names of an ``attn`` block's leaves.  A
tree of a tied config has no ``head``, and neither has the port's model.
The hybrid family's ``shared`` blocks (stacked on axis 0) become
``shared.<j>``; its groups' ``shared_attn`` slots in ``body`` hold blocks
that the reference's forward never reads (it reads ``shared[g % n]``
there, ROADMAP C11): the port has no parameter for them, and
``from_jax_params`` checks that they are exactly the reference leaves
left over.

``shard_experts(moe_params, rank, ep)`` and ``shard_model(model, rank,
ep)`` keep rank ``rank``'s ``E // ep`` routed experts of every MoE layer
(the expert-parallel layout, ``repro_torch.core.distributed``): the dense
stacks, or a ``QuantTensor``'s payload and scales, sliced on the expert
axis; the router and the shared experts stay whole."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import param_specs, shard
from repro_torch.models.lm import LM, group_structure, init_params
from repro_torch.quantization import EXPERT_MATS, QuantTensor


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _map_jax_tree(cfg: ModelConfig, tree: dict):
    """-> ({port name: (reference leaf name, array)}, [the reference leaves
    of the hybrid groups' unread ``shared_attn`` slots])."""
    prefix, body, n_groups, suffix = group_structure(cfg)
    out = {}
    for top in ("embed", "mask_emb", "head", "final_norm", "ln0", "shared"):
        if top not in tree:
            continue
        for k, v in _flatten({top: tree[top]}).items():
            if top == "shared":        # (n_shared_attn_blocks, ...) stacks
                for j in range(v.shape[0]):
                    out[f"shared.{j}.{k[len('shared.'):]}"] = (k, v[j])
            else:
                out[k] = (k, v)
    i = 0
    for part, kinds in (("prefix", prefix), ("suffix", suffix)):
        blocks = tree.get(part, [])
        if len(blocks) != len(kinds):
            raise ValueError(f"expected {len(kinds)} {part} blocks, "
                             f"got {len(blocks)}")
    for s, blk in enumerate(tree.get("prefix", [])):
        for k, v in _flatten(blk).items():
            out[f"layers.{i}.{k}"] = (f"prefix.{s}.{k}", v)
        i += 1
    stacked = [_flatten(tree["body"][f"b{j}"]) for j in range(len(body))]
    for g in range(n_groups):
        for j, kind in enumerate(body):
            if kind != "shared_attn":  # the group reads shared[g % n]
                for k, v in stacked[j].items():
                    out[f"layers.{i}.{k}"] = (f"body.b{j}.{k}", v[g])
            i += 1
    dead = [f"body.b{j}.{k}" for j, kind in enumerate(body)
            if kind == "shared_attn" for k in stacked[j]]
    for s, blk in enumerate(tree.get("suffix", [])):
        for k, v in _flatten(blk).items():
            out[f"layers.{i}.{k}"] = (f"suffix.{s}.{k}", v)
        i += 1
    return out, dead


def from_jax_tree(cfg: ModelConfig, tree: dict) -> dict:
    """A tree of the reference's parameter layout (the parameters, their
    gradients or updated parameters; numpy leaves) as ``{name: array}``
    under the port's ``LM.named_parameters()`` names."""
    return {name: arr for name, (_, arr) in _map_jax_tree(cfg, tree)[0].items()}


def from_jax_params(cfg: ModelConfig, tree: dict, *, device="cuda") -> LM:
    """The port's fp32 model with the reference tree's weights.  Raises
    unless every port parameter takes a reference leaf and the reference
    leaves no port parameter takes are exactly the unread ``shared_attn``
    slots of the hybrid family's ``body``."""
    model = init_params(cfg, 0, device=device)
    mapped, dead = _map_jax_tree(cfg, tree)
    ref = {name: arr for name, (_, arr) in mapped.items()}
    names = dict(model.named_parameters())
    mine = {n for n in names if not n.startswith("layers.")}
    theirs = {n for n in ref if not n.startswith("layers.")}
    if mine != theirs:
        raise ValueError(f"reference leaves missing from the port: "
                         f"{sorted(theirs - mine)}; port parameters with no "
                         f"reference leaf: {sorted(mine - theirs)}")
    for i in range(len(model.layers)):
        pre = f"layers.{i}."
        mine = {n[len(pre):] for n in names if n.startswith(pre)}
        theirs = {n[len(pre):] for n in ref if n.startswith(pre)}
        if mine != theirs:
            raise ValueError(
                f"layer {i}: reference leaves missing from the port: "
                f"{sorted(theirs - mine)}; port parameters with no "
                f"reference leaf: {sorted(mine - theirs)}")
    left = set(_flatten(tree)) - {src for src, _ in mapped.values()}
    if left != set(dead):
        raise ValueError(f"reference leaves that no port parameter takes: "
                         f"{sorted(left)}; expected exactly the unread "
                         f"shared_attn slots {sorted(dead)}")
    for name, param in names.items():
        arr = np.array(ref[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape}, port "
                             f"shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(arr).to(param.dtype))
    return model


def _expert_slice(E: int, rank: int, ep: int) -> slice:
    if ep < 1 or E % ep:
        raise ValueError(f"n_experts={E} must divide over EP group size {ep}")
    if not 0 <= rank < ep:
        raise ValueError(f"rank {rank} outside an EP group of {ep}")
    n = E // ep
    return slice(rank * n, (rank + 1) * n)


def _shard_stack(w, sl: slice):
    """Experts ``sl`` of one routed stack, as a copy (the rest is freed)."""
    if isinstance(w, QuantTensor):
        return QuantTensor(w.q[sl].clone(), w.s[sl].clone(), w.dtype,
                           w.scheme, w.meta)
    return w[sl].clone()


def shard_experts(moe_params: dict, rank: int, ep: int) -> dict:
    """A copy of a MoE param mapping holding rank ``rank``'s experts of
    every routed stack (the reference's per-leaf ``P(axis, ...)`` specs);
    the router and ``shared`` pass through.  Raises unless ``ep`` divides
    the expert count."""
    sl = _expert_slice(moe_params["router"].shape[1], rank, ep)
    out = dict(moe_params)
    for name in EXPERT_MATS:
        out[name] = _shard_stack(moe_params[name], sl)
    return out


@torch.no_grad()
def shard_model(model: LM, rank: int, ep: int) -> LM:
    """Keep rank ``rank``'s experts in every MoE layer of ``model``, in
    place, one stack at a time; returns the model.  A model already sharded
    the same way is left as it is; another sharding raises."""
    for blk in model.layers:
        moe = getattr(blk, "moe", None)
        if moe is None:
            continue
        done = getattr(moe, "ep_shard", None)
        if done is not None:
            if done != (rank, ep):
                raise ValueError(f"experts already sharded as (rank, ep) = "
                                 f"{done}, not {(rank, ep)}")
            continue
        sl = _expert_slice(moe.router.shape[1], rank, ep)
        for name in EXPERT_MATS:
            w = _shard_stack(moe.expert_weight(name), sl)
            if isinstance(w, QuantTensor):
                moe.set_expert_weight(name, w)
            else:
                setattr(moe, name, torch.nn.Parameter(
                    w, requires_grad=moe.router.requires_grad))
        moe.ep_shard = (rank, ep)
    return model


@torch.no_grad()
def shard_train_state(state, grid, cfg: ModelConfig) -> dict:
    """This rank's blocks of a training state on ``grid``: ``state`` is a
    ``train.step.train_state`` (a model carried across with
    ``from_jax_params``, or a fresh ``init_params``, with its moments), or
    a bare model, whose moments start at zero on the blocks.  Every
    parameter (and moment) is replaced by its block under
    ``param_specs(..., mode="fsdp")`` one at a time, the full tensor freed
    as it goes; the model keeps ``shard_specs`` and ``full_shapes`` by
    name, which the train path's gathers read.  Returns the state."""
    from repro_torch.optim.adamw import init_opt_state
    model = state["params"] if isinstance(state, dict) else state
    if getattr(model, "shard_specs", None) is not None:
        raise ValueError("the model is sharded already")
    names = [n for n, _ in model.named_parameters()]
    full_shapes = {n: tuple(model.get_parameter(n).shape) for n in names}
    specs = param_specs(full_shapes, cfg, grid)
    opt = state.get("opt") if isinstance(state, dict) else None
    for n in names:
        mod_name, _, leaf = n.rpartition(".")
        mod = model.get_submodule(mod_name)
        p = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(
            shard(p.detach(), specs[n], grid), requires_grad=p.requires_grad))
        del p
        if opt is not None:
            for key in ("m", "v"):
                opt[key][n] = shard(opt[key][n], specs[n], grid)
    model.shard_specs, model.full_shapes = specs, full_shapes
    if opt is None:
        model.requires_grad_(True)
        opt = init_opt_state(dict(model.named_parameters()))
    return {"params": model, "opt": opt}
