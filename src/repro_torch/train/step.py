"""The training step: gradient accumulation over microbatches + AdamW
(counterpart of ``repro.train.step``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)``.  The
state holds the model (its parameters trainable, in ``rc.param_dtype``)
and the optimizer state keyed by parameter name.  With ``accum_steps >
1`` the batch carries a leading microbatch axis and the gradients
accumulate in fp32, one microbatch's graph at a time; the optimizer runs
once per step.  The reference returns a new state; here the parameters
and moments are updated in place (``optim.adamw``).  Metrics stay device
tensors.

On a grid of ranks (``grid``; the reference's jit over a mesh with the
launcher's shardings) the state holds this rank's blocks
(``weights.shard_train_state``) and the batch its block
(``data.pipeline.local_batch``).  The step runs inside the grid's
activation rules: each layer gathers its weights and its backward
reduce-scatters their gradients; ``reduce_grads`` then sums each
gradient over the axes its parameter is replicated over (with
``compress_pod`` the 'pod' axis's sum is ``compressed_psum``), and AdamW
runs on the blocks with the whole gradient's norm.  Every rank's gradient
is its share of the whole one (``distributed/ctx.py``): where the
recurrent families' 'model' ranks hold the same tokens, ``loss_fn``
counts them once between them, so the sums hold there too."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import use_rules
from repro_torch.distributed.sharding import (activation_rules, dp_axes,
                                              replicated_axes)
from repro_torch.models.lm import RunConfig, init_params, loss_fn
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.optim.compress import compressed_psum


def init_train_state(cfg: ModelConfig, seed: int, rc: RunConfig, *,
                     device="cuda", grid=None) -> dict:
    """A fresh state from ``init_params(cfg, seed)``; on a grid, this
    rank's blocks of it (the full model freed, the moments made on the
    blocks)."""
    model = init_params(cfg, seed, param_dtype=rc.param_dtype, device=device)
    if grid is None:
        return train_state(model)
    from repro_torch.weights import shard_train_state
    return shard_train_state(model, grid, cfg)


def train_state(model) -> dict:
    """A training state around ``model`` (e.g. weights carried over with
    ``weights.from_jax_params``): its parameters made trainable, fresh
    optimizer moments."""
    model.requires_grad_(True)
    return {"params": model,
            "opt": init_opt_state(dict(model.named_parameters()))}


def _grads(loss: torch.Tensor, params: dict) -> list:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params.values(), gs)]


def grid_rules(cfg: ModelConfig, grid, local_batch: int) -> dict:
    """The grid's train-mode activation rules for a rank's block of
    ``local_batch`` rows (the data axes cut the batch)."""
    return activation_rules(cfg, grid, "train",
                            local_batch * grid.size(dp_axes(grid)))


@torch.no_grad()
def reduce_grads(grads: dict, specs: dict, grid,
                 compress_pod: bool = False) -> dict:
    """Sum each block's gradient over the grid axes its parameter is
    replicated over (the axes its spec does not cut: the layer gathers
    already reduce-scattered over the others); ``compress_pod`` sends the
    'pod' axis's sum as int8 (``compressed_psum``)."""
    out = {}
    for n, g in grads.items():
        axes = replicated_axes(specs[n], grid)
        if compress_pod and "pod" in axes:
            inner = tuple(a for a in axes if a != "pod")
            if inner:
                g = grid.group(inner).all_reduce(g)
            g = compressed_psum(g, grid.group("pod")).to(g.dtype)
        elif axes:
            g = grid.group(axes).all_reduce(g)
        out[n] = g
    return out


def make_train_step(cfg: ModelConfig, rc: RunConfig, opt: OptConfig,
                    accum_steps: int = 1, *, grid=None,
                    compress_pod: bool = False):
    def rules(batch):
        if grid is None:
            return contextlib.nullcontext()
        rows = batch["tokens" if "tokens" in batch else "labels"]
        return use_rules(grid, grid_rules(cfg, grid, rows.shape[-2]))

    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = dict(model.named_parameters())
        with rules(batch):
            grads, loss, metrics = _loss_and_grads(model, params, batch)
        specs = None
        if grid is not None:
            specs = model.shard_specs
            grads = reduce_grads(grads, specs, grid, compress_pod)
        metrics = {k: v.detach() for k, v in metrics.items()}
        _, new_opt, opt_metrics = apply_updates(params, grads, state["opt"],
                                                opt, grid=grid, specs=specs)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": model, "opt": new_opt}, metrics

    def _loss_and_grads(model, params, batch):
        if accum_steps == 1:
            loss, metrics = loss_fn(model, cfg, rc, batch)
            grads = dict(zip(params, _grads(loss, params)))
            loss = loss.detach()
        else:
            g_sum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=next(iter(params.values())).device)
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                loss_i, metrics = loss_fn(model, cfg, rc, mb)
                for n, g in zip(params, _grads(loss_i, params)):
                    g_sum[n] += g.float()
                l_sum = l_sum + loss_i.detach()
            grads = {n: g / accum_steps for n, g in g_sum.items()}
            loss = l_sum / accum_steps
        return grads, loss, metrics

    return train_step
