"""The training step: gradient accumulation over microbatches + AdamW
(counterpart of ``repro.train.step``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)``.  The
state holds the model (its parameters trainable, in ``rc.param_dtype``)
and the optimizer state keyed by parameter name.  With ``accum_steps >
1`` the batch carries a leading microbatch axis and the gradients
accumulate in fp32, one microbatch's graph at a time; the optimizer runs
once per step.  The reference returns a new state; here the parameters
and moments are updated in place (``optim.adamw``).  Metrics stay device
tensors."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import RunConfig, init_params, loss_fn
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state


def init_train_state(cfg: ModelConfig, seed: int, rc: RunConfig, *,
                     device="cuda") -> dict:
    model = init_params(cfg, seed, param_dtype=rc.param_dtype, device=device)
    return train_state(model)


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


def make_train_step(cfg: ModelConfig, rc: RunConfig, opt: OptConfig,
                    accum_steps: int = 1):
    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = dict(model.named_parameters())
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
        metrics = {k: v.detach() for k, v in metrics.items()}
        _, new_opt, opt_metrics = apply_updates(params, grads, state["opt"],
                                                opt)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": model, "opt": new_opt}, metrics

    return train_step
