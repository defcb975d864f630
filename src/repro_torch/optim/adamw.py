"""AdamW with decoupled weight decay, global-norm clipping and a
warmup + cosine schedule (counterpart of ``repro.optim.adamw``), with the
reference's formula and order: clip the gradient, update the fp32 moments,
bias-correct, then ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
(``torch.optim.AdamW`` decays before the Adam step, a different order.)

Parameters and gradients are ``{name: tensor}`` mappings.  The reference
returns new arrays; here the parameters and moments are updated in place
(fewer passes over the model-sized tensors, and no second copy of each).
Every scalar (step, norm, learning rate) stays a device tensor: no host
sync."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class OptConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_opt_state(params: dict) -> dict:
    """fp32 moments of every parameter, whatever its dtype, and the step."""
    device = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine down to ``min_lr_ratio * lr``;
    ``step`` an f32 tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def sharded_global_norm(grads: dict, specs: dict, grid) -> torch.Tensor:
    """The global norm of a gradient held as blocks on ``grid``: every
    element counted once.  A block is counted on the ranks at coordinate 0
    of each axis it is replicated over (a norm scale or the router only on
    rank 0), and the squared sums are added over every rank."""
    from repro_torch.distributed.sharding import replicated_axes
    mine = [g for n, g in grads.items()
            if all(grid.coords[a] == 0
                   for a in replicated_axes(specs[n], grid))]
    sq = sum(torch.sum(torch.square(t.float())) for t in mine)
    if not torch.is_tensor(sq):
        sq = torch.zeros((), device=next(iter(grads.values())).device)
    return torch.sqrt(grid.world.all_reduce(sq))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: OptConfig, *,
                  grid=None, specs: dict = None):
    """One AdamW step, in place on ``params`` (fp32 master weights) and
    ``state``.  Returns (params, state, {"grad_norm", "lr"}).

    On a grid, ``params``, ``grads`` and the moments are this rank's
    blocks under ``specs``: the clipping norm is the whole gradient's
    (``sharded_global_norm``), and every other step is elementwise on the
    block."""
    low = [n for n, p in params.items() if p.dtype != torch.float32]
    if low:
        raise ValueError(f"apply_updates keeps fp32 master weights; "
                         f"{low[0]!r} is {params[low[0]].dtype} (train with "
                         f"RunConfig.param_dtype=torch.float32)")
    step = state["step"] + 1
    gnorm = (global_norm(grads[n] for n in params) if grid is None else
             sharded_global_norm({n: grads[n] for n in params}, specs, grid))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    lr = schedule(stepf, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** stepf
    c2 = 1 - b2 ** stepf
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        gf = grads[name].float() * scale
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        delta = torch.div(m, c1).div_(torch.div(v, c2).sqrt_().add_(cfg.eps))
        p.sub_(delta.add_(p, alpha=cfg.weight_decay).mul_(lr))
        del gf, delta
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
