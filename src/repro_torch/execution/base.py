"""Plan/execute split for MoE dispatch: ``DispatchPlan`` + executor registry
(counterpart of ``repro.execution.base``).

* **Plan**: ``plan_dispatch(x, w_router, cfg)`` runs the router projection
  (an fp32 ``torch.matmul``, outside any kernel, as the reference leaves it
  to XLA), the executor's gating/top-k, the configured ``BlockSchedule``, the
  combine-scale rows and the router aux losses, once per batch.
* **Execute**: an ``Executor`` turns a plan into the layer output, through
  its phase methods (``permute`` / ``expert_ffn`` / ``unpermute``: what
  the EP paths compose rank-locally) or, for a backend with no permuted
  layout (``dense``), through its whole-plan ``run`` alone.  A plan is
  backend-independent: ``execute(plan, ..., executor=)`` runs one plan on
  another backend.

Nothing here synchronises the host with the card: no ``.item()``, no
``.nonzero()``, no boolean-mask indexing, no ``one_hot`` (which validates
its input on the host).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.distributed.ctx import global_sum
from repro_torch.scheduling import (BlockSchedule, build_schedule,
                                    combine_scale_rows,
                                    policy_config_kwargs, schedule_stats)
from repro_torch.tuning.cache import dtype_name, lookup_block_sizes


class DispatchPlan(NamedTuple):
    """Everything per-batch and routing-dependent, built once by
    ``plan_dispatch``."""

    weights: torch.Tensor                   # (T, k) f32 combine weights
    indices: torch.Tensor                   # (T, k) i32 expert assignment
    logits: torch.Tensor                    # (T, E) f32 router logits
    schedule: Optional[BlockSchedule]       # None: routing only (the EP
                                            # paths, a schedule-free
                                            # executor)
    combine_scale: Optional[torch.Tensor]   # (capacity,) f32 epilogue rows
    aux: dict                               # lb/z losses (+ sched/*)


def router_aux_losses(logits: torch.Tensor, indices: torch.Tensor, cfg,
                      group=None):
    """Load-balance + router-z losses.  The expert frequencies come from a
    ``scatter_add_`` count, equal to the reference's one-hot mean.

    ``lb = E * sum(frac * mean_prob)`` is a product of two token means, so
    a mean of per-rank losses is not the loss of the whole batch: with
    ``group`` (the ranks whose tokens make up the batch) the per-expert
    counts, the probability sums, the z sum and the token count are summed
    over the group first (``distributed.ctx.global_sum``, through which
    the gradient flows), and every rank gets the global losses."""
    probs = torch.softmax(logits, dim=-1)
    E = cfg.n_experts
    flat = indices.reshape(-1).long()
    frac = torch.zeros(E, dtype=torch.float32, device=logits.device)
    frac = frac.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    if group is None or group.size == 1:
        frac = frac / flat.numel()
        mean_prob = probs.mean(dim=0)
        lb = E * torch.sum(frac * mean_prob)
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return {"lb_loss": lb, "router_z": z}
    T = logits.shape[0]
    z_sum = torch.sum(torch.logsumexp(logits, dim=-1) ** 2)
    n = torch.full((1,), float(T), dtype=torch.float32, device=logits.device)
    tot = global_sum(torch.cat([frac, probs.sum(dim=0), z_sum[None], n]),
                     group)
    counts, prob_sum, z_sum, n = tot[:E], tot[E:2 * E], tot[2 * E], tot[-1]
    lb = E * torch.sum((counts / (n * indices.shape[-1]))
                       * (prob_sum / n))
    return {"lb_loss": lb, "router_z": z_sum / n}


def plan_schedule(indices: torch.Tensor, cfg,
                  dtype: Optional[torch.dtype] = None) -> BlockSchedule:
    """The configured policy's schedule for this batch's routing.

    Under ``cfg.autotune`` a policy consuming ``block_m_min`` (the dynamic
    policy's sub-block floor) gets it from a swept ``sub_block`` record
    for this routing shape, when one exists, as the reference's
    ``plan_schedule`` does.  The key's M is the routed rows T·k, and its
    dtype the activations' (``dtype``; float32 when None, the only dtype
    the reference's lookup reads: ROADMAP C9)."""
    kw = policy_config_kwargs(cfg.schedule_policy, cfg)
    if cfg.autotune and "block_m_min" in kw:
        rec = lookup_block_sizes(
            "sub_block", M=indices.numel(), K=cfg.block_m, N=0,
            E=cfg.n_experts,
            dtype="float32" if dtype is None else dtype_name(dtype),
            executor=cfg.executor)
        if rec is not None and "block_m_min" in rec:
            kw["block_m_min"] = int(rec["block_m_min"])
    return build_schedule(indices, cfg.n_experts, cfg.block_m,
                          policy=cfg.schedule_policy, **kw)


class Executor:
    """Backend contract for the grouped expert compute.  ``w`` is the
    expert-weight mapping {"w_gate", "w_up", "w_down"} of (E, K, N)
    tensors or scheme-tagged ``QuantTensor``s.

    Quantization is part of the contract, as in the reference:
    ``supports_scheme`` says which registered schemes the backend takes,
    and ``prepare_weights``, called once per plan execution, adapts the
    mapping.  The default materializes QuantTensors to dense stacks; a
    backend that dequantizes inside its kernels, or per gathered block,
    passes them through.

    ``needs_schedule``: whether a plan for this backend carries a
    ``BlockSchedule`` (``plan_dispatch``'s default); the schedule-free
    ``dense`` oracle has none, and no phase methods."""

    name: str = "?"
    needs_schedule: bool = True

    def supports_scheme(self, scheme: str) -> bool:
        from repro_torch.quantization import available_schemes
        return scheme in available_schemes()

    def prepare_weights(self, w: dict, cfg) -> dict:
        from repro_torch.quantization import QuantTensor
        return {k: (v.materialize() if isinstance(v, QuantTensor) else v)
                for k, v in w.items()}

    def route(self, logits: torch.Tensor, cfg):
        """(T, E) f32 logits -> (weights (T, k) f32, indices (T, k) i32):
        the plain router, unless the backend has a kernel of its own."""
        from repro_torch.kernels import ref
        return ref.router_ref(logits, cfg.top_k, gating=cfg.gating,
                              norm_topk=cfg.norm_topk,
                              routed_scale=cfg.routed_scale)

    def permute(self, x, sched: BlockSchedule, cfg):
        raise NotImplementedError(f"executor {self.name!r} has no permute")

    def expert_ffn(self, xp, w: dict, sched: BlockSchedule, cfg,
                   row_scale=None):
        raise NotImplementedError(f"executor {self.name!r} has no expert_ffn")

    def unpermute(self, y, sched: BlockSchedule, weights, cfg):
        raise NotImplementedError(f"executor {self.name!r} has no unpermute")

    def run(self, x, w: dict, plan: DispatchPlan, cfg):
        """x: (T, d) -> y: (T, d) under the plan's routing + schedule."""
        sched = plan.schedule
        if sched is None:
            raise ValueError(
                f"executor {self.name!r} needs a schedule, but this plan "
                "carries none (built with with_schedule=False or by a "
                "needs_schedule=False executor): rebuild it with "
                "plan_dispatch(..., with_schedule=True)")
        w = self.prepare_weights(w, cfg)
        xp = self.permute(x, sched, cfg)
        scale = plan.combine_scale if cfg.fold_combine else None
        y = self.expert_ffn(xp, w, sched, cfg, row_scale=scale)
        return self.unpermute(
            y, sched, None if cfg.fold_combine else plan.weights, cfg)


_EXECUTORS: Dict[str, Executor] = {}


def register_executor(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register an Executor under ``name``."""
    def deco(cls: type) -> type:
        cls.name = name
        _EXECUTORS[name] = cls()
        return cls
    return deco


def get_executor(name) -> Executor:
    """The registered backend ``name`` (an ``Executor`` passes through)."""
    if isinstance(name, Executor):
        return name
    try:
        return _EXECUTORS[name]
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; "
                         f"available: {available_executors()}") from None


def available_executors():
    return sorted(_EXECUTORS)


# the reference's executor names -> the port's counterparts: its Pallas
# kernels are the port's CUDA kernels, its ``xla`` scan the ``blocks`` loop
REFERENCE_SPELLINGS = {"pallas": "cuda", "xla": "blocks"}


def executor_cli_name(name: str) -> str:
    """A launcher's ``--executor`` value: a registry name, or one of the
    reference's spellings (``pallas``, ``xla``) mapped to the port's.
    ``get_executor`` itself takes registry names only."""
    return REFERENCE_SPELLINGS.get(name, name)


# ----------------------------------------------------------------------
# Plan-stats hook (observability)
# ----------------------------------------------------------------------
# Called for every plan built with host-static facts (token count,
# executor, policy); ``repro_torch.obs`` wires it to ``moe/plans_traced``,
# counted only inside a serving step at a new shape.  Process-global, as
# the reference's (one observability bundle per process); the default None
# costs one identity check per plan.
_PLAN_HOOK: Optional[Callable[..., None]] = None


def set_plan_hook(hook: Optional[Callable[..., None]]):
    """Install ``hook(tokens=..., executor=..., policy=...)``; returns the
    previous hook so that callers (tests, short-lived engines) can restore
    it."""
    global _PLAN_HOOK
    prev, _PLAN_HOOK = _PLAN_HOOK, hook
    return prev


def plan_dispatch(x: torch.Tensor, w_router: torch.Tensor, cfg, *,
                  with_schedule: Optional[bool] = None,
                  aux_group=None) -> DispatchPlan:
    """Phase 1: route + schedule + combine rows + aux, once per batch;
    with ``cfg.emit_stats`` the aux also holds the schedule's ``sched/*``
    telemetry (device tensors, no host read).  ``with_schedule`` None
    builds the schedule where ``cfg.executor`` needs one; ``False`` stops
    after the routing and the router losses (the expert-parallel paths
    build their schedules over the rows each rank receives), ``True``
    builds it for any executor.
    ``aux_group``: the router losses over that group's whole batch
    (``router_aux_losses``)."""
    ex = get_executor(cfg.executor)
    if _PLAN_HOOK is not None:
        _PLAN_HOOK(tokens=int(x.shape[0]), executor=str(cfg.executor),
                   policy=str(cfg.schedule_policy))
    logits = torch.matmul(x.float(), w_router.float())
    weights, indices = ex.route(logits, cfg)
    aux = router_aux_losses(logits, indices, cfg, aux_group)
    if with_schedule is None:
        with_schedule = ex.needs_schedule
    if not with_schedule:
        return DispatchPlan(weights=weights, indices=indices, logits=logits,
                            schedule=None, combine_scale=None, aux=aux)
    sched = plan_schedule(indices, cfg, x.dtype)
    combine = combine_scale_rows(sched, weights) if cfg.fold_combine else None
    if cfg.emit_stats:
        aux.update({f"sched/{k}": v for k, v
                    in schedule_stats(sched)._asdict().items()})
    return DispatchPlan(weights=weights, indices=indices, logits=logits,
                        schedule=sched, combine_scale=combine, aux=aux)


def execute(plan: DispatchPlan, x: torch.Tensor, w: dict, cfg,
            executor=None) -> torch.Tensor:
    """Phase 2: run a plan through a backend.  ``executor`` (a name or an
    instance) defaults to ``cfg.executor``; another name re-executes the
    same plan on that backend."""
    ex = get_executor(cfg.executor if executor is None else executor)
    return ex.run(x, w, plan, cfg)
