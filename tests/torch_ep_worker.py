"""Rank body of tests/test_torch_ep.py: runs in each spawned gloo rank,
imports torch and the port only (never JAX), and returns numpy.

``rank_main(group, inputs, cases, engine)`` runs every expert-parallel MoE
case of ``cases`` on this rank's share of the experts, and, when
``engine`` is given, the 2-rank serving case; it returns
``{"moe": {case: (y, aux) or, for a ``grad`` case, (y, aux, grads)},
"engine": {...}}``."""
import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.distributed import apply_moe_ep
from repro_torch.core.moe_layer import dispatch_config
from repro_torch.quantization import quantize_moe_params
from repro_torch.weights import shard_experts

MOE_SHAPES = {
    # the reference's small MoE and its drop case (tests/test_distributed.py)
    "main": dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
                 block_m=8, capacity_factor=0.5),
    "drop": dict(n_experts=4, top_k=1, d_ff_expert=16, block_m=8),
}


def moe_config(shape: str) -> MoEConfig:
    return MoEConfig(**MOE_SHAPES[shape])


def torch_params(inputs: dict, shape: str) -> dict:
    p = {k[len(shape) + 1:]: torch.from_numpy(np.array(v))
         for k, v in inputs.items()
         if k.startswith(shape + ".") and not k.endswith((".x", ".dy"))}
    out = {k: v for k, v in p.items() if not k.startswith("shared.")}
    shared = {k[len("shared."):]: v for k, v in p.items()
              if k.startswith("shared.")}
    if shared:
        out["shared"] = shared
    return out


def case_config(case: dict):
    """(moe config, dispatch config, apply_moe_ep kwargs) of a case."""
    moe = moe_config(case["shape"])
    dcfg = dispatch_config(moe, executor=case.get("executor", "cuda"),
                           schedule_policy=case["policy"], emit_stats=True)
    kw = dict(token_layout=case["layout"], overlap=case.get("overlap", 0))
    if case.get("capacity_factor") is not None:
        kw["capacity_factor"] = case["capacity_factor"]
    return moe, dcfg, kw


def aux_numpy(aux: dict) -> dict:
    return {k: float(v) for k, v in aux.items()}


def leaves(params: dict, prefix: str = "") -> dict:
    """{name: tensor} of a MoE param mapping, ``shared`` as
    ``shared.<leaf>``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def trainable(params: dict) -> dict:
    """A copy of ``params`` whose every tensor is a leaf needing a
    gradient."""
    return {k: (trainable(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in params.items()}


def run_moe(group, inputs: dict, case: dict):
    """(y, aux), and for a ``grad`` case the gradients of each term of the
    loss ``sum(y * dy) + lb_loss + router_z`` apart: ``{term: {"x" or a
    leaf of this rank's params: gradient}}``."""
    _, dcfg, kw = case_config(case)
    params = torch_params(inputs, case["shape"])
    if case.get("scheme"):
        params = quantize_moe_params(params, case["scheme"])
    local = shard_experts(params, group.rank, group.size)
    xname = case.get("x", case["shape"])
    x = torch.from_numpy(np.array(inputs[xname + ".x"]))
    if not case.get("grad"):
        with torch.no_grad():
            y, aux = apply_moe_ep(local, x, dcfg, group=group, **kw)
        return y.numpy(), aux_numpy(aux)
    local = trainable(local)
    x.requires_grad_()
    wrt = {"x": x, **leaves(local)}
    y, aux = apply_moe_ep(local, x, dcfg, group=group, **kw)
    dy = torch.from_numpy(np.array(inputs[xname + ".dy"]))
    terms = {"out": (y * dy).sum(), "lb_loss": aux["lb_loss"],
             "router_z": aux["router_z"]}
    grads = {}
    for term, t in terms.items():
        gs = torch.autograd.grad(t, list(wrt.values()), retain_graph=True,
                                 allow_unused=True)
        grads[term] = {n: g.numpy() for n, g in zip(wrt, gs)
                       if g is not None}
    return y.detach().numpy(), aux_numpy(aux), grads


def run_engine(group, spec: dict) -> dict:
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig
    from repro_torch.obs import Observability
    from repro_torch.serve.distributed import DistributedServeLoop
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.weights import from_jax_params

    cfg = reduced(get_config(spec["arch"]))
    model = from_jax_params(cfg, spec["tree"], device="cpu")
    rc = RunConfig(q_chunk=64, kv_chunk=64, ep=True, moe_stats=True,
                   schedule_policy="capacity_factor",
                   capacity_factor=spec["capacity_factor"])
    obs = Observability.memory()
    eng = ServeEngine(cfg, model, slots=2, capacity=spec["capacity"], rc=rc,
                      obs=obs, device="cpu")
    reqs = [Request(rid=i, prompt=np.array(p, np.int32), max_new=m)
            for i, (p, m) in enumerate(spec["requests"])]
    done = DistributedServeLoop(eng, n_hosts=2).run(reqs, max_steps=64)
    counters = {c["name"]: c["value"]
                for c in obs.metrics.snapshot()["counters"]}
    return {"done": len(done), "out": [list(r.out) for r in reqs],
            "dropped_rows": [r.stats.get("sched/dropped_rows")
                             for r in reqs],
            "ep_dropped_tokens": counters.get("serve/ep_dropped_tokens")}


def rank_main(group, inputs: dict, cases: dict, engine=None) -> dict:
    torch.set_num_threads(1)
    out = {"moe": {name: run_moe(group, inputs, case)
                   for name, case in cases.items()}}
    if engine is not None:
        out["engine"] = run_engine(group, engine)
    return out
