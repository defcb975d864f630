"""Quickstart: the paper's fused MoE dispatch pipeline, step by step, on
the port's Hopper kernels (counterpart of ``examples/quickstart.py``).

Runs the five-stage pipeline (B5 router -> B3 permute -> B2 fused gate+up
grouped GEMM -> B1 down GEMM with the combine weights folded into its
epilogue -> B4 unpermute) kernel by kernel, then the whole layer on every
registered executor, and checks each result against a dense
loop-over-experts oracle in plain PyTorch.  On the card the wrappers launch
the CUDA kernels (built with nvcc at first use); ``--device cpu`` runs
their plain PyTorch versions.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MoEConfig
from repro_torch.core.moe_layer import apply_moe, dispatch_config
from repro_torch.execution import (available_executors, execute,
                                   get_executor, plan_dispatch)
from repro_torch.kernels import ops
from repro_torch.scheduling import build_schedule, combine_scale_rows


def init_moe_params(moe: MoEConfig, d: int, gen, device) -> dict:
    """Router, routed stacks and shared experts, fan-in scaled normals."""
    def w(*shape):
        return torch.randn(shape, generator=gen, device=device) \
            * shape[-2] ** -0.5
    E, f = moe.n_experts, moe.d_ff_expert
    p = {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
         "w_down": w(E, f, d)}
    if moe.n_shared_experts:
        fs = moe.n_shared_experts * f
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs),
                       "w_down": w(fs, d)}
    return p


def dense_oracle(params: dict, x: torch.Tensor, weights: torch.Tensor,
                 indices: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Every expert on every token, kept where the router picked it: the
    loop over experts, in fp32."""
    y = torch.zeros_like(x)
    for e in range(n_experts):
        g = x @ params["w_gate"][e]
        h = (g * torch.sigmoid(g)) * (x @ params["w_up"][e])
        gate = (weights * (indices == e)).sum(dim=-1, keepdim=True)
        y = y + gate * (h @ params["w_down"][e])
    return y


def shared_oracle(sh: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ sh["w_gate"]
    return ((g * torch.sigmoid(g)) * (x @ sh["w_up"])) @ sh["w_down"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    ap.add_argument("--tokens", type=int, default=256)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    moe = MoEConfig(n_experts=8, top_k=2, d_ff_expert=128,
                    n_shared_experts=1, block_m=16)
    d_model, tokens = 64, args.tokens
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_moe_params(moe, d_model, gen, dev)
    x = torch.randn((tokens, d_model), generator=gen, device=dev) * 0.5

    # ---- stage by stage (the paper's five launches) ----
    logits = x @ params["router"]
    weights, indices = ops.router_topk(logits, top_k=moe.top_k)      # B5
    print(f"router: top-{moe.top_k} of {moe.n_experts} experts; first "
          f"token -> experts {indices[0].tolist()}")
    sched = build_schedule(indices, moe.n_experts, moe.block_m)
    print(f"schedule: capacity={sched.capacity} rows ({tokens}x{moe.top_k} "
          f"tokens + tile padding), {sched.capacity // moe.block_m} blocks "
          f"of M={moe.block_m}, active={int(sched.block_active.sum())}")
    xp = ops.permute(x, sched)                                       # B3
    h = ops.fused_gate_up(xp, params["w_gate"], params["w_up"], sched)  # B2
    y = ops.grouped_gemm(h, params["w_down"], sched,                 # B1
                         row_scale=combine_scale_rows(sched, weights))
    out_stages = ops.unpermute(y, sched, None)                       # B4
    oracle = dense_oracle(params, x, weights, indices, moe.n_experts)
    err = (out_stages - oracle).abs().max().item()
    assert torch.allclose(out_stages, oracle, rtol=2e-4, atol=2e-4), err
    print(f"stage-by-stage pipeline == dense oracle (max |delta| = "
          f"{err:.2e})")

    # ---- whole-layer API, every executor backend the port registers ----
    full = oracle + shared_oracle(params["shared"], x)
    for name in available_executors():
        if not type(get_executor(name)).__module__.startswith("repro_torch"):
            continue                    # registered by the caller, not ours
        y_full, aux = apply_moe(params, x[None],
                                dispatch_config(moe, executor=name))
        err = (y_full[0] - full).abs().max().item()
        assert torch.allclose(y_full[0], full, rtol=2e-4, atol=2e-4), err
        print(f"executor {name}: apply_moe == dense oracle + shared experts "
              f"(max |delta| = {err:.2e})")

    # ---- plan/execute split: one plan consumed twice ----
    cfg = dispatch_config(moe)
    w = {k: params[k] for k in ("w_gate", "w_up", "w_down")}
    plan = plan_dispatch(x, params["router"], cfg)
    y1 = execute(plan, x, w, cfg)
    y2 = execute(plan, x, w, cfg)
    assert torch.equal(y1, y2)
    assert torch.allclose(y1, oracle, rtol=2e-4, atol=2e-4)
    print(f"plan reuse: one DispatchPlan ({plan.schedule.capacity}-row "
          f"schedule built once) executed twice, bitwise alike")
    print(f"aux: load-balance={float(aux['lb_loss']):.3f} "
          f"router-z={float(aux['router_z']):.3f}")
    print(f"OK on {dev}")


if __name__ == "__main__":
    main()
