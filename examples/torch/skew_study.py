"""Routing-imbalance study (the paper's §4.7) as a runnable example
(counterpart of ``examples/skew_study.py``).

Replaces the router with synthetic uniform / Zipf(1.2) / Zipf(2.0)
assignments (uniform 1/k gating, a fixed token budget: the paper's
method) and compares the three schedule policies on the tile-padding
waste, block occupancy and drop rates.  The assignments are the
reference's draws at the same key (``sampling/skew.py`` ports
``jax.random.choice`` onto the threefry uniforms), so the schedules are
the reference's, integer for integer.

    PYTHONPATH=src python examples/torch/skew_study.py [--device cpu]
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs.paper import PAPER_CONFIGS
from repro_torch.sampling.skew import zipf_assignments
from repro_torch.scheduling import (DEFAULT_POLICY_SWEEP, build_schedule,
                                    schedule_stats)

POLICIES = DEFAULT_POLICY_SWEEP
DISTS = (("uniform", 0.0), ("zipf-1.2", 1.2), ("zipf-2.0", 2.0))


def study(T: int, device, configs=("mixtral-8x7b", "qwen2-moe-57b")):
    """{(config, dist): {policy: ScheduleStats}} at T tokens."""
    out = {}
    for name in configs:
        pc = PAPER_CONFIGS[name]
        E, k = pc.n_experts, pc.top_k
        block_m = min(128, max(8, T * k // E))
        for dist, alpha in DISTS:
            _, idx = zipf_assignments(3, T, k, E, alpha, device=device)
            out[name, dist] = {
                policy: schedule_stats(build_schedule(idx, E, block_m,
                                                      policy=policy, **kw))
                for policy, kw in POLICIES}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=512)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    T = args.tokens
    res = study(T, dev)
    last = None
    for (name, dist), stats in res.items():
        if name != last:
            pc = PAPER_CONFIGS[name]
            E, k = pc.n_experts, pc.top_k
            print(f"\n{name}: E={E} k={k} "
                  f"BLOCK_M={min(128, max(8, T * k // E))} T={T} on {dev}")
            last = name
        line = [f"{policy}: waste={float(st.pad_waste):4.2f}x "
                f"occ={float(st.occupancy):4.1%} "
                f"drop={float(st.drop_fraction):5.1%}"
                for policy, st in stats.items()]
        top1 = float(stats["fixed"].top1_share)   # policy-independent
        print(f"  {dist:9s} top1_share={top1:5.1%}  " + "  ".join(line))
    print("\nThe `dynamic` policy sub-tiles light experts and keeps heavy "
          "ones on full tiles; `capacity_factor` trades waste for drops "
          "(GShard EP semantics).")


if __name__ == "__main__":
    main()
