"""Attach the observability bundle to a serving run: metrics registry,
Chrome-trace span tracer and straggler monitor, then inspect what the
engine absorbed: counters, paged-cache gauges, per-request TTFT/TPOT and
the step-timeline trace (counterpart of ``examples/observability.py``).

    PYTHONPATH=src python examples/torch/observability.py [--trace out.json] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import RunConfig, init_params
from repro_torch.obs import (Observability, latency_summary,
                             validate_chrome_trace)
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="also write the Chrome-trace JSON (load it at "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=7)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2, d_model=64,
                  vocab=256)
    model = init_params(cfg, 0, device=dev)

    # Observability.memory() = metrics + tracer + straggler monitor on one
    # clock.  The default (no obs argument) is the NOOP bundle: same code
    # paths, null sinks, and the same tokens
    obs = Observability.memory()
    engine = ServeEngine(cfg, model, slots=3, capacity=64, obs=obs,
                         device=dev,
                         rc=RunConfig(q_chunk=64, kv_chunk=64,
                                      schedule_policy="dynamic",
                                      moe_stats=True))

    rng = np.random.default_rng(0)
    requests = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            rng.integers(3, 9)).astype(
                                                np.int32),
                        max_new=8)
                for i in range(args.requests)]
    done = engine.run(requests)
    assert all(r.done for r in requests)

    # 1. engine counters / paged-cache gauges, one snapshot
    snap = obs.metrics.snapshot()
    counters = {c["name"]: c["value"] for c in snap["counters"]
                if not c["labels"]}
    print(f"completed {len(done)} requests in "
          f"{counters['serve/steps']:.0f} steps "
          f"({counters['serve/step_tokens']:.0f} step-tokens) on {dev}")
    print("gauges:", {g["name"]: g["value"] for g in snap["gauges"]
                      if g["name"].startswith("kv/")})

    # 2. recompile accounting: one count per distinct step shape
    recompiles = {tuple(c["labels"].items()): c["value"]
                  for c in snap["counters"]
                  if c["name"] == "serve/recompiles"}
    print("recompiles by step kind:", recompiles)

    # 3. per-request latency (always on: Request.stats carries lat/*
    #    whether or not a sink is attached)
    for fam, agg in latency_summary(requests).items():
        print(f"  {fam:>13}: p50 {agg['p50'] * 1e3:7.2f} ms   "
              f"p99 {agg['p99'] * 1e3:7.2f} ms   (n={agg['n']})")

    # 4. the step timeline as a Chrome trace
    doc = obs.tracer.to_chrome_trace()
    v = validate_chrome_trace(doc, required_names=(
        "serve/admit", "serve/step", "serve/forward", "serve/host_sync"))
    print(f"trace: {v['events']} events, "
          f"{len(v['names'])} distinct span/instant names")
    if args.trace:
        print("wrote", obs.tracer.save(args.trace))
    print("OK")


if __name__ == "__main__":
    main()
