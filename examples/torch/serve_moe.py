"""Serve a small MoE model with batched requests through the port's
engine: paged KV cache, chunked prefill, lock-step decode and slot reuse,
with the routed experts optionally quantized under a registered scheme
(``--quant``) (counterpart of ``examples/serve_moe.py``).

    PYTHONPATH=src python examples/torch/serve_moe.py [--quant int8_expert] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import RunConfig, init_params
from repro_torch.quantization import available_schemes
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default="int8_expert",
                    choices=available_schemes(),
                    help="expert-weight quantization scheme "
                         "(repro_torch.quantization registry)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=7)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2, d_model=64,
                  vocab=256)
    model = init_params(cfg, 0, device=dev)
    # RunConfig.quant is the one selector: the engine quantizes the routed
    # experts at load; the schedule policy and per-request telemetry keep
    # the serving defaults
    engine = ServeEngine(cfg, model, slots=3, capacity=64, device=dev,
                         rc=RunConfig(q_chunk=64, kv_chunk=64,
                                      schedule_policy="dynamic",
                                      quant=args.quant, moe_stats=True))

    rng = np.random.default_rng(0)
    requests = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            rng.integers(3, 9)).astype(
                                                np.int32),
                        max_new=8)
                for i in range(args.requests)]
    print(f"serving {len(requests)} requests on {engine.slots} slots "
          f"(MoE: {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, "
          f"schedule_policy={engine.rc.schedule_policy}, "
          f"quant={engine.rc.quant}) on {dev}")
    done = engine.run(requests)
    assert done == requests, "run() returns completed requests in order"
    for r in requests:
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.out}")
    assert all(r.done for r in requests)
    print("OK: all requests completed with slot reuse")


if __name__ == "__main__":
    main()
