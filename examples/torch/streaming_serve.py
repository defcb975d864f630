"""Open-stream serving with token streaming and SLO-aware admission:
submit requests into the live queue, watch tokens arrive through
per-request callbacks, then replay a bursty arrival trace and compare
fcfs against slo goodput on a deterministic virtual clock (counterpart of
``examples/streaming_serve.py``).

    PYTHONPATH=src python examples/torch/streaming_serve.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import RunConfig, init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import ServingFrontend
from repro_torch.serve.loadgen import make_virtual_obs, replay, synth_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-requests", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2, d_model=64,
                  vocab=256)
    model = init_params(cfg, 0, device=dev)
    rc = RunConfig(q_chunk=16, kv_chunk=16, schedule_policy="dynamic")

    # --- 1. token streaming ------------------------------------------
    # The frontend owns an engine; submit() returns a live Request handle
    # and on_token fires as the step's single host sync retires each token
    engine = ServeEngine(cfg, model, slots=2, capacity=64, rc=rc,
                         device=dev)
    fe = ServingFrontend(engine)
    rng = np.random.default_rng(0)

    def show(req, tok):
        print(f"  rid {req.rid} token[{len(req.out) - 1}] = {tok}")

    handles = [fe.submit(rng.integers(0, cfg.vocab_size, 5), max_new=4,
                         on_token=show)
               for _ in range(3)]
    print(f"streaming 3 requests through 2 slots on {dev}:")
    fe.drain()
    for r in handles:
        assert r.done and len(r.out) == 4
        print(f"  rid {r.rid} done: {r.out} "
              f"(ttft {r.stats['lat/ttft_s'] * 1e3:.1f} ms)")

    # --- 2. SLO admission under burst load ---------------------------
    # The same seeded trace, two admission policies, virtual time (one
    # engine step = 50 virtual ms): the goodput gap is reproducible
    for admission in ("fcfs", "slo"):
        trace = synth_trace("burst", seed=0, n=args.trace_requests,
                            rate=8.0, vocab=cfg.vocab_size, max_new=5,
                            slo_ttft=0.4, burst_size=4, prompt_hi=40)
        clock, obs = make_virtual_obs(enabled=True)
        eng = ServeEngine(cfg, model, slots=2, capacity=64, rc=rc,
                          kv_block_size=4, prefill_chunk=4,
                          admission=admission, obs=obs, device=dev)
        rec = replay(eng, trace, clock=clock, step_time=0.05, seed=0,
                     pattern="burst")
        print(f"burst x {admission:4s}: goodput {rec['goodput_rps']:.2f} "
              f"req/s, SLO attainment {rec['slo_attainment']:.0%}, "
              f"preempted {rec['preempted']}, resumed {rec['resumed']}, "
              f"TTFT p99 {rec['ttft_p99_s']:.2f} s")
    print("OK")


if __name__ == "__main__":
    main()
