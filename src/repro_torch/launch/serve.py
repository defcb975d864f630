"""Serving launcher: random weights from a seed, then greedy requests through
the continuous-batching engine on the ``cuda`` executor.  By default the
engine is paged (blocks of 16, chunked prefill, prefix cache) with the
``dynamic`` schedule; ``--kv-block 0 --policy fixed`` gives the contiguous
engine with the paper's ``fixed`` schedule.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --layers 4 --requests 4 --max-new 16 \\
        --slots 2 --dtype bf16 --seed 0

``--arch deepseek-v2-236b`` serves the MLA model (latent KV cache; the
paged read runs the MLA form of the paged-attention kernel).  Widths are
the architecture's own; ``--layers`` cuts depth (deepseek-v2 at 4 layers
holds 13.3 B parameters, 26.6 GB in bf16).  ``--quant
{none,int8_expert,int8_channel,int4_packed}`` serves the routed experts
compressed under that scheme (quantized at load, one stack at a time; the
kernels dequantize on chip); ``--quant-experts`` is its deprecated alias
for ``int8_expert``.  Prints the routed experts' stored bytes and the peak
device memory from load to the end of serving.  Runs on the card; ``--device cpu`` runs the kernels' plain
versions on the CPU."""
import argparse
import time

import numpy as np
import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models.lm import RunConfig, init_params
    from repro_torch.quantization import (available_schemes,
                                          resolve_quant_cli,
                                          routed_expert_bytes)
    from repro_torch.scheduling import available_policies
    from repro_torch.serve.engine import Request, ServeEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut (default: the architecture's own)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="KV block size of the paged engine; 0 = contiguous")
    ap.add_argument("--policy", default="dynamic",
                    choices=available_policies(), help="schedule policy")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per slot per paged step")
    ap.add_argument("--paged-attn", default="auto",
                    choices=("auto", "fused", "gather"),
                    help="paged read: fused kernel (auto on cuda) or "
                         "gather + attention")
    ap.add_argument("--quant", default=None, choices=available_schemes(),
                    help="expert-weight quantization scheme (default: none)")
    ap.add_argument("--quant-experts", action="store_true",
                    help="DEPRECATED: alias for --quant int8_expert")
    args = ap.parse_args(argv)
    quant = resolve_quant_cli(args.quant, args.quant_experts)

    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    dt = DTYPES[args.dtype]
    on_card = torch.device(args.device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, args.seed, param_dtype=dt, device=args.device)
    dense_bytes = routed_expert_bytes(model)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, int(rng.integers(16, 65))).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    capacity = max(len(r.prompt) for r in reqs) + args.max_new + 1
    rc = RunConfig(compute_dtype=dt, schedule_policy=args.policy,
                   paged_attn=args.paged_attn, quant=quant)
    engine = ServeEngine(cfg, model, slots=args.slots, capacity=capacity,
                         rc=rc, kv_block_size=args.kv_block,
                         prefill_chunk=args.prefill_chunk, device=args.device)
    cache = (f"paged KV cache (blocks of {args.kv_block}, prefill chunks of "
             f"{engine.prefill_chunk}, {args.paged_attn} read)"
             if engine.paged else "contiguous KV cache")
    print(f"{cfg.name}: {cfg.n_layers} layers at full width, {args.dtype}, "
          f"{cache}, {args.policy} schedule, cuda executor, "
          f"{args.slots} slots x {capacity} tokens")
    print(f"routed experts: {quant} scheme, {routed_expert_bytes(model)} "
          f"bytes stored ({dense_bytes} dense {args.dtype})")
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt_s = time.perf_counter() - t0
    for r in reqs:
        print(f"req {r.rid}: {len(r.prompt)} prompt tokens -> {r.out}")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"{len(done)}/{len(reqs)} requests completed, {n_tok} tokens, "
          f"{engine.n_forwards} forwards in {dt_s:.3f} s on "
          f"{engine.device}")
    peak = (f"{torch.cuda.max_memory_allocated(engine.device)} bytes"
            if on_card else "not measured (no card)")
    print(f"peak device memory (load, quantization and serving): {peak}")
    return done


if __name__ == "__main__":
    main()
