"""Build the port's persistent kernel tune cache (counterpart of the
reference's ``tools/build_tune_cache.py``).

    python -m repro_torch.tuning.build [--configs NAME ...] [--arch NAME ...]
        [--tokens T ...] [--scheme dense int8 int4] [--reps 3] [--reduce]
        [--force] [--out PATH]

Sweeps the tile shapes of every grouped GEMM one MoE layer dispatches
(``fused_gate_up`` at (d, f), the down projection ``grouped_gemm`` at (f,
d)) at each routed-token count and writes the winners to
``results/tuning/cache_torch.json`` (``$REPRO_TORCH_TUNE_CACHE``, or
``--out``), with the card's name as ``device``.  The default tile is
always a candidate, so every entry is measured at or below the default on
the same measurement.

Targets: the paper's four MoE layers (``--configs``, ``PAPER_CONFIGS``) at
``TOKEN_SWEEP`` on the ``fixed`` schedule, and the served models
(``--arch``: moonshot-v1-16b-a3b, deepseek-v2-236b) at ``SERVED_TOKENS``:
2 (two decoding slots), 10 (a k = 4 speculative verify on 2 slots), 64 (a
prefill-chunk step: 32 prompt tokens on each of 2 slots) on the engine's
``dynamic`` schedule, each with the sub-block floor's sweep, and 4096 (a
training batch of 8 x 512) on ``fixed``.  With neither flag, both sets.

Off the GPU the kernels' plain versions run and their timings mean
nothing, so the tool refuses to write a cache unless ``--force`` (smoke
runs; ``--reduce`` divides d and f by 16)."""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.configs import PAPER_CONFIGS, TOKEN_SWEEP, get_config
from repro_torch.tuning.autotune import tune_moe_layer
from repro_torch.tuning.cache import TuneCache, local_cache_path, reset_cache

SERVED_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-236b")
SERVED_TOKENS = (2, 10, 64, 4096)


def targets(args):
    """(name, E, k, d, f, schedule block_m, tokens, policy, sub-block
    sweep) for each sweep to run."""
    both = args.configs is None and args.arch is None
    configs = sorted(PAPER_CONFIGS) if both else (args.configs or [])
    archs = list(SERVED_ARCHS) if both else (args.arch or [])
    shrink = 16 if args.reduce else 1
    out = []
    for name in configs:
        pc = PAPER_CONFIGS[name]
        for T in args.tokens or TOKEN_SWEEP:
            out.append((name, pc.n_experts, pc.top_k, pc.d_model, pc.d_ffn,
                        128, T, "fixed"))
    for name in archs:
        cfg = get_config(name)
        moe = cfg.moe
        for T in args.tokens or SERVED_TOKENS:
            policy = "fixed" if T >= 4096 else "dynamic"
            out.append((name, moe.n_experts, moe.top_k, cfg.d_model,
                        moe.d_ff_expert, moe.block_m, T, policy))
    return [(n, E, k, max(32, d // shrink), max(32, f // shrink), M, T, p,
             p == "dynamic") for n, E, k, d, f, M, T, p in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="*", default=None,
                    choices=sorted(PAPER_CONFIGS),
                    help="paper MoE layers (default: all, unless --arch)")
    ap.add_argument("--arch", nargs="*", default=None, choices=SERVED_ARCHS,
                    help="served models (default: both, unless --configs)")
    ap.add_argument("--tokens", nargs="*", type=int, default=None,
                    help="routed tokens per sweep (key M = tokens * top_k; "
                         f"default {TOKEN_SWEEP} for the paper layers, "
                         f"{SERVED_TOKENS} for the served models)")
    ap.add_argument("--scheme", nargs="*", default=["dense"],
                    choices=("dense", "int8", "int4"),
                    help="kernel-level weight formats to tune")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--reduce", action="store_true",
                    help="divide d and f by 16 (smoke runs)")
    ap.add_argument("--force", action="store_true",
                    help="write the cache even off the GPU (plain versions' "
                         "timings: smoke runs only)")
    ap.add_argument("--out", default=None,
                    help=f"cache path (default {local_cache_path()})")
    args = ap.parse_args(argv)

    on_gpu = torch.cuda.is_available()
    if not on_gpu and not args.force:
        print("refusing to build a tune cache off the GPU (the plain "
              "versions' timings say nothing of the kernels'); pass --force "
              "for a smoke build", file=sys.stderr)
        return 2
    device = "cuda" if on_gpu else "cpu"
    out_path = args.out or local_cache_path()
    cache = TuneCache.load(out_path) or TuneCache()
    cache.device = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    for name, E, k, d, f, M, T, policy, sub in targets(args):
        for scheme in args.scheme:
            results = tune_moe_layer(
                E=E, top_k=k, d_model=d, d_ffn=f, tokens=T, scheme=scheme,
                reps=args.reps, cache=cache, policy=policy,
                schedule_block_m=M,
                block_m=M if sub and scheme == "dense" else None,
                device=device)
            for res in results:
                w, dflt = res["winner"], res["default"]
                if res["kernel"] == "sub_block":
                    print(f"{name} T={T} sub_block: default floor "
                          f"{dflt['block_m_min']} {dflt['us']:.1f} us -> "
                          f"floor {w['block_m_min']} (sub-block "
                          f"{w['sub_block']}) {w['us']:.1f} us; all: "
                          + ", ".join(f"floor {r['block_m_min']} "
                                      f"{r['us']:.2f} (spread "
                                      f"{r['spread']:.3f})"
                                      for r in res["records"])
                          + f" [{res['key']}]")
                    continue
                print(f"{name} T={T} {policy} {res['kernel']} {scheme}: "
                      f"default ({dflt['block_m']}, {dflt['block_n']}) "
                      + ("not timed: " + res["note"] if dflt["us"] is None
                         else f"{dflt['us']:.1f} us -> tuned "
                              f"({w['block_m']}, {w['block_n']}) "
                              f"{w['us']:.1f} us; all: " + ", ".join(
                                  f"({r['block_m']}, {r['block_n']}) "
                                  f"{r['us']:.2f} (spread "
                                  f"{r['spread']:.3f})"
                                  + ("" if r["bitwise"] else " NOT bitwise")
                                  for r in res["records"]))
                      + f" [{res['key']}]")
            if device == "cuda":
                torch.cuda.empty_cache()
    cache.save(out_path)
    reset_cache()        # the next lookup in this process reads the file
    print(f"wrote {len(cache.entries)} entries -> {out_path}")
    print(json.dumps({"entries": len(cache.entries),
                      "device": cache.device}, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
