"""End-to-end training driver: train an LM on the synthetic Markov corpus
with checkpointing, resume and straggler monitoring, through the port's
trainer (counterpart of ``examples/train_lm.py``).

Presets:
  cpu-small (default): a 2-layer, 64-wide MoE model, 200 steps.
  100m: a ~100M-parameter dense config (12 layers, 768 wide, 49k vocab),
        bf16 compute with remat; use --steps to bound it.

    PYTHONPATH=src python examples/torch/train_lm.py [--device cpu]
    PYTHONPATH=src python examples/torch/train_lm.py --preset 100m --steps 20
    PYTHONPATH=src python examples/torch/train_lm.py --resume   # continues
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import RunConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import train


def build(preset: str):
    if preset == "cpu-small":
        cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2,
                      d_model=64, vocab=64)
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, first_dense_layers=0))
        rc = RunConfig(q_chunk=32, kv_chunk=32, loss_chunk=32)
        return cfg, rc, dict(steps=200, batch=8, seq=64,
                             opt=OptConfig(lr=1e-2, warmup_steps=10,
                                           total_steps=200,
                                           weight_decay=0.0))
    if preset == "100m":
        cfg = get_config("smollm-360m").replace(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048)                      # ~100M params
        rc = RunConfig(compute_dtype=torch.bfloat16, q_chunk=256,
                       kv_chunk=256, loss_chunk=256, remat=True)
        return cfg, rc, dict(steps=300, batch=8, seq=1024,
                             opt=OptConfig(lr=3e-4, warmup_steps=50,
                                           total_steps=300))
    raise SystemExit(f"unknown preset {preset}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu-small",
                    choices=["cpu-small", "100m"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure (demo: rerun with --resume)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, rc, kw = build(args.preset)
    steps = args.steps or kw["steps"]
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    out = train(cfg, rc, kw["opt"], steps=steps, batch=kw["batch"],
                seq=kw["seq"], ckpt_dir=args.ckpt_dir, save_every=25,
                fail_at=args.fail_at, log_every=10, device=dev)
    hist = out["history"]
    print(f"\nfinal ce={hist[-1]['ce']:.4f} (start {hist[0]['ce']:.4f}) on "
          f"{dev}; stragglers flagged: {len(out['stragglers'])}; "
          f"resumed_from={out['resumed_from']}")


if __name__ == "__main__":
    main()
