"""Training launcher: random weights from seed 0, the reference's Markov
token stream, AdamW, on the ``cuda`` executor (the MoE layers' forward and
backward on the kernels).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch moonshot-v1-16b-a3b --layers 4 --steps 5 --batch 8 \\
        --seq 512 --dtype bf16

Widths are the architecture's own; ``--layers`` cuts depth, ``--reduce``
takes the reduced (smoke) config as the reference's launcher does, and
remat (each layer recomputed in the backward) is on unless ``--reduce``,
as there.  Parameters and optimizer moments are fp32; ``--dtype`` is the
compute dtype.  ``--ckpt-dir`` saves the state every ``--save-every``
steps and at the end; run the same command again and it resumes from the
last checkpoint there.  Runs on the card; ``--device cpu`` runs the
kernels' plain versions on the CPU.  No mesh: one device."""
import argparse

import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# chunked_ce's chunk length: at seq 512 the loss runs in 7 strided chunks of
# 73 positions, so one chunk's logits exist at a time
LOSS_CHUNK = 128


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES, get_config, reduced
    from repro_torch.models.lm import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut (default: the architecture's own)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduce", action="store_true",
                    help="use the reduced (smoke) config")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    rc = RunConfig(compute_dtype=DTYPES[args.dtype], loss_chunk=LOSS_CHUNK,
                   remat=not args.reduce)
    opt = OptConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 1))
    on_card = torch.device(args.device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    print(f"{cfg.name}: {cfg.n_layers} layers at d_model={cfg.d_model}, "
          f"fp32 parameters, {args.dtype} compute, fixed schedule, "
          f"cuda executor, remat {rc.remat}; batch {args.batch} x seq "
          f"{args.seq}, accum {args.accum}, {args.steps} steps")
    out = train(cfg, rc, opt, steps=args.steps, batch=args.batch,
                seq=args.seq, accum=args.accum, ckpt_dir=args.ckpt_dir,
                save_every=args.save_every, log_every=1, device=args.device)
    h = out["history"]
    peak = (f"{torch.cuda.max_memory_allocated()} bytes" if on_card
            else "not measured (no card)")
    if not h:
        print(f"done: nothing to run past the checkpoint of step "
              f"{out['resumed_from']}")
        return out
    print(f"done: ce {h[0]['ce']:.4f} -> {h[-1]['ce']:.4f}; "
          f"stragglers={len(out['stragglers'])}; peak device memory {peak}")
    return out


if __name__ == "__main__":
    main()
