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
kernels' plain versions on the CPU.

``--grid DxM`` (or ``PxDxM``; the reference's ``--debug-mesh``) trains on
a grid of ranks, one process a rank (``distributed.group.make_grid``):
'data' carries batch DP and FSDP storage of every matrix, 'model' the
routed experts (EP) and the sequence (SP), or for the recurrent families
(rwkv6-1.6b, zamba2-7b) the heads, 'pod' extra DP
(``--compress-pod`` sends its gradient sum as int8).  One process spawns
the ranks on ``--device`` (gloo; several ranks share a card); with
``--distributed`` this process is one rank of a group launched outside
(torchrun's environment, or ``--coordinator`` / ``--num-processes`` /
``--process-id``), NCCL where each rank has a card of its own::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch moonshot-v1-16b-a3b --reduce --grid 2x2 --steps 2 \\
        --device cpu

Rank 0 alone prints and writes checkpoints."""
import argparse
import contextlib
import io

import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# chunked_ce's chunk length: at seq 512 the loss runs in 7 strided chunks of
# 73 positions, so one chunk's logits exist at a time
LOSS_CHUNK = 128


def parse_args(argv=None):
    from repro_torch.configs import ARCH_NAMES
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
    ap.add_argument("--grid", default=None, metavar="DxM",
                    help="train on a grid of ranks: DxM or PxDxM (pod x "
                         "data x model)")
    ap.add_argument("--compress-pod", action="store_true",
                    help="the 'pod' axis's gradient sum as int8")
    ap.add_argument("--distributed", action="store_true",
                    help="with --grid: this process is one rank of a group "
                         "launched outside (torchrun, or --coordinator / "
                         "--num-processes / --process-id)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap.parse_args(argv)


def grid_dims(text: str):
    """'DxM' -> (1, D, M); 'PxDxM' -> (P, D, M)."""
    dims = [int(v) for v in text.lower().split("x")]
    if len(dims) == 2:
        dims = [1] + dims
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"--grid {text!r}: DxM or PxDxM")
    return tuple(dims)


def main(argv=None):
    """Train; with ``--grid``, on every rank of the grid.  Returns the
    loop's result (``train.loop.train``); with ``--grid``, rank 0's
    ``{"history", "stragglers" (a count), "resumed_from"}``."""
    args = parse_args(argv)
    if args.grid is None:
        return run(args, args.device)
    pod, data, model = grid_dims(args.grid)
    if args.distributed:
        import torch.distributed as dist
        from repro_torch.distributed import init_distributed
        dev = init_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
        try:
            return train_rank(None, args, dev)
        finally:
            dist.destroy_process_group()
    from repro_torch.distributed import spawn_ranks
    return spawn_ranks(train_rank, pod * data * model, args.device, args,
                       None)[0]


def train_rank(group, args, device=None):
    """One rank of a ``--grid`` launch; ranks other than 0 print
    nothing (their errors still reach stderr)."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_grid
    pod, data, model = grid_dims(args.grid)
    dev = group.device if group is not None else device
    grid = make_grid(data, model, pod, device=dev)
    quiet = (contextlib.redirect_stdout(io.StringIO())
             if dist.get_rank() != 0 else contextlib.nullcontext())
    with quiet:
        out = run(args, dev, grid)
    return {"history": out["history"], "stragglers": len(out["stragglers"]),
            "resumed_from": out["resumed_from"]}


def run(args, device, grid=None):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    rc = RunConfig(compute_dtype=DTYPES[args.dtype], loss_chunk=LOSS_CHUNK,
                   remat=not args.reduce)
    opt = OptConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 1))
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    where = "" if grid is None else f" on {grid!r}"
    print(f"{cfg.name}: {cfg.n_layers} layers at d_model={cfg.d_model}, "
          f"fp32 parameters, {args.dtype} compute, fixed schedule, "
          f"cuda executor, remat {rc.remat}; batch {args.batch} x seq "
          f"{args.seq}, accum {args.accum}, {args.steps} steps{where}")
    out = train(cfg, rc, opt, steps=args.steps, batch=args.batch,
                seq=args.seq, accum=args.accum, ckpt_dir=args.ckpt_dir,
                save_every=args.save_every, log_every=1, device=device,
                grid=grid, compress_pod=args.compress_pod)
    h = out["history"]
    peak = (f"{torch.cuda.max_memory_allocated()} bytes" if on_card
            else "not measured (no card)")
    if not h:
        print(f"done: nothing to run past the checkpoint of step "
              f"{out['resumed_from']}")
        return out
    print(f"done: ce {h[0]['ce']:.4f} -> {h[-1]['ce']:.4f}; "
          f"stragglers={len(out['stragglers'])}; peak device memory {peak}"
          + ("" if grid is None else " (rank 0)"))
    return out


if __name__ == "__main__":
    main()
