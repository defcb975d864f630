"""Rank body of tests/test_torch_sharded_train.py and
tests/test_torch_family_grid.py: runs in each spawned gloo rank, imports
torch and the port only (never JAX), and returns numpy.

``rank_main(group, spec)`` makes each grid of ``spec["grids"]`` over the
spawned ranks (every rank makes every grid's groups, in the same order)
and runs that grid's cases: a sharded fp32 step's loss, metrics, gathered
gradients (with and without remat) and gathered parameters after the
step and the shapes of the activation blocks gathered (and, with
``case["heads"]``, of the WKV recurrence's and the SSD scan's inputs);
checkpoints saved,
restored and resumed; ``compressed_psum`` over a
'pod' group; ``combine_stats`` over a 'model' group; the EP layer on the
global x under autograd.  Only rank 0 returns the gathered arrays."""
import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.distributed import apply_moe_ep
from repro_torch.core.moe_layer import dispatch_config
from repro_torch.data.pipeline import device_batch, local_batch
from repro_torch.distributed.ctx import use_rules
from repro_torch.distributed.group import make_grid
from repro_torch.distributed.sharding import (batch_specs, opt_state_specs,
                                              unshard)
from repro_torch.models.lm import RunConfig, loss_fn
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import (grid_rules, make_train_step,
                                    reduce_grads, train_state)
from repro_torch.weights import from_jax_params, shard_train_state

BATCH, SEQ = 8, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
CF = 1.0                       # the capacity_factor case's headroom: drops


# the late families' reduced depths: rwkv6 and the vlm and audio encoder
# as reduced (2 layers; the vlm's one group holds its cross block), zamba2
# with 2 groups, so that both shared blocks and the suffix's own run
FAMILY_LAYERS = {"rwkv6-1.6b": 2, "zamba2-7b": 7, "llama-3.2-vision-11b": 2,
                 "hubert-xlarge": 2}


def model_config(arch: str):
    if arch == "qwen2-7b":     # the reference's sharded-step test
        return reduced(get_config(arch), layers=2, d_model=64, n_heads=4)
    return reduced(get_config(arch), layers=FAMILY_LAYERS.get(arch, 3))


def run_config(policy: str, remat: bool = False,
               overlap: bool = False) -> RunConfig:
    """``overlap``: the pipelined EP dispatch, 2 microbatches."""
    return RunConfig(q_chunk=0, kv_chunk=16, loss_chunk=16, remat=remat,
                     schedule_policy=policy, capacity_factor=CF,
                     moe_stats=True, ep_overlap=overlap, ep_microbatches=2)


def sharded_state(case: dict, grid):
    cfg = model_config(case["arch"])
    model = from_jax_params(cfg, case["tree"], device="cpu")
    return cfg, shard_train_state(train_state(model), grid, cfg)


def case_batch(case: dict, grid, cfg) -> dict:
    """This rank's block of the case's whole batch (``case["batch"]``, or
    its ``tokens``)."""
    whole = case.get("batch") or {"tokens": case["tokens"]}
    rows = whole["tokens" if "tokens" in whole else "labels"].shape[0]
    return device_batch(local_batch(whole, grid, batch_specs(
        cfg, grid, "train", rows), cfg), "cpu")


def gathered(tensors: dict, specs: dict, grid) -> dict:
    return {n: unshard(t.detach(), specs[n], grid).numpy()
            for n, t in tensors.items()}


def grads_on_grid(case: dict, grid, remat: bool, compress_pod=False,
                  gathers=None, heads=None):
    """(loss, metrics, {name: whole gradient}) of one sharded fp32
    forward/backward, reduced as the step reduces it.  With ``gathers`` (a
    list) the shape of every activation block that the forward gathers
    (``ctx.gather_dim``) is appended to it; with ``heads`` (a list) the
    shapes of r, k, v, w and u at each WKV recurrence and of x, dt, B, C
    and a at each SSD scan, named."""
    from repro_torch.distributed import ctx
    from repro_torch.models import rwkv6, ssm
    cfg, state = sharded_state(case, grid)
    model = state["params"]
    rc = run_config(case["policy"], remat, case.get("overlap", False))
    batch = case_batch(case, grid, cfg)
    params = dict(model.named_parameters())
    patched = [(ctx, "gather_dim"), (rwkv6, "wkv_recurrence"),
               (ssm, "ssd_chunked")]
    saved = [getattr(mod, name) for mod, name in patched]

    def recorded(x, *args):
        gathers.append(tuple(x.shape))
        return saved[0](x, *args)

    def wkv(*args):
        heads.append(("wkv", [tuple(a.shape) for a in args[:5]]))
        return saved[1](*args)

    def ssd(*args):
        heads.append(("ssd", [tuple(a.shape) for a in args[:5]]))
        return saved[2](*args)
    if gathers is not None:
        ctx.gather_dim = recorded
    if heads is not None:
        rwkv6.wkv_recurrence, ssm.ssd_chunked = wkv, ssd
    rows = batch["tokens" if "tokens" in batch else "labels"].shape[0]
    try:
        with use_rules(grid, grid_rules(cfg, grid, rows)):
            loss, metrics = loss_fn(model, cfg, rc, batch)
            grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        for (mod, name), fn in zip(patched, saved):
            setattr(mod, name, fn)
    grads = reduce_grads(dict(zip(params, grads)), model.shard_specs, grid,
                         compress_pod)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            gathered(grads, model.shard_specs, grid))


def step_on_grid(case: dict, grid):
    cfg, state = sharded_state(case, grid)
    batch = case_batch(case, grid, cfg)
    step = make_train_step(cfg, run_config(case["policy"],
                                           overlap=case.get("overlap", False)),
                           OptConfig(**case.get("opt", OPT)), grid=grid)
    state, metrics = step(state, batch)
    model = state["params"]
    return ({k: float(v) for k, v in metrics.items()},
            gathered(dict(model.named_parameters()), model.shard_specs,
                     grid))


def run_case(case: dict, grid, rank0: bool) -> dict:
    """The case's loss, metrics, gradients, the activation blocks its
    forward gathered, and its step; with ``case["remat"]`` also whether the
    gradients with remat are bitwise those without."""
    gathers, heads = [], ([] if case.get("heads") else None)
    loss, metrics, grads = grads_on_grid(case, grid, remat=False,
                                         gathers=gathers, heads=heads)
    step_metrics, params = step_on_grid(case, grid)
    out = {"loss": loss, "metrics": metrics, "step_metrics": step_metrics,
           "gathers": gathers, "heads": heads}
    if case.get("remat"):
        _, _, grads_remat = grads_on_grid(case, grid, remat=True)
        out["remat_bitwise"] = all(np.array_equal(grads[n], grads_remat[n])
                                   for n in grads)
    if rank0:
        out.update(grads=grads, params=params)
    return out


# ----------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------
def train_run(grid, ckpt_dir: str, steps: int,
              arch: str = "moonshot-v1-16b-a3b", batch: int = BATCH):
    from repro_torch.train.loop import train
    cfg = model_config(arch)
    return train(cfg, run_config("fixed"), OptConfig(**OPT), steps=steps,
                 batch=batch, seq=SEQ, ckpt_dir=ckpt_dir, save_every=100,
                 log=lambda *_: None, device="cpu", grid=grid)


def restored_leaves(grid, ckpt_dir: str, step: int,
                    arch: str = "moonshot-v1-16b-a3b") -> dict:
    """The checkpoint of ``step`` restored onto this grid's blocks, then
    gathered whole."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten_state
    from repro_torch.train.step import init_train_state
    cfg = model_config(arch)
    state = init_train_state(cfg, 7, run_config("fixed"), device="cpu",
                             grid=grid)
    specs = state["params"].shard_specs
    opt_specs = opt_state_specs(specs)
    shardings = {f"params/{n}": s for n, s in specs.items()}
    shardings.update({f"opt/{k}/{n}": s for k in ("m", "v")
                      for n, s in opt_specs[k].items()})
    CheckpointManager(ckpt_dir).restore(state, step, shardings=shardings,
                                        grid=grid)
    return {n: unshard(t.detach(), shardings.get(n, ()), grid).numpy()
            for n, t in flatten_state(state).items()}


def run_ckpt(grid, job: dict, rank0: bool) -> dict:
    out = {}
    arch = job.get("arch", "moonshot-v1-16b-a3b")
    if "save" in job:               # one step, saved at its end
        train_run(grid, job["save"], 1, arch, job.get("batch", BATCH))
    if "resume" in job:             # interrupted at 2 steps, then resumed
        d = job["resume"]
        train_run(grid, d + "/split", 2, arch)
        out["resumed_from"] = train_run(grid, d + "/split", 3, arch)[
            "resumed_from"]
        train_run(grid, d + "/whole", 3, arch)
    if "restore" in job:
        leaves = restored_leaves(grid, job["restore"], job["step"], arch)
        if rank0:
            out["leaves"] = leaves
    return out


# ----------------------------------------------------------------------
# compressed_psum, combine_stats, the EP layer under autograd
# ----------------------------------------------------------------------
def run_psum(grid, g: np.ndarray) -> np.ndarray:
    from repro_torch.optim.compress import compressed_psum
    row = torch.from_numpy(g[grid.coords["pod"]])
    return compressed_psum(row, grid.group("pod")).numpy()


def run_combine(grid, qkv: dict) -> np.ndarray:
    from repro_torch.models.attention import combine_stats, flash_attention
    q, k, v = (torch.from_numpy(qkv[n]) for n in ("q", "k", "v"))
    n = k.shape[1] // grid.sizes["model"]
    off = grid.coords["model"] * n
    acc, l, m = flash_attention(
        q, k[:, off:off + n], v[:, off:off + n], causal=False,
        kv_limit=torch.full((q.shape[0],), k.shape[1] - 1), kv_offset=off,
        q_chunk=1, kv_chunk=16, return_stats=True)
    out = combine_stats(acc, l, m, grid.group("model"))
    B = q.shape[0]
    return out.permute(0, 3, 1, 2, 4).reshape(B, q.shape[1], -1,
                                               out.shape[-1]).numpy()


def run_ep_grad(grid, job: dict) -> dict:
    """apply_moe_ep on the global x under autograd: y, the router losses
    and the gradients of x, the router and this rank's experts."""
    from repro_torch.configs.base import MoEConfig
    g = grid.group("model")
    moe = MoEConfig(**job["moe"])
    cfg = dispatch_config(moe, executor="cuda",
                          schedule_policy=job["policy"],
                          capacity_factor=job["capacity_factor"])
    p = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in job["params"].items()}
    n = moe.n_experts // g.size
    local = {k: (v[g.rank * n:(g.rank + 1) * n] if v.dim() == 3 else v)
             for k, v in p.items()}
    x = torch.from_numpy(job["x"].copy()).requires_grad_()
    y, aux = apply_moe_ep(local, x, cfg, group=g)
    loss = (y * torch.from_numpy(job["dy"])).sum() + aux["lb_loss"] \
        + aux["router_z"]
    loss.backward()
    return {"y": y.detach().numpy(), "lb_loss": float(aux["lb_loss"]),
            "router_z": float(aux["router_z"]),
            "grads": {k: v.grad.numpy() for k, v in p.items()},
            "dx": x.grad.numpy()}


def run_launcher(group, argv: list, rank0: bool) -> str:
    """The train launcher's rank body (``--grid``) on this group's ranks;
    rank 0's standard output."""
    import contextlib
    import io
    from repro_torch.launch.train import parse_args, train_rank
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_rank(group, parse_args(argv))
    return buf.getvalue() if rank0 else ""


def rank_main(group, spec: dict) -> dict:
    torch.set_num_threads(1)
    out = {}
    for gname, jobs in spec["grids"]:
        pod, data, model = (int(v) for v in gname.split("x"))
        grid = make_grid(data, model, pod, device=group.device,
                         verbose=False)
        rank0 = grid.rank == 0
        for name, job in jobs.items():
            kind = job["kind"]
            if kind == "case":
                res = run_case(job, grid, rank0)
            elif kind == "ckpt":
                res = run_ckpt(grid, job, rank0)
            elif kind == "psum":
                res = run_psum(grid, job["g"])
            elif kind == "combine":
                res = run_combine(grid, job)
            elif kind == "compress":        # the 'pod' sum as int8
                res = grads_on_grid(job, grid, False, compress_pod=True)[2]
            elif kind == "launch":
                res = run_launcher(group, job["argv"], rank0)
            else:
                res = run_ep_grad(grid, job)
            out[f"{gname}/{name}"] = res
    return out
