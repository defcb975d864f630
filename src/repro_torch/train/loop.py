"""The training loop: data -> step -> metrics -> async checkpoints, with
straggler monitoring, failure injection and resume on restart
(counterpart of ``repro.train.loop``), on one device or, with ``grid``, on
this rank's blocks of the state and the batch (one process a rank, every
rank running this loop): checkpoints hold full arrays and resume onto any
grid (elastic)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import device_batch, local_batch, make_batch
from repro_torch.distributed.sharding import batch_specs, opt_state_specs
from repro_torch.models.lm import RunConfig
from repro_torch.obs import NOOP
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.fault import FailureInjector, StragglerMonitor
from repro_torch.train.step import init_train_state, make_train_step


def train(cfg: ModelConfig, rc: RunConfig, opt: OptConfig, *,
          steps: int, batch: int, seq: int, accum: int = 1,
          ckpt_dir: Optional[str] = None, save_every: int = 20,
          keep_last: int = 3, fail_at: Optional[int] = None,
          seed: int = 0, log_every: int = 10,
          log: Callable[[str], None] = print, device="cuda",
          obs=None, grid=None, compress_pod: bool = False) -> Dict:
    """Returns {"state", "history", "stragglers", "resumed_from",
    "checkpoint"}: ``history`` holds the metrics (floats) of every
    ``log_every``-th step and of the last; ``checkpoint`` the manager's
    ``stats`` (None without ``ckpt_dir``).

    With ``ckpt_dir`` the state is saved every ``save_every`` steps (not at
    step 0) and at the end, keeping the last ``keep_last`` checkpoints, and
    a run that finds a checkpoint there resumes from the step after it
    (``resumed_from`` is that checkpoint's step, else None).  The data of
    step i depends on i and the seed only, so a resumed run sees the
    batches an uninterrupted one would.

    ``obs`` (``repro_torch.obs.Observability``, default ``NOOP``) adds the
    spans ``train/data``, ``train/step`` and ``train/checkpoint`` (the
    in-loop saves), the straggler bracket (``train/slow_steps``), and at
    each logged step ``train/steps_logged`` and one ``train/<metric>``
    histogram sample per metric.  The ``train/step`` span measures what
    the host spends enqueueing the step (CUDA is asynchronous) unless the
    step is logged, whose metrics are read after it.

    ``grid`` (``distributed.group.Grid``): every rank of it runs this loop
    on its blocks (``train.step.make_train_step(grid=...)``); each batch
    is cut by ``batch_specs`` (``data.pipeline.local_batch``), rank 0
    alone logs and writes checkpoints (every rank gathers into them), and
    a resume restores each rank's blocks from the full arrays, whatever
    grid wrote them.  ``compress_pod``: the 'pod' axis's gradient sum as
    int8 (``optim.compress.compressed_psum``)."""
    obs = obs or NOOP
    dev = resolve_device(device)
    manager = CheckpointManager(ckpt_dir, keep_last=keep_last) \
        if ckpt_dir else None
    injector = FailureInjector(fail_at)
    monitor = StragglerMonitor()
    step_fn = make_train_step(cfg, rc, opt, accum_steps=accum, grid=grid,
                              compress_pod=compress_pod)
    state = init_train_state(cfg, seed, rc, device=dev, grid=grid)
    shardings = bspecs = None
    if grid is not None:
        if grid.rank != 0:
            log = _silent
        specs = state["params"].shard_specs
        opt_specs = opt_state_specs(specs)
        shardings = {f"params/{n}": sp for n, sp in specs.items()}
        shardings.update({f"opt/{k}/{n}": sp for k in ("m", "v")
                          for n, sp in opt_specs[k].items()})
        bspecs = batch_specs(cfg, grid, "train", batch,
                             microbatched=accum > 1)
    start, resumed_from = 0, None
    if manager is not None and manager.latest_step() is not None:
        resumed_from = manager.latest_step()
        manager.restore(state, resumed_from, shardings=shardings, grid=grid)
        start = resumed_from + 1
        log(f"[train] resumed from step {resumed_from}")
    history = []
    try:
        for step in range(start, steps):
            monitor.start_step(step)
            obs.step_begin(step)
            injector.maybe_fail(step)
            with obs.tracer.span("train/data", step=step):
                b = make_batch(cfg, batch, seq, step=step, accum=accum,
                               seed=seed + 1)
                if grid is not None:
                    b = local_batch(b, grid, bspecs, cfg)
                b = device_batch(b, dev)
            with obs.tracer.span("train/step", step=step):
                state, metrics = step_fn(state, b)
            flag = monitor.end_step()
            obs.step_end(step, scope="train")
            if flag:
                log(f"[straggler] step {flag['step']} "
                    f"{flag['slowdown']:.1f}x median")
            if step % log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}  # syncs
                history.append({"step": step, **m})
                if obs.enabled:
                    obs.metrics.inc("train/steps_logged")
                    obs.metrics.observe_many("train/", m)
                log(f"[train] step {step:5d} loss {m.get('loss', 0):.4f} "
                    f"ce {m.get('ce', 0):.4f} gnorm "
                    f"{m.get('grad_norm', 0):.3f}")
            if manager is not None and step % save_every == 0 and step > 0:
                with obs.tracer.span("train/checkpoint", step=step):
                    manager.save(step, state, shardings, grid)
    finally:
        if manager is not None:
            manager.wait()
    if manager is not None:
        manager.save(steps - 1, state, shardings, grid)
        manager.wait()
        if grid is not None:       # no rank reads it before rank 0 is done
            grid.world.barrier()
    return {"state": state, "history": history,
            "stragglers": monitor.flagged, "resumed_from": resumed_from,
            "checkpoint": dict(manager.stats) if manager else None}


def _silent(*_):
    pass
