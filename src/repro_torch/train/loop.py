"""The training loop: data -> step -> metrics -> async checkpoints, with
straggler monitoring, failure injection and resume on restart
(counterpart of ``repro.train.loop``).  Elastic restore onto another mesh
waits for the port's sharded training."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import device_batch, make_batch
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
          obs=None) -> Dict:
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
    step is logged, whose metrics are read after it."""
    obs = obs or NOOP
    dev = resolve_device(device)
    manager = CheckpointManager(ckpt_dir, keep_last=keep_last) \
        if ckpt_dir else None
    injector = FailureInjector(fail_at)
    monitor = StragglerMonitor()
    step_fn = make_train_step(cfg, rc, opt, accum_steps=accum)
    state = init_train_state(cfg, seed, rc, device=dev)
    start, resumed_from = 0, None
    if manager is not None and manager.latest_step() is not None:
        resumed_from = manager.latest_step()
        manager.restore(state, resumed_from)
        start = resumed_from + 1
        log(f"[train] resumed from step {resumed_from}")
    history = []
    try:
        for step in range(start, steps):
            monitor.start_step(step)
            obs.step_begin(step)
            injector.maybe_fail(step)
            with obs.tracer.span("train/data", step=step):
                b = device_batch(make_batch(cfg, batch, seq, step=step,
                                            accum=accum, seed=seed + 1), dev)
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
                    manager.save(step, state)
    finally:
        if manager is not None:
            manager.wait()
    if manager is not None:
        manager.save(steps - 1, state)
        manager.wait()
    return {"state": state, "history": history,
            "stragglers": monitor.flagged, "resumed_from": resumed_from,
            "checkpoint": dict(manager.stats) if manager else None}
