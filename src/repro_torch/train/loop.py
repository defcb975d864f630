"""The training loop: data -> step -> metrics, with straggler monitoring
and failure injection (counterpart of ``repro.train.loop``).  The
checkpoint manager (save, resume, elastic restore) is not ported yet."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import device_batch, make_batch
from repro_torch.models.lm import RunConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.fault import FailureInjector, StragglerMonitor
from repro_torch.train.step import init_train_state, make_train_step


def train(cfg: ModelConfig, rc: RunConfig, opt: OptConfig, *,
          steps: int, batch: int, seq: int, accum: int = 1,
          ckpt_dir: Optional[str] = None, fail_at: Optional[int] = None,
          seed: int = 0, log_every: int = 10,
          log: Callable[[str], None] = print, device="cuda") -> Dict:
    """Returns {"state", "history", "stragglers"}: ``history`` holds the
    metrics (floats) of every ``log_every``-th step and of the last."""
    if ckpt_dir is not None:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP item 12: the "
            "checkpoint manager)")
    dev = resolve_device(device)
    injector = FailureInjector(fail_at)
    monitor = StragglerMonitor()
    step_fn = make_train_step(cfg, rc, opt, accum_steps=accum)
    state = init_train_state(cfg, seed, rc, device=dev)
    history = []
    for step in range(steps):
        monitor.start_step(step)
        injector.maybe_fail(step)
        b = device_batch(make_batch(cfg, batch, seq, step=step, accum=accum,
                                    seed=seed + 1), dev)
        state, metrics = step_fn(state, b)
        flag = monitor.end_step()
        if flag:
            log(f"[straggler] step {flag['step']} "
                f"{flag['slowdown']:.1f}x median")
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}   # syncs the step
            history.append({"step": step, **m})
            log(f"[train] step {step:5d} loss {m.get('loss', 0):.4f} "
                f"ce {m.get('ce', 0):.4f} gnorm "
                f"{m.get('grad_norm', 0):.3f}")
    return {"state": state, "history": history,
            "stragglers": monitor.flagged}
