"""Fault-tolerance runtime: straggler detection, failure injection,
restart-with-resume supervision (the port's own copy of
``repro.runtime.fault``, standard library only).

``StragglerMonitor`` keeps a rolling step-time window and flags steps
beyond ``factor`` x the rolling median; ``FailureInjector`` raises at a
chosen step so a test can drive the failure path; ``supervise`` reruns a
resumable function after a failure."""
from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Deque, List, Optional


class StragglerMonitor:
    def __init__(self, window: int = 32, factor: float = 2.0,
                 warmup: int = 3,
                 clock: Callable[[], float] = time.perf_counter):
        """``clock`` is injectable so tests drive the monitor with a
        deterministic virtual clock instead of wall-time sleeps."""
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.factor = factor
        self.warmup = warmup
        self.clock = clock
        self.flagged: List[dict] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._t0 = self.clock()
        self._step = step

    def end_step(self) -> Optional[dict]:
        dt = self.clock() - self._t0
        verdict = None
        if len(self.window) >= self.warmup:
            med = statistics.median(self.window)
            if dt > self.factor * med:
                verdict = {"step": self._step, "duration": dt,
                           "median": med,
                           "slowdown": dt / med}
                self.flagged.append(verdict)
        self.window.append(dt)
        return verdict


class FailureInjector:
    """Deterministically raise at a given step — tests use this to prove
    the checkpoint/restart path loses no more than `save_every` steps."""

    def __init__(self, fail_at_step: Optional[int] = None,
                 exc: type = RuntimeError):
        self.fail_at_step = fail_at_step
        self.exc = exc
        self.fired = False

    def maybe_fail(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step \
                and not self.fired:
            self.fired = True
            raise self.exc(f"injected failure at step {step}")


def supervise(run: Callable[[], dict], *, max_restarts: int = 3) -> dict:
    """Run a (resumable) training function, restarting on failure — the
    single-process stand-in for a cluster supervisor."""
    restarts = 0
    while True:
        try:
            out = run()
            out["restarts"] = restarts
            return out
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
