"""Serve-path observability: metrics registry + span tracer + latency (the
port's own copy of ``repro.obs``, standard library only; it imports
nothing of the reference).

One bundle threads through the serve engine, the serving steps, the paged
KV pool, the executor's plan hook and the train loop:

* ``Observability.metrics``: the labeled counter/gauge/histogram sink
  (obs/metrics.py): per-request ``sched/*`` stats at retirement,
  ``PagedKVCache.stats()`` per step, admission/drop/preemption counts,
  quantized expert payload bytes.
* ``Observability.tracer``: Chrome-trace spans of the step timeline
  (obs/trace.py): admit / prefix probe / assemble / forward / host sync /
  postprocess / retire, and instants for steps at a new shape, slow
  steps, block evictions and compactions.
* ``Observability.straggler``: ``repro_torch.runtime.fault``'s
  ``StragglerMonitor`` as a slow-step detector (injectable clock): a
  flagged step becomes a ``serve/slow_steps`` count and a ``slow_step``
  trace instant.
* per-request latency accounting (obs/latency.py) is always on: a handful
  of host clock reads per step fill ``Request.stats``'s ``lat/*`` keys
  whether or not a sink is attached.

The default is ``NOOP``: null sinks whose methods are empty, so
instrumented code never branches.  Nothing here adds device work (host
clock and values already on the host only): greedy tokens and the
kernels' launch counts are the same with observability on or off.

**Shapes instead of traces.**  The reference counts jit traces: its
``on_trace`` fires inside a jitted step body, which Python runs only while
JAX traces, and its plan hook fires once per traced ``plan_dispatch``.
The port runs eagerly, so the serving steps call ``new_shape`` the first
time a step kind runs at a static shape it has not run at
(``serve/recompiles{kind}`` counts distinct step shapes, the shapes a CUDA
graph capture would capture), and ``on_plan`` counts ``moe/plans_traced``
only inside such a step: one per MoE layer, where the reference's layer
scan traces its body once.

Sinks are registered by name (``null`` and ``memory`` built in) so
launchers select one by flag.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

from repro_torch.obs.latency import (LAT_KEYS, RequestTimeline, aggregate,
                                     drop_summary, latency_summary)
from repro_torch.obs.metrics import (NULL_METRICS, MetricsRegistry,
                                     NullMetrics, percentile, summarize)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, SpanTracer,
                                   device_trace, validate_chrome_trace)

__all__ = [
    "Observability", "NOOP", "MetricsRegistry", "NullMetrics",
    "SpanTracer", "NullTracer", "RequestTimeline", "LAT_KEYS",
    "aggregate", "drop_summary", "latency_summary", "percentile",
    "summarize",
    "device_trace", "validate_chrome_trace", "register_sink", "get_sink",
    "available_sinks", "NULL_METRICS", "NULL_TRACER",
]


class Observability:
    """Metrics + tracer + optional straggler monitor, one shared clock.

    ``enabled`` is False only for the null bundle: call sites that would
    do real work to feed a sink (counting a model's bytes, converting a
    stats dict) gate on it; plain span/counter calls do not, the null
    sinks absorb those for free."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 straggler=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.metrics = NULL_METRICS if metrics is None else metrics
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.straggler = straggler
        self.clock = clock
        self.enabled = not (self.metrics is NULL_METRICS
                            and self.tracer is NULL_TRACER
                            and straggler is None)
        # True while a step runs at a shape not seen before (new_shape)
        self.tracing = False

    @classmethod
    def memory(cls, clock: Callable[[], float] = time.perf_counter,
               straggler_window: int = 32, straggler_factor: float = 2.0):
        """The full in-memory bundle: fresh registry + tracer + straggler
        monitor on one injectable clock (tests drive a virtual clock)."""
        from repro_torch.runtime.fault import StragglerMonitor
        return cls(metrics=MetricsRegistry(),
                   tracer=SpanTracer(clock=clock),
                   straggler=StragglerMonitor(window=straggler_window,
                                              factor=straggler_factor,
                                              clock=clock),
                   clock=clock)

    # -- step bracket (engine/train loops) -----------------------------
    def step_begin(self, step: int) -> None:
        if self.straggler is not None:
            self.straggler.start_step(step)

    def step_end(self, step: int, *, scope: str = "serve") -> None:
        """Close the straggler window for ``step``; a flagged step (>
        factor x rolling median) becomes a ``<scope>/slow_steps`` count
        and a ``slow_step`` trace instant."""
        if self.straggler is None:
            return
        flag = self.straggler.end_step()
        if flag:
            self.metrics.inc(f"{scope}/slow_steps")
            self.tracer.instant(
                "slow_step", scope=scope, step=flag["step"],
                duration_s=flag["duration"],
                slowdown=round(flag["slowdown"], 3))

    # -- shape hooks ---------------------------------------------------
    def on_trace(self, kind: str, **static) -> None:
        """A step kind runs at a static shape for the first time: a
        ``serve/recompiles`` count and a ``recompile`` instant (the
        reference's names).  Host-side only."""
        self.metrics.inc("serve/recompiles", kind=kind)
        self.tracer.instant("recompile", kind=kind, **static)

    @contextlib.contextmanager
    def new_shape(self, kind: str, **static):
        """Bracket the first run of ``kind`` at ``static``: ``on_trace``,
        then the plan hook counts the plans built inside."""
        self.on_trace(kind, **static)
        self.tracing = True
        try:
            yield
        finally:
            self.tracing = False

    def on_plan(self, *, tokens: int, executor: str, policy: str) -> None:
        """Executor plan-stats hook (execution/base.py), called for every
        plan built: counts ``moe/plans_traced`` (tagged by backend and
        policy) only inside a step at a new shape."""
        if not self.tracing:
            return
        self.metrics.inc("moe/plans_traced", executor=executor,
                         policy=policy)
        self.tracer.instant("plan_trace", tokens=tokens,
                            executor=executor, policy=policy)


NOOP = Observability()


# ----------------------------------------------------------------------
# Sink registry: name -> Observability factory
# ----------------------------------------------------------------------
_SINKS: Dict[str, Callable[..., Observability]] = {}


def register_sink(name: str):
    def deco(fn: Callable[..., Observability]):
        _SINKS[name] = fn
        return fn
    return deco


def get_sink(name: str, **kw) -> Observability:
    if name not in _SINKS:
        raise ValueError(f"unknown observability sink {name!r}; "
                         f"registered: {available_sinks()}")
    return _SINKS[name](**kw)


def available_sinks():
    return sorted(_SINKS)


@register_sink("null")
def _null_sink(**kw) -> Observability:
    return NOOP


@register_sink("memory")
def _memory_sink(**kw) -> Observability:
    return Observability.memory(**kw)
