"""Step-timeline span tracer emitting Chrome-trace / Perfetto JSON (the
port's own copy of ``repro.obs.trace``).

``SpanTracer`` records host-side wall-clock spans of the serve and train
loops (admission, prefix-hash probe, step assembly, the forward, the one
host transfer per step, retirement) and instant events for what happens to
the loop: a step at a new shape, straggler-flagged slow steps, block
evictions and compactions.  The file loads in ``chrome://tracing`` or
https://ui.perfetto.dev.

Overhead: a span is two ``clock()`` calls and one dict append.  Nothing
here touches a device tensor, launches a kernel or synchronises: the
forward span measures what the host spends enqueueing the forward (CUDA
is asynchronous), the host_sync span measures where the host waits.  The
default sink is ``NullTracer`` (one shared no-op context manager, no
state).

The device-side view is ``device_trace()``: a ``torch.profiler`` bracket
over CPU and CUDA activities that writes the profiler's own Chrome trace
(kernel names and device times) into a directory of its own.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, List, Optional


class _Span:
    """Context manager for one complete ("ph": "X") event."""
    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer, name, args):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = self.tracer.clock()
        return self

    def __exit__(self, *exc):
        t1 = self.tracer.clock()
        self.tracer._emit(self.name, "X", self.t0, dur=t1 - self.t0,
                          args=self.args)
        return False


class SpanTracer:
    """Chrome-trace event collector (host-side spans + instants)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 process_name: str = "repro-serve"):
        self.clock = clock
        self.process_name = process_name
        self._t_origin = clock()
        self.events: List[dict] = []

    # -- recording -----------------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self._t_origin) * 1e6

    def _emit(self, name: str, ph: str, t: float, *, dur: float = None,
              args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": ph, "ts": self._us(t),
              "pid": 0, "tid": 0}
        if dur is not None:
            ev["dur"] = dur * 1e6
        if ph == "i":
            ev["s"] = "t"                       # thread-scoped instant
        if args:
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else repr(v)) for k, v in args.items()}
        self.events.append(ev)

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("serve/forward", tokens=T): ...``"""
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        self._emit(name, "i", self.clock(), args=args or None)

    # -- export --------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Events sorted by timestamp (viewers require monotone order
        within a track) under the standard ``traceEvents`` envelope."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        return {"traceEvents":
                meta + sorted(self.events, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def save(self, path) -> str:
        import pathlib
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_chrome_trace(), indent=1))
        return str(p)


class NullTracer(SpanTracer):
    """Default sink: ``span()`` hands back one shared do-nothing context
    manager and ``instant``/``save`` are empty: no clock reads, no
    allocation, no file."""

    def __init__(self):
        super().__init__(clock=lambda: 0.0)
        self._null = contextlib.nullcontext()

    def span(self, name, **args):
        return self._null

    def instant(self, name, **args):
        pass

    def save(self, path):
        return None


NULL_TRACER = NullTracer()


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Optional ``torch.profiler`` bracket: records CPU and CUDA activity
    (kernel launches and device times) and writes the profiler's Chrome
    trace to ``logdir/device_trace.json``, independent of the host span
    file.  Yields the profiler (None when ``logdir`` is falsy, which
    makes the bracket a no-op).  Best-effort, as the reference's: a
    profiler that fails to start or to write degrades to a warning, never
    a crashed serve run."""
    if not logdir:
        yield None
        return
    import pathlib
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except RuntimeError as e:                   # pragma: no cover - backend
        print(f"[obs] device trace unavailable ({e!r}); continuing without")
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                out = pathlib.Path(logdir)
                out.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(out / "device_trace.json"))
            except (RuntimeError, OSError) as e:  # pragma: no cover
                print(f"[obs] device trace stop failed ({e!r})")


def validate_chrome_trace(doc: dict, *, required_names=()) -> dict:
    """Structural validation used by tests and the chip smoke run:
    ``traceEvents`` envelope, complete events carry ts+dur, timestamps
    monotone after the declared sort, required span names present.
    Returns {"events": n, "names": set} on success, raises otherwise."""
    assert isinstance(doc, dict) and "traceEvents" in doc, \
        "not a chrome-trace envelope"
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    assert evs, "trace has no events"
    names = set()
    last_ts = None
    for e in evs:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e), e
        if e["ph"] == "X":
            assert "dur" in e and e["dur"] >= 0, e
        assert last_ts is None or e["ts"] >= last_ts, \
            f"non-monotone ts: {e}"
        last_ts = e["ts"]
        names.add(e["name"])
    missing = set(required_names) - names
    assert not missing, f"required span names missing from trace: {missing}"
    return {"events": len(evs), "names": names}
