"""Low-overhead metrics registry: labeled counters, gauges, histograms (the
port's own copy of ``repro.obs.metrics``, standard library only).

``MetricsRegistry`` is the one host-side sink the serve and train
telemetry lands in: per-request ``sched/*`` plan stats at retirement,
``PagedKVCache`` events, admission and drop counts.  A metric is addressed
by ``(name, labels)``, created on first touch, and exported as one JSON
snapshot.  Three instruments:

* **counter**: monotone accumulation (requests admitted, slow steps,
  recompiles, evictions).  ``inc(name, value, **labels)``.
* **gauge**: last write wins (blocks in use, quantized expert bytes).
  ``set_gauge(name, value, **labels)``.
* **histogram**: raw samples with a percentile summary (TTFT, TPOT, plan
  stats).  ``observe(name, value, **labels)``; the snapshot reports
  count/sum/min/max/mean and p50/p99.

Everything is plain host-side Python over floats; nothing here reads a
device tensor.  ``NullMetrics`` has the same API and empty bodies: it is
the default sink, so instrumented code never branches on "is observability
on".
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); no interpolation
    surprises at small n."""
    if not values:
        return float("nan")
    s = sorted(values)
    rank = max(1, min(len(s), math.ceil(q / 100.0 * len(s))))
    return float(s[rank - 1])


def summarize(values: List[float]) -> dict:
    """count/sum/min/max/mean + p50/p99 of a raw sample list."""
    if not values:
        return {"count": 0}
    return {"count": len(values), "sum": float(sum(values)),
            "min": float(min(values)), "max": float(max(values)),
            "mean": float(sum(values) / len(values)),
            "p50": percentile(values, 50.0),
            "p99": percentile(values, 99.0)}


class MetricsRegistry:
    """Host-side instrument store; see module docstring for the model."""

    def __init__(self):
        self._counters: Dict[Tuple[str, LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, LabelKey], float] = {}
        self._hists: Dict[Tuple[str, LabelKey], List[float]] = {}

    # -- instruments ---------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = (name, _label_key(labels))
        self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        self._hists.setdefault((name, _label_key(labels)),
                               []).append(float(value))

    def observe_many(self, prefix: str, values: dict, **labels) -> None:
        """Absorb a scalar dict (e.g. a retired request's ``sched/*``
        plan stats) as one histogram sample per key."""
        for k, v in values.items():
            self.observe(f"{prefix}{k}", float(v), **labels)

    # -- export --------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get((name, _label_key(labels)), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get((name, _label_key(labels)))

    def histogram_values(self, name: str, **labels) -> List[float]:
        return list(self._hists.get((name, _label_key(labels)), []))

    def snapshot(self) -> dict:
        """One JSON-ready dict of everything recorded so far."""
        def rows(store, render):
            return [{"name": n, "labels": dict(lk), **render(v)}
                    for (n, lk), v in sorted(store.items())]
        return {
            "counters": rows(self._counters, lambda v: {"value": v}),
            "gauges": rows(self._gauges, lambda v: {"value": v}),
            "histograms": rows(self._hists, summarize),
        }

    def to_json(self, path=None, *, extra: Optional[dict] = None) -> str:
        """Serialize the snapshot (plus an optional ``extra`` section:
        the serve launcher adds its aggregated per-request latency
        block); writes to ``path`` when given, returns the JSON text."""
        doc = self.snapshot()
        if extra:
            doc.update(extra)
        text = json.dumps(doc, indent=1, sort_keys=True)
        if path is not None:
            import pathlib
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)
        return text


class NullMetrics(MetricsRegistry):
    """The default sink: same API, no state, no work.  Instrumented code
    calls it unconditionally — zero-cost-when-off lives here, not in
    ``if obs`` branches at every call site."""

    def __init__(self):
        super().__init__()

    def inc(self, name, value=1.0, **labels):
        pass

    def set_gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def observe_many(self, prefix, values, **labels):
        pass


NULL_METRICS = NullMetrics()
