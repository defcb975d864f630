"""Per-request latency accounting: TTFT, TPOT, queue wait, E2E (the port's
own copy of ``repro.obs.latency``).

The engine keeps one ``RequestTimeline`` per in-flight rid (host clock
stamps only: submit at ``enqueue``, admit when a slot is claimed, one
stamp per engine step shared by every token that step produced) and turns
it into ``Request.stats`` at retirement under the ``lat/*`` keys, beside
the ``sched/*`` plan stats and the ``serve/*`` engine counters, so one
schema covers all per-request telemetry (the same key set for the paged
and the contiguous engine).

The aggregation helpers turn a batch of retired requests into the p50/p99
table the serve launcher prints.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.obs.metrics import percentile

# every retired request carries exactly these lat/* keys (both engines)
LAT_KEYS = ("lat/queue_wait_s", "lat/ttft_s", "lat/tpot_s", "lat/e2e_s",
            "lat/decode_tokens")


@dataclasses.dataclass
class RequestTimeline:
    """Host timestamps for one request's serve lifetime.

    ``token_times`` holds one stamp per OUTPUT token (the step's shared
    post-sync stamp — all tokens of one engine step are produced by the
    same forward, so finer granularity would be fiction)."""
    submit: float                       # entered the pending queue
    admit: float = 0.0                  # claimed a slot
    first_token: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    def on_token(self, t: float) -> None:
        if self.first_token is None:
            self.first_token = t
        self.token_times.append(t)

    def finalize(self, *, end: Optional[float] = None) -> dict:
        """-> the ``lat/*`` entries for ``Request.stats``.

        TPOT is the mean inter-token gap over DECODE tokens (first token
        excluded — its cost is prefill and belongs to TTFT); a request
        with a single output token has no decode gap and reports 0.0 so
        every value stays finite."""
        tt = self.token_times
        first = self.first_token if self.first_token is not None \
            else (end if end is not None else self.admit)
        last = tt[-1] if tt else first
        tpot = (last - first) / (len(tt) - 1) if len(tt) > 1 else 0.0
        return {
            "lat/queue_wait_s": self.admit - self.submit,
            "lat/ttft_s": first - self.submit,
            "lat/tpot_s": tpot,
            "lat/e2e_s": (end if end is not None else last) - self.submit,
            "lat/decode_tokens": float(len(tt)),
        }


def aggregate(samples: List[float]) -> Optional[dict]:
    """p50/p99/mean/n of one latency series; None on an empty one (so
    consumers gate on truthiness instead of probing for keys)."""
    if not samples:
        return None
    return {"n": len(samples),
            "mean": float(sum(samples) / len(samples)),
            "p50": percentile(samples, 50.0),
            "p99": percentile(samples, 99.0)}


def latency_summary(requests) -> dict:
    """Aggregate retired requests' ``lat/*`` stats into the percentile
    block the serve launcher prints and writes with ``--metrics-out``:

        {"ttft_s": {"n", "mean", "p50", "p99"}, "tpot_s": {...},
         "queue_wait_s": {...}, "e2e_s": {...}}

    Any request carrying ``lat/*`` stats contributes — including dropped
    or preempted-unfinished requests, whose CENSORED stats the engine
    finalizes at drop time (``ServeEngine.finalize_drops``).  Callers
    reporting completion latencies should pass only completed requests
    and report the censored remainder via ``drop_summary``.
    """
    done = [r for r in requests if getattr(r, "stats", None)]
    out = {}
    for key in ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s"):
        out[key] = aggregate([r.stats[f"lat/{key}"] for r in done
                              if f"lat/{key}" in r.stats])
    return out


def drop_summary(requests) -> Optional[dict]:
    """Roll up requests that never completed (dropped at the step budget
    or preempted without resume).  Their ``lat/*`` stats are censored —
    stamped finite at drop time, measuring time spent, not time to
    completion — so they are reported HERE instead of polluting the
    completion percentiles.  None when every request finished, so
    consumers gate on truthiness."""
    undone = [r for r in requests
              if not getattr(r, "done", False) and getattr(r, "stats", None)]
    if not undone:
        return None
    return {
        "n": len(undone),
        "dropped": sum(1 for r in undone
                       if r.stats.get("serve/dropped", 0.0)),
        "preempted": sum(1 for r in undone
                         if r.stats.get("serve/preempted", 0.0)),
        "rids": [r.rid for r in undone],
        "tokens_out": int(sum(r.stats.get("lat/decode_tokens", 0.0)
                              for r in undone)),
        "wait_s": aggregate([r.stats["lat/e2e_s"] for r in undone
                             if "lat/e2e_s" in r.stats]),
    }
