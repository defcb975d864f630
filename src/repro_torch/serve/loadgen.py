"""Trace-driven load generator (counterpart of ``repro.serve.loadgen``):
seeded arrival traces replayed through ``ServingFrontend`` and scored by
goodput under SLO.

Production MoE serving is characterised by its arrival patterns (Poisson
steady state, bursts, fleets of requests sharing a prefix, long-tail
prompt lengths), and what it buys is goodput: completions that met their
latency SLOs, per second.  ``synth_trace`` makes those patterns as
deterministic, numpy-seeded traces (the reference's arrays for the same
seed), and ``replay`` runs one through the front end and records it.

**Virtual time.**  A replay runs on a ``VirtualClock`` injected as the
observability clock: every engine step advances it by a fixed
``step_time``, and arrivals, deadlines and latency stamps all read it.
The replay (tokens, admission order, preemptions, TTFT/TPOT percentiles,
goodput) is then a function of the trace's seed and the engine's
configuration only.

**Wall-clock calibration.**  ``step_time=None`` keeps the virtual
timeline but advances it by measurement: each engine step is timed with
``time.perf_counter`` and the clock moves by an EWMA of the measured
step seconds (the engine's own EWMA reads the virtual clock).  Goodput and
SLO numbers then follow the real step cost while arrivals stay those of
the trace; the mode and the measured EWMA are recorded in the record's
config block."""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.obs import Observability, latency_summary
from repro_torch.serve.frontend import ServingFrontend

PATTERNS = ("poisson", "burst", "shared_prefix", "longtail")


class VirtualClock:
    """A deterministic clock the replay advances by hand (one engine
    step = ``step_time`` virtual seconds).  Inject as the engine's
    observability clock so every latency stamp reads replay time."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now


@dataclasses.dataclass
class TraceEvent:
    t: float                           # arrival time (virtual seconds)
    prompt: np.ndarray                 # (P,) int32
    max_new: int
    slo_ttft: Optional[float] = None
    slo_tpot: Optional[float] = None


def synth_trace(pattern: str, *, seed: int, n: int, rate: float,
                vocab: int, max_new: int = 8,
                slo_ttft: Optional[float] = None,
                slo_tpot: Optional[float] = None,
                prompt_lo: int = 4, prompt_hi: int = 12,
                burst_size: int = 4, prefix_len: int = 16,
                tail_len: int = 48, tail_frac: float = 0.1
                ) -> List[TraceEvent]:
    """One seeded arrival trace of ``n`` requests at offered rate
    ``rate`` req/s (virtual time):

    * ``poisson``       — exponential interarrivals, uniform prompts.
    * ``burst``         — Poisson epochs each delivering ``burst_size``
                          near-simultaneous requests (rate counts
                          REQUESTS, so epochs come at rate/burst_size).
    * ``shared_prefix`` — bursty fleets sharing a common prompt prefix
                          (the prefix-cache + slo interaction workload).
    * ``longtail``      — Poisson arrivals, but ``tail_frac`` of prompts
                          are ``tail_len`` tokens (head-of-line blockers).
    """
    if pattern not in PATTERNS:
        raise ValueError(f"unknown trace pattern {pattern!r}; "
                         f"known: {PATTERNS}")
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix_len).astype(np.int32)

    def plen() -> int:
        if pattern == "longtail" and rng.random() < tail_frac:
            return tail_len
        return int(rng.integers(prompt_lo, prompt_hi))

    events: List[TraceEvent] = []
    t = 0.0
    while len(events) < n:
        if pattern in ("burst", "shared_prefix"):
            t += rng.exponential(burst_size / rate)
            k = min(burst_size, n - len(events))
        else:
            t += rng.exponential(1.0 / rate)
            k = 1
        for j in range(k):
            body = rng.integers(0, vocab, plen()).astype(np.int32)
            prompt = (np.concatenate([shared, body])
                      if pattern == "shared_prefix" else body)
            # intra-burst arrivals are distinct but tightly packed
            events.append(TraceEvent(t=t + j * 1e-3, prompt=prompt,
                                     max_new=max_new, slo_ttft=slo_ttft,
                                     slo_tpot=slo_tpot))
    return events


def _met_slo(r) -> bool:
    ttft_ok = r.slo_ttft is None \
        or r.stats.get("lat/ttft_s", float("inf")) <= r.slo_ttft
    tpot_ok = r.slo_tpot is None \
        or r.stats.get("lat/tpot_s", float("inf")) <= r.slo_tpot
    return bool(r.done) and ttft_ok and tpot_ok


def replay(engine, trace: List[TraceEvent], *, clock: VirtualClock,
           step_time: Optional[float], max_steps: int = 4096,
           seed: Optional[int] = None, pattern: Optional[str] = None,
           on_token=None, ewma_alpha: float = 0.3) -> dict:
    """Replay ``trace`` through a fresh front-end on ``engine`` and
    score it.  ``clock`` must be the engine's observability clock (the
    replay advances it ``step_time`` per engine step); ``engine`` should
    be freshly constructed (no live slots).

    ``step_time=None`` enables wall-clock calibration: each engine step
    is timed for real and the clock advances by the running EWMA of the
    measured step seconds (``ewma_alpha`` weights the newest sample).
    When the engine idles before the next arrival the clock fast-forwards
    to it — real deployments sleep there; spinning virtual steps through
    the gap would just exhaust ``max_steps``.

    Returns the artifact record: goodput-under-SLO, slo attainment,
    p50/p99 TTFT/TPOT, preemption/resume counts, per-phase obs counters
    (when a metrics sink is attached), and the self-describing cell
    config."""
    fe = ServingFrontend(engine)
    calibrated = step_time is None
    est: Optional[float] = None        # EWMA of measured step seconds
    if not calibrated:
        engine.step_time_hint = step_time  # price feasibility in replay time
    handles = []
    i = steps = 0
    while (i < len(trace) or fe.outstanding) and steps < max_steps:
        if calibrated:
            if not fe.outstanding and i < len(trace):
                # idle gap: jump to the next arrival instead of spinning
                clock.advance(max(0.0, trace[i].t - clock.now))
            clock.advance(est or 0.0)  # the step about to run, estimated
        else:
            clock.advance(step_time)   # time the step about to run takes
        while i < len(trace) and trace[i].t <= clock.now:
            ev = trace[i]
            handles.append(fe.submit(ev.prompt, max_new=ev.max_new,
                                     slo_ttft=ev.slo_ttft,
                                     slo_tpot=ev.slo_tpot,
                                     on_token=on_token))
            i += 1
        if calibrated:
            t0 = time.perf_counter()
            fe.poll()
            dt = time.perf_counter() - t0
            est = dt if est is None else \
                (1.0 - ewma_alpha) * est + ewma_alpha * dt
            engine.step_time_hint = est
        else:
            fe.poll()
        steps += 1
    # censored stats for anything unfinished at budget exhaustion
    leftovers = [r for r in handles if not r.done]
    if leftovers:
        engine.finalize_drops(leftovers)
    n_done = sum(1 for r in handles if r.done)
    n_good = sum(1 for r in handles if _met_slo(r))
    makespan = max(clock.now, step_time or est or 0.0, 1e-9)
    lat = latency_summary([r for r in handles if r.done])
    rec = {
        "pattern": pattern,
        "n_requests": len(handles),
        "offered": len(trace),
        "steps": steps,
        "step_time_s": step_time if not calibrated else est,
        "step_time_mode": "calibrated" if calibrated else "fixed",
        "makespan_s": makespan,
        "completed": n_done,
        "dropped": len(handles) - n_done,
        "slo_good": n_good,
        "slo_attainment": n_good / max(1, len(handles)),
        "goodput_rps": n_good / makespan,
        "throughput_rps": n_done / makespan,
        "preempted": engine.n_preempted,
        "resumed": engine.n_resumed,
        "latency": lat,
        "ttft_p50_s": lat["ttft_s"]["p50"] if lat["ttft_s"] else None,
        "ttft_p99_s": lat["ttft_s"]["p99"] if lat["ttft_s"] else None,
        "tpot_p50_s": lat["tpot_s"]["p50"] if lat["tpot_s"] else None,
        "tpot_p99_s": lat["tpot_s"]["p99"] if lat["tpot_s"] else None,
        "config": engine.describe(seed=seed),
        "outputs": {r.rid: list(r.out) for r in handles},
    }
    # calibration provenance lives with the rest of the cell config: a
    # reader of the artifact must be able to tell measured-wall-scaled
    # timelines from fixed virtual ones
    rec["config"]["step_calibration"] = {
        "mode": rec["step_time_mode"],
        "ewma_alpha": ewma_alpha if calibrated else None,
        "measured_step_ewma_s": est,
    }
    if engine.paged:
        rec["kv_stats"] = engine.kv.stats()
    obs = engine.obs
    if obs.enabled:
        # per-phase counters: scheduling/preemption/streaming activity
        snap = obs.metrics.snapshot()
        rec["obs_counters"] = {c["name"]: c["value"]
                               for c in snap["counters"] if not c["labels"]}
        obs.metrics.set_gauge("slo/goodput_rps", rec["goodput_rps"])
        obs.metrics.set_gauge("slo/attainment", rec["slo_attainment"])
        obs.metrics.set_gauge("slo/deadline_misses",
                              len(handles) - n_good)
    return rec


def make_virtual_obs(enabled: bool = False):
    """A (clock, Observability) pair on one virtual timeline: the full
    in-memory bundle when ``enabled`` (loadgen artifacts then include
    obs counters), else null sinks reading the same clock."""
    clock = VirtualClock()
    obs = Observability.memory(clock=clock) if enabled \
        else Observability(clock=clock)
    return clock, obs
