"""Admission policies: which pending request gets the next free slot (the
port's own copy of ``repro.serve.admission``).

A policy is a function ``(pending, *, engine=None) -> int`` returning the
index of the request to admit, registered under a name the engine and the
launcher select by flag.  Policies see the whole pending queue and the
engine, so they can reorder and consult serving state such as the prefix
index.  Admission never disturbs running decodes (paged: the prompt
chunk-prefills inside the shared step; contiguous: only the slot's cache
row is prefilled).

* ``fcfs``: first come, first served (submission order).
* ``sjf``: shortest prompt first (FCFS tie-break).
* ``prefix_hit``: most cached prefix first (paged engine): the request
  whose prompt has the longest run of blocks in the prefix index; ties
  (every request on a cold cache, or the contiguous engine) fall back to
  FCFS.  Probes are memoized per rid until the index changes.
* ``slo``: TTFT-deadline feasibility.  Pending requests that can still
  meet their TTFT deadline are admitted earliest deadline first;
  no-deadline requests follow; requests whose deadline is blown go last.
  The policy also has the ``preempt`` hook the engine's scheduling pass
  calls: an active request that blew its TTFT deadline before its first
  token, or whose running TPOT is over budget, is preempted (paged: its
  table parks on the host; contiguous: its resume re-prefills), but only
  while a feasible deadline-holder waits for the slot.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

AdmissionPolicy = Callable[..., int]

_POLICIES: Dict[str, AdmissionPolicy] = {}


def register_admission(name: str):
    def deco(fn: AdmissionPolicy) -> AdmissionPolicy:
        _POLICIES[name] = fn
        return fn
    return deco


def get_admission(name: str) -> AdmissionPolicy:
    if name not in _POLICIES:
        raise ValueError(f"unknown admission policy {name!r}; "
                         f"registered: {sorted(_POLICIES)}")
    return _POLICIES[name]


def available_admission_policies():
    return sorted(_POLICIES)


@register_admission("fcfs")
def fcfs(pending: Sequence, *, engine=None) -> int:
    return 0


@register_admission("sjf")
def shortest_prompt_first(pending: Sequence, *, engine=None) -> int:
    return min(range(len(pending)), key=lambda i: (len(pending[i].prompt), i))


@register_admission("prefix_hit")
def most_cached_prefix_first(pending: Sequence, *, engine=None) -> int:
    """Longest currently-cached prefix wins; FCFS tie-break.  Falls back
    to FCFS when no paged prefix index is available.  Probes memoize per
    rid inside the cache (invalidated when the hash index mutates), so a
    stable queue costs one chained-sha256 walk per request, not one per
    scheduling pass."""
    kv = getattr(engine, "kv", None)
    if kv is None or not getattr(kv, "prefix_cache", False):
        return 0
    return min(range(len(pending)),
               key=lambda i: (-kv.probe_prefix(pending[i].prompt,
                                               memo_key=pending[i].rid), i))


# ----------------------------------------------------------------------
# SLO-aware admission + preemption (the serving front-end's policy)
# ----------------------------------------------------------------------
def _prefill_steps(engine, prompt) -> int:
    """Engine steps from slot claim to first token for ``prompt``."""
    if engine is None or not getattr(engine, "paged", False):
        return 1                       # contiguous: one admission prefill
    kv = engine.kv
    cached = kv.probe_prefix(prompt, memo_key=None) if kv.prefix_cache \
        else 0
    todo = max(1, len(prompt) - cached)   # >= 1: final token always runs
    return math.ceil(todo / engine.prefill_chunk)


def _ttft_feasible(engine, req, now: float) -> bool:
    """Can ``req`` still meet its TTFT deadline if admitted right now?"""
    if req.slo_ttft is None:
        return True
    submit = engine._submit.get(req.rid, now)
    est = _prefill_steps(engine, req.prompt) * engine.step_time_estimate()
    return now + est <= submit + req.slo_ttft


def _tpot_feasible(engine, req) -> bool:
    """Can the engine's current decode pace meet ``req``'s TPOT budget?

    One decode token costs one engine step, so the ``step_time_hint`` /
    measured-EWMA estimate IS the expected TPOT — a request demanding a
    faster pace than the engine delivers is infeasible at admit time, not
    just at the post-hoc preemption check.  A 0.0 estimate (no step timed
    yet, no hint) prices every budget as feasible."""
    if req.slo_tpot is None:
        return True
    return engine.step_time_estimate() <= req.slo_tpot


@register_admission("slo")
def slo(pending: Sequence, *, engine=None) -> int:
    """Earliest-feasible-deadline first, pricing BOTH SLO families.

    Rank groups: (0) deadline-holders whose TTFT deadline is reachable
    AND whose TPOT budget the engine's current pace can hold, by
    deadline; (1) requests with no deadline, FCFS; (2) blown/hopeless
    requests — TTFT unreachable or TPOT infeasible — by deadline
    (work-conserving backfill: served only when nothing at-risk waits).
    Feasibility prices remaining prefill steps and decode pace at the
    engine's measured (or hinted) step cost."""
    if engine is None:
        return 0
    now = engine._clock()

    def key(i):
        r = pending[i]
        if r.slo_ttft is None and r.slo_tpot is None:
            return (1, 0.0, i)
        feasible = _ttft_feasible(engine, r, now) \
            and _tpot_feasible(engine, r)
        deadline = engine._submit.get(r.rid, now) + r.slo_ttft \
            if r.slo_ttft is not None else now
        return (0 if feasible else 2, deadline, i)

    return min(range(len(pending)), key=key)


def _slo_preempt(engine, pending: Sequence) -> List[int]:
    """Slots to preempt this scheduling pass (engine.schedule hook).

    A victim is an active request that already lost its own SLO — TTFT
    deadline unreachable with no first token out yet, or running TPOT
    over budget — and preemption is throttled to the number of FEASIBLE
    deadline-holders waiting, so an empty (or hopeless) queue never
    triggers it."""
    if engine is None or engine.n_active < engine.slots:
        return []                      # a free slot exists: just admit
    now = engine._clock()
    demand = sum(1 for r in pending
                 if (r.slo_ttft is not None or r.slo_tpot is not None)
                 and _ttft_feasible(engine, r, now)
                 and _tpot_feasible(engine, r))
    if demand == 0:
        return []
    step_s = engine.step_time_estimate()
    victims = []
    for s in range(engine.n_active):
        r = engine.active[s]
        tl = engine._timing.get(r.rid)
        if tl is None:
            continue
        if r.slo_ttft is not None and not r.out:
            # still prefilling: is the first token now unreachable?
            seq = engine._seq[s]
            left = len(seq) - int(engine._prefill_next[s])
            steps = math.ceil(max(1, left) / engine.prefill_chunk)
            if now + steps * step_s > tl.submit + r.slo_ttft:
                victims.append(s)
                continue
        if r.slo_tpot is not None and len(tl.token_times) > 1:
            pace = (tl.token_times[-1] - tl.first_token) \
                / (len(tl.token_times) - 1)
            if pace > r.slo_tpot:
                victims.append(s)
    return victims[:demand]


slo.preempt = _slo_preempt
