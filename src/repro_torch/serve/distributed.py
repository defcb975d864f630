"""Multi-rank serving: per-host admission feeding one engine step on every
rank (counterpart of ``repro.serve.distributed``).

The SPMD pattern (X-MoE): every rank runs the same host control flow over
the same deterministic request partition, so every rank enters each
engine step, and with it each MoE layer's collectives, in lockstep with
the same slot assignments.  Anything nondeterministic in admission would
desynchronize the ranks, so this loop is built from deterministic pieces:

* ``partition_requests``: a stable round-robin assignment of requests to
  host queues, by submission index (never hash seeds or clocks);
* per-host admission: each host queue has its own admission-policy
  instance (the registered policies are pure functions of the queue and
  the engine's state, so every rank makes the same choice);
* one engine a rank: ``DistributedServeLoop`` drains the host queues
  round-robin into the engine's free slots and drives its step loop.

The reference runs one process over a device mesh; the port runs one
process per rank (``repro_torch.distributed``), each with this loop and an
engine whose MoE layers run ``apply_moe_ep`` over the current EP group."""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.serve.admission import get_admission
from repro_torch.serve.engine import Request, ServeEngine


def partition_requests(requests: Sequence[Request],
                       n_hosts: int) -> List[List[Request]]:
    """Deterministic round-robin partition of ``requests`` into
    ``n_hosts`` queues (submission order kept inside each queue)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    parts: List[List[Request]] = [[] for _ in range(n_hosts)]
    for i, r in enumerate(requests):
        parts[i % n_hosts].append(r)
    return parts


class DistributedServeLoop:
    """Drive one ``ServeEngine`` from per-host admission queues.

    ``run`` keeps ``ServeEngine.run``'s contract (returns the completed
    requests, leaves the rest in ``engine.dropped``), but admission is two
    levels: each host's queue is ordered by its own admission policy, and
    free slots rotate across hosts round-robin, so no host starves.  With
    ``n_hosts=1`` this is the single-host engine loop."""

    def __init__(self, engine: ServeEngine, *, n_hosts: int = 1,
                 admission: str = "fcfs"):
        self.engine = engine
        self.n_hosts = n_hosts
        self._admission = [get_admission(admission)
                           for _ in range(n_hosts)]
        self._rr = 0          # next host to offer a slot to

    def schedule(self, queues: List[List[Request]]) -> None:
        """Fill free engine slots, one per non-empty host queue in
        round-robin order; each host's pick comes from its own admission
        policy over its own queue."""
        eng = self.engine
        while eng.n_active < eng.slots and any(queues):
            for _ in range(self.n_hosts):
                h = self._rr % self.n_hosts
                self._rr += 1
                if queues[h]:
                    pick = self._admission[h](queues[h], engine=eng)
                    eng.admit(queues[h].pop(pick))
                    break

    def run(self, requests: Sequence[Request], max_steps: int = 512,
            parts: Optional[List[List[Request]]] = None):
        """Partition, admit per host, step the engine to completion (or the
        step budget).  ``parts`` overrides the round-robin partition."""
        eng = self.engine
        if parts is None:
            parts = partition_requests(requests, self.n_hosts)
        queues = [eng.enqueue(p) for p in parts]
        eng.dropped = []
        for _ in range(max_steps):
            self.schedule(queues)
            if eng.step() == 0 and not any(queues):
                break
        eng.dropped = [r for r in requests if not r.done]
        if eng.dropped:
            eng.finalize_drops(eng.dropped)
            eng.obs.metrics.inc("serve/dropped", len(eng.dropped))
        return [r for r in requests if r.done]
