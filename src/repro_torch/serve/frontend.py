"""Open-stream serving front end: a request queue and token streaming
(counterpart of ``repro.serve.frontend``).

``ServeEngine.run`` takes a closed batch.  Production traffic is an open
stream: requests arrive while others decode, and callers want each token
as it is made.  The front end is a thin layer over the engine:

* ``submit`` stamps the request's queue-wait origin (the engine's
  ``lat/queue_wait_s`` counts from here) and registers an optional
  per-request token callback.  Nothing runs: admission happens in the
  next ``poll``, under the engine's admission policy.
* ``poll`` runs one (or more) scheduling passes and engine steps and
  returns the requests that finished in it.  Callbacks fire from the
  engine's ``on_token`` hook, when the step's one host transfer puts each
  token into ``Request.out``: streaming adds no transfer, and the
  streamed tokens are those of a closed-batch ``run``.
* ``drain`` polls until every request has finished or a step budget runs
  out, and gives what is still unfinished finite censored ``lat/*``
  stats, as ``run`` does for its drops.

One front end owns one engine: constructing it installs the engine's
``on_token`` hook."""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import Request, ServeEngine

TokenCallback = Callable[[Request, int], None]


class ServingFrontend:
    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.pending: List[Request] = []
        self._inflight: Dict[int, Request] = {}     # rid -> submitted req
        self._callbacks: Dict[int, TokenCallback] = {}
        self._rids = itertools.count()
        engine.on_token = self._on_token

    # -- submission ----------------------------------------------------
    def submit(self, prompt, *, max_new: int = 16, eos: Optional[int] = None,
               rid: Optional[int] = None,
               slo_ttft: Optional[float] = None,
               slo_tpot: Optional[float] = None,
               seed: Optional[int] = None,
               on_token: Optional[TokenCallback] = None) -> Request:
        """Enter one request into the open queue; returns the Request as
        the caller's handle (poll ``.done`` / ``.out``, or stream with
        ``on_token(req, tok)``).  The queue-wait clock starts here.
        ``seed`` keys the request's sampling stream; None derives one from
        the engine's base + rid."""
        if rid is None:
            rid = next(self._rids)
            while rid in self._inflight:
                rid = next(self._rids)
        elif rid in self._inflight:
            raise ValueError(f"rid {rid} is already in flight")
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new=max_new, eos=eos,
                      slo_ttft=slo_ttft, slo_tpot=slo_tpot, seed=seed)
        self.engine.enqueue([req])     # the lat/queue_wait_s origin
        self.pending.append(req)
        self._inflight[rid] = req
        if on_token is not None:
            self._callbacks[rid] = on_token
        return req

    def _on_token(self, req: Request, tok: int) -> None:
        cb = self._callbacks.get(req.rid)
        if cb is not None:
            cb(req, tok)

    # -- introspection -------------------------------------------------
    @property
    def outstanding(self) -> int:
        """Requests submitted and not finished (queued, active, or
        preempted and waiting to resume)."""
        return sum(1 for r in self._inflight.values() if not r.done)

    # -- driving -------------------------------------------------------
    def poll(self, steps: int = 1) -> List[Request]:
        """Advance the engine by up to ``steps`` scheduling passes and
        engine steps, firing the token callbacks; returns the requests
        that completed in this poll (a retired handle leaves the in-flight
        table, so each completion is reported once)."""
        done: List[Request] = []
        for _ in range(max(1, steps)):
            self.engine.schedule(self.pending)
            n = self.engine.step()
            for rid in [rid for rid, r in self._inflight.items() if r.done]:
                done.append(self._inflight.pop(rid))
                self._callbacks.pop(rid, None)
            if n == 0 and not self.pending:
                break                  # idle: nothing to schedule
        return done

    def drain(self, max_steps: int = 512) -> List[Request]:
        """Poll until every submitted request has finished or the step
        budget runs out.  Unfinished requests get finite censored ``lat/*``
        stats (``engine.finalize_drops``) and a later poll or drain
        resumes them."""
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.poll())
            if not self.outstanding:
                break
        leftovers = [r for r in self._inflight.values() if not r.done]
        if leftovers:
            self.engine.finalize_drops(leftovers)
        return done
