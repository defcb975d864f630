"""Continuous-batching engine over ONE contiguous (slots, capacity) KV cache
(counterpart of ``repro.serve.engine.ServeEngine`` in its contiguous mode,
``kv_block_size=0``).

Admission prefills a request's prompt into a free slot and emits its first
token; every ``step`` decodes all active slots in one forward, so each MoE
layer builds one dispatch plan for the whole decode batch.  Active requests
occupy the slot prefix [0, n_active): a retired slot is filled by swapping
the last active slot's cache row into it.  Each step makes one host
transfer (the tokens and their EOS flags).

This engine's configuration is fixed and stated: ``kv_block_size`` is 0
(contiguous cache), ``schedule_policy`` is ``"fixed"`` (the reference
engine defaults to ``"dynamic"``; the port has not ported it yet) and
sampling is greedy.  A paged, non-fixed or non-greedy request raises.
Admission policies, preemption, sampling, observability hooks and
quantisation are not ported yet (ROADMAP.md queue A)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM, RunConfig, init_cache, swap_cache_slots
from repro_torch.serve.step import slot_decode, slot_prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int = 16
    eos: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: LM, *, slots: int = 4,
                 capacity: int = 256, rc: Optional[RunConfig] = None,
                 kv_block_size: int = 0, sampling: str = "greedy",
                 device="cuda"):
        if kv_block_size != 0:
            raise ValueError("the port's engine is contiguous only "
                             "(kv_block_size=0); the paged engine is not "
                             "ported yet")
        if sampling != "greedy":
            raise ValueError(f"sampling {sampling!r}: the port's engine is "
                             "greedy only")
        self.rc = rc or RunConfig()
        if self.rc.schedule_policy != "fixed":
            raise ValueError(f"schedule_policy {self.rc.schedule_policy!r}: "
                             "the port's engine runs the fixed policy")
        self.device = resolve_device(device)
        if model.embed.device.type != self.device.type:
            raise ValueError(f"model on {model.embed.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.capacity = capacity
        self.kv_block_size = 0
        self.cache = init_cache(cfg, slots, capacity,
                                dtype=self.rc.compute_dtype,
                                device=self.device)
        self.pos = np.zeros(slots, np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.n_active = 0
        self.n_forwards = 0
        self.dropped: List[Request] = []

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot and emit its first token; False
        if every slot is taken."""
        if self.n_active >= self.slots:
            return False
        if any(r is not None and r.rid == req.rid for r in self.active):
            raise ValueError(f"rid {req.rid} is already active")
        if len(req.prompt) >= self.capacity:
            raise ValueError(f"prompt of {len(req.prompt)} tokens does not "
                             f"fit slot capacity {self.capacity}")
        s = self.n_active
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None]
        tok, self.cache, _ = slot_prefill(self.model, self.cfg, self.rc,
                                          self.cache, toks, s)
        self.n_forwards += 1
        first = int(tok[0])                     # the prefill's host transfer
        self.pos[s] = len(req.prompt)
        self.active[s] = req
        self.n_active += 1
        req.out.append(first)
        return True

    def step(self) -> int:
        """One decode step over every active slot; returns the number of
        tokens decoded (0 when idle)."""
        n = self.n_active
        if n == 0:
            return 0
        reqs = self.active[:n]
        dev = self.device
        last = torch.as_tensor([[r.out[-1]] for r in reqs], dtype=torch.int64,
                               device=dev)
        pos = torch.as_tensor(self.pos[:n], dtype=torch.int32, device=dev)
        eos = torch.as_tensor([-1 if r.eos is None else r.eos for r in reqs],
                              dtype=torch.int32, device=dev)
        tok, eos_hit, self.cache, _ = slot_decode(
            self.model, self.cfg, self.rc, self.cache, last, pos, eos)
        self.n_forwards += 1
        host = torch.stack([tok, eos_hit.to(torch.int32)]).cpu().numpy()
        for s, r in enumerate(reqs):
            r.out.append(int(host[0, s]))
            self.pos[s] += 1
        # retire top-down so the swap-with-last compaction never moves a
        # slot still to be examined
        for s in range(n - 1, -1, -1):
            r = self.active[s]
            if bool(host[1, s]) or len(r.out) >= r.max_new \
                    or self.pos[s] >= self.capacity - 1:
                self._retire(s)
        return n

    def _retire(self, s: int) -> None:
        self.active[s].done = True
        last = self.n_active - 1
        if s != last:
            swap_cache_slots(self.cache, s, last)
            self.active[s] = self.active[last]
            self.pos[s] = self.pos[last]
        self.active[last] = None
        self.pos[last] = 0
        self.n_active -= 1

    def run(self, requests: List[Request], max_steps: int = 512):
        """Admit first-come first-served and decode until every request is
        done or the step budget runs out.  Returns the completed requests in
        submission order; unfinished ones are kept in ``self.dropped``."""
        live = {id(r) for r in self.active if r is not None}
        pending = [r for r in requests if not r.done and id(r) not in live]
        for _ in range(max_steps):
            while pending and self.n_active < self.slots:
                self.admit(pending.pop(0))
            if self.step() == 0 and not pending:
                break
        self.dropped = [r for r in requests if not r.done]
        return [r for r in requests if r.done]
