"""Continuous-batching greedy engine over a paged KV cache, or over one
contiguous cache (counterpart of ``repro.serve.engine.ServeEngine``).

**Paged** (the default wherever ``paged_supported``; ``kv_block_size=None``
means blocks of 16):

* The device holds a pool of KV blocks and each slot a host-side block
  table (``serve/kv_cache.py``).  Slot compaction is a table move on the
  host.
* Admission attaches prefix-cache hits to the slot and sets its prompt
  cursor; it runs no forward.
* Every step assembles one token batch: each active slot's decode token,
  or the next chunk of up to ``prefill_chunk`` prompt tokens.  One forward
  covers them all, so every MoE layer builds one dispatch plan over decode
  and chunk tokens together, and attention reads each row's blocks straight
  off the pool.
* Postprocess advances the prompt cursors, registers newly full prompt
  blocks in the prefix index, emits tokens, retires finished requests
  top-down and compacts the active prefix.

**Contiguous** (``kv_block_size=0``): admission prefills the whole prompt
into a free slot and emits the first token; every step decodes all active
slots in one forward; a retired slot is filled by swapping the last active
slot's cache row into it.

Both make one host transfer per step (the tokens and their EOS flags).
With ``rc.quant`` set to a scheme, the engine quantizes the routed experts
of the model it is given, in place, at construction (idempotent under the
same scheme) and records their stored bytes in ``quant_expert_bytes``.
Defaults follow the reference: the ``dynamic`` schedule policy when no
``rc`` is given, ``prefill_chunk=32`` and the prefix cache on.  Admission
is first-come first-served; other admission policies, preemption,
non-greedy sampling and observability hooks are not ported yet and raise
(ROADMAP.md queue A)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM, RunConfig, init_cache, swap_cache_slots
from repro_torch.quantization import quantize_model, routed_expert_bytes
from repro_torch.serve.kv_cache import PagedKVCache, paged_supported
from repro_torch.serve.step import paged_step, slot_decode, slot_prefill

DEFAULT_KV_BLOCK = 16


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int = 16
    eos: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # set at retirement: ``serve/decode_batch`` (decode rows of the final
    # step), ``serve/prefix_hit_tokens`` (prompt tokens served from shared
    # blocks) and ``serve/prefill_forwards`` (forwards the prompt rode in)
    stats: dict = dataclasses.field(default_factory=dict)


class PagedBatch(NamedTuple):
    """One paged step's token rows and their device tensors."""
    rows: list                      # (slot, token, position, kind) per row
    tokens: torch.Tensor            # (T, 1) int64
    pos: torch.Tensor               # (T,) int32
    tables: torch.Tensor            # (T, blocks_per_slot) int32
    eos: torch.Tensor               # (T,) int32, -1 = none


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: LM, *, slots: int = 4,
                 capacity: int = 256, rc: Optional[RunConfig] = None,
                 admission: str = "fcfs",
                 kv_block_size: Optional[int] = None,
                 prefix_cache: bool = True, prefill_chunk: int = 32,
                 sampling: str = "greedy", device="cuda"):
        if admission != "fcfs":
            raise ValueError(f"admission {admission!r}: the port's engine "
                             "admits first-come first-served only")
        if sampling != "greedy":
            raise ValueError(f"sampling {sampling!r}: the port's engine is "
                             "greedy only")
        self.rc = rc or RunConfig(schedule_policy="dynamic")
        self.device = resolve_device(device)
        if model.embed.device.type != self.device.type:
            raise ValueError(f"model on {model.embed.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.quant_expert_bytes = None
        if self.rc.quant != "none" and cfg.is_moe:
            # load-time transform, in place and one stack at a time; a
            # model already quantized under the scheme is left as it is
            quantize_model(model, self.rc.quant)
            # the counterpart of the reference's serve/quant_expert_bytes
            # gauge: the compressed bytes the routed experts hold
            self.quant_expert_bytes = routed_expert_bytes(model)
        self.model = model
        self.slots = slots
        self.capacity = capacity
        if kv_block_size is None:       # paged wherever the model allows
            kv_block_size = DEFAULT_KV_BLOCK if paged_supported(cfg) else 0
        self.kv_block_size = kv_block_size
        self.paged = kv_block_size > 0
        self.prefill_chunk = max(1, prefill_chunk)
        self.pos = np.zeros(slots, np.int64)
        # active requests occupy slots [0, n_active)
        self.active: List[Optional[Request]] = [None] * slots
        self.n_active = 0
        self.n_forwards = 0
        self.dropped: List[Request] = []
        self._seq: List[Optional[np.ndarray]] = [None] * slots
        # (decode rows, prompt rows) of the last step
        self.last_step = (0, 0)
        if self.paged:
            self.kv = PagedKVCache(cfg, slots, capacity, kv_block_size,
                                   prefix_cache=prefix_cache,
                                   dtype=self.rc.compute_dtype,
                                   device=self.device)
            self.cache = None
            # prompt cursor: prompt tokens whose KV is written
            self._prefill_next = np.zeros(slots, np.int64)
            self._prefix_hit = np.zeros(slots, np.int64)
            self._prefill_forwards = np.zeros(slots, np.int64)
        else:
            self.kv = None
            self.cache = init_cache(cfg, slots, capacity,
                                    dtype=self.rc.compute_dtype,
                                    device=self.device)

    # ------------------------------------------------------------------
    def admit(self, req: Request) -> bool:
        """Claim a free slot for ``req``; False if every slot is taken.
        Paged: attach prefix-cache hits and set the prompt cursor (the
        prompt is processed in chunks inside later steps).  Contiguous:
        prefill the prompt and emit the first token."""
        if self.n_active >= self.slots:
            return False
        if any(r is not None and r.rid == req.rid for r in self.active):
            raise ValueError(f"rid {req.rid} is already active")
        s = self.n_active
        seq = np.asarray(req.prompt, np.int32)
        if self.paged:
            # capacity governs, not the block-rounded table size
            limit = min(self.capacity,
                        self.kv.blocks_per_slot * self.kv.block_size)
            if len(seq) > limit:
                raise ValueError(f"prompt of {len(seq)} tokens exceeds slot "
                                 f"capacity {limit}")
            n_cached = self.kv.attach_prefix(s, seq)
            self.pos[s] = n_cached
            self._prefill_next[s] = n_cached
            self._prefix_hit[s] = n_cached
            self._prefill_forwards[s] = 0
        else:
            if len(seq) >= self.capacity:
                raise ValueError(f"prompt of {len(seq)} tokens does not "
                                 f"fit slot capacity {self.capacity}")
            toks = torch.as_tensor(seq.astype(np.int64),
                                   device=self.device)[None]
            tok, self.cache, _ = slot_prefill(self.model, self.cfg, self.rc,
                                              self.cache, toks, s)
            self.n_forwards += 1
            req.out.append(int(tok[0]))          # the prefill's host transfer
            self.pos[s] = len(seq)
        self._seq[s] = seq
        self.active[s] = req
        self.n_active += 1
        return True

    def step(self) -> int:
        """One forward over every active slot; returns the number of token
        rows it processed (0 when idle)."""
        return self._step_paged() if self.paged else self._step_contig()

    # -- paged ---------------------------------------------------------
    def assemble(self) -> PagedBatch:
        """The next paged step's rows: per active slot its decode token, or
        the next chunk of its prompt; allocates the blocks they write."""
        rows = []
        last_pos: Dict[int, int] = {}
        for s in range(self.n_active):
            r = self.active[s]
            seq = self._seq[s]
            nx, P = int(self._prefill_next[s]), len(seq)
            if nx < P:
                for j in range(min(self.prefill_chunk, P - nx)):
                    # the last prompt token seeds the first output
                    kind = ("final" if nx + j == P - 1 and not r.out
                            else "chunk")
                    rows.append((s, int(seq[nx + j]), nx + j, kind))
            else:
                rows.append((s, r.out[-1], int(self.pos[s]), "decode"))
            last_pos[s] = rows[-1][2]
        for s, p in last_pos.items():
            self.kv.ensure_allocated(s, p)
        dev = self.device
        eos = [-1 if k != "decode" or self.active[s].eos is None
               else self.active[s].eos for s, _, _, k in rows]
        return PagedBatch(
            rows=rows,
            tokens=torch.as_tensor([[t] for _, t, _, _ in rows],
                                   dtype=torch.int64, device=dev),
            pos=torch.as_tensor([p for _, _, p, _ in rows],
                                dtype=torch.int32, device=dev),
            tables=torch.as_tensor(self.kv.table_rows([s for s, *_ in rows]),
                                   dtype=torch.int32, device=dev),
            eos=torch.as_tensor(eos, dtype=torch.int32, device=dev))

    def _step_paged(self) -> int:
        n = self.n_active
        if n == 0:
            return 0
        batch = self.assemble()
        tok, eos_hit, self.kv.pools, _ = paged_step(
            self.model, self.cfg, self.rc, self.kv.pools, batch.tokens,
            batch.pos, batch.tables, batch.eos)
        self.n_forwards += 1
        host = torch.stack([tok, eos_hit.to(torch.int32)]).cpu().numpy()
        decode_row: Dict[int, int] = {}
        chunks = np.zeros(n, np.int64)
        for i, (s, _, _, kind) in enumerate(batch.rows):
            if kind == "decode":
                self.active[s].out.append(int(host[0, i]))
                self.pos[s] += 1
                decode_row[s] = i
            else:
                chunks[s] += 1
                if kind == "final":           # prompt complete: 1st token
                    self.active[s].out.append(int(host[0, i]))
        for s in np.nonzero(chunks)[0]:
            self._prefill_next[s] += chunks[s]
            self.pos[s] += chunks[s]
            self._prefill_forwards[s] += 1
            self.kv.register_filled(int(s), self._seq[s],
                                    int(self._prefill_next[s]))
        self.last_step = (len(decode_row), len(batch.rows) - len(decode_row))
        # retire top-down so compaction (move-last-into-freed) never moves
        # a slot still to be examined
        for s in range(n - 1, -1, -1):
            if s not in decode_row:
                continue
            r = self.active[s]
            if bool(host[1, decode_row[s]]) or len(r.out) >= r.max_new \
                    or self.pos[s] >= self.capacity - 1:
                self._retire(s, decode_batch=len(decode_row))
        return len(batch.rows)

    # -- contiguous ----------------------------------------------------
    def _step_contig(self) -> int:
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
        self.last_step = (n, 0)
        # retire top-down so the swap-with-last compaction never moves a
        # slot still to be examined
        for s in range(n - 1, -1, -1):
            r = self.active[s]
            if bool(host[1, s]) or len(r.out) >= r.max_new \
                    or self.pos[s] >= self.capacity - 1:
                self._retire(s, decode_batch=n)
        return n

    # ------------------------------------------------------------------
    def _retire(self, s: int, *, decode_batch: int) -> None:
        req = self.active[s]
        req.stats = {"serve/decode_batch": float(decode_batch)}
        if self.paged:
            req.stats["serve/prefix_hit_tokens"] = float(self._prefix_hit[s])
            req.stats["serve/prefill_forwards"] = \
                float(self._prefill_forwards[s])
            self.kv.release_slot(s)
        else:
            req.stats["serve/prefix_hit_tokens"] = 0.0
            req.stats["serve/prefill_forwards"] = 1.0
        self._compact(s)
        req.done = True

    def _compact(self, s: int) -> None:
        """Vacate slot ``s`` keeping the active prefix contiguous (paged: a
        host-side table move; contiguous: a device row swap)."""
        last = self.n_active - 1
        if s != last:
            if self.paged:
                self.kv.move_slot(s, last)
                for a in (self._prefill_next, self._prefix_hit,
                          self._prefill_forwards):
                    a[s] = a[last]
            else:
                swap_cache_slots(self.cache, s, last)
            self.active[s] = self.active[last]
            self.pos[s] = self.pos[last]
            self._seq[s] = self._seq[last]
        if self.paged:
            for a in (self._prefill_next, self._prefix_hit,
                      self._prefill_forwards):
                a[last] = 0
        self._seq[last] = None
        self.active[last] = None
        self.pos[last] = 0
        self.n_active -= 1

    def run(self, requests: List[Request], max_steps: int = 512):
        """Admit first-come first-served and step until every request is
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
