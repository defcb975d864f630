"""Continuous-batching engine over a paged KV cache, or over one
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

**Contiguous** (``kv_block_size=0``, and the automatic choice for a model
with recurrent layers, rwkv6 and zamba2, or with cross-attention blocks,
llama-3.2-vision, whose image K/V have no positions to page): admission
zeroes a free slot's cache rows (a recurrent state, unlike KV rows, has
no position mask to hide its previous occupant), prefills the whole
prompt into them (a vlm's with zero image embeddings, as the reference
engine feeds them) and
emits the first token; every step decodes all active slots in one
forward; a retired slot is filled by swapping the last active slot's
cache row into it, every leaf of it.

Both make one host transfer per step (the tokens and their EOS flags).
With ``rc.quant`` set to a scheme, the engine quantizes the routed experts
of the model it is given, in place, at construction (idempotent under the
same scheme) and records their stored bytes in ``quant_expert_bytes``.
With ``rc.ep`` it first keeps, in place, the current EP group's rank's
share of every MoE layer's experts (``weights.shard_model``), and at
retirement counts each request's dropped assignments into
``serve/ep_dropped_tokens``; every rank runs the same engine over the same
requests (``serve/distributed.py``).
Defaults follow the reference: the ``dynamic`` schedule policy with the
plans' ``sched/*`` telemetry on (``moe_stats``) when no ``rc`` is given,
``prefill_chunk=32`` and the prefix cache on; but ``flash_attention``'s
chunks stay ``RunConfig``'s 512 positions, where the reference's engine
sets 64 (ROADMAP, "Differences by design").  An encoder-only model has no
decode path and raises.

**Scheduling.**  ``run`` stamps submit times (``enqueue``) and calls
``schedule`` before every step: the admission policy (``fcfs``, ``sjf``,
``prefix_hit`` or ``slo``; ``serve/admission.py``) picks the pending
request for each free slot, and a policy with a ``preempt`` hook (``slo``)
may first preempt active requests.  ``preempt(s)`` takes a request out of
its slot mid-flight: the paged engine parks its block table under its rid
(a resume re-attaches it and recomputes nothing; if pool pressure
reclaimed the park, the resume replays prompt + ``out[:-1]``), the
contiguous engine drops its cache row (the resume replays).  Greedy
decoding, and keyed sampling, make a resumed request's tokens those of an
uninterrupted run.

**Observability.**  The engine takes an ``Observability`` bundle
(``repro_torch.obs``; null sinks by default): every step is bracketed into
spans (``serve/step``, ``serve/assemble``, ``serve/forward``,
``serve/host_sync``, ``serve/postprocess``), admission and the prefix
probe are spanned, retirement, preemption and resumption leave instants,
steps at a new shape count ``serve/recompiles``, the pool's occupancy
lands in gauges every step, the straggler monitor flags slow steps, and
retirement absorbs the request's ``sched/*`` plan stats into histograms.
All of it is host-side, over values already on the host: no device work
is added, so greedy tokens and the kernels' launch counts are the same
with observability on or off.  Per-request latency (``lat/*`` in
``Request.stats``: queue wait, TTFT, TPOT, E2E) is always on.  Sampling
follows ``sampling`` (a ``SamplingConfig``; greedy by default): the
stochastic methods draw each token on the device under a key of the
request's seed (``Request.seed``, else the config's base + rid), its
output index and a role, so a request's tokens do not depend on its batch
or its slot, and the engine still makes one transfer a step."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import current_ep_group
from repro_torch.execution.base import set_plan_hook
from repro_torch.models.lm import LM, RunConfig, init_cache, swap_cache_slots
from repro_torch.obs import NOOP, RequestTimeline
from repro_torch.quantization import quantize_model, routed_expert_bytes
from repro_torch.sampling import SamplingConfig, get_sampler
from repro_torch.serve.admission import get_admission
from repro_torch.serve.kv_cache import PagedKVCache, paged_supported
from repro_torch.serve.step import paged_step, slot_decode, slot_prefill
from repro_torch.weights import shard_model

DEFAULT_KV_BLOCK = 16


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int = 16
    eos: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # SLO deadlines in seconds on the engine's clock (None = none): the
    # ``slo`` admission policy admits by their feasibility and preempts
    # active requests that blew them; every other policy ignores them
    slo_ttft: Optional[float] = None
    slo_tpot: Optional[float] = None
    # the request's sampling seed; None derives one from the engine's
    # SamplingConfig base + rid.  Greedy ignores it
    seed: Optional[int] = None
    # set at retirement: the final step's plan aux (``lb_loss``,
    # ``router_z`` and, with ``rc.moe_stats``, ``sched/*``, summed over the
    # MoE layers), ``serve/decode_batch`` (decode rows of that step),
    # ``serve/prefix_hit_tokens`` (prompt tokens served from shared
    # blocks), ``serve/prefill_forwards`` (forwards the prompt rode in) and
    # the ``lat/*`` latencies; a preempted or dropped request holds a
    # censored ``lat/*`` snapshot with ``serve/preempted`` or
    # ``serve/dropped``
    stats: dict = dataclasses.field(default_factory=dict)


class PagedBatch(NamedTuple):
    """One paged step's token rows and their device tensors."""
    rows: list                      # (slot, token, position, kind) per row
    tokens: torch.Tensor            # (T, 1) int64
    pos: torch.Tensor               # (T,) int32
    tables: torch.Tensor            # (T, blocks_per_slot) int32
    eos: torch.Tensor               # (T,) int32, -1 = none
    # sampling only (None under greedy): each row's request seed and the
    # output index it produces (a chunk row's draw is discarded)
    seeds: Optional[torch.Tensor] = None
    counters: Optional[torch.Tensor] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: LM, *, slots: int = 4,
                 capacity: int = 256, rc: Optional[RunConfig] = None,
                 admission: str = "fcfs",
                 kv_block_size: Optional[int] = None,
                 prefix_cache: bool = True, prefill_chunk: int = 32,
                 obs=None, sampling: Optional[SamplingConfig] = None,
                 device="cuda"):
        self.sampling = sampling or SamplingConfig()
        get_sampler(self.sampling.method)         # an unknown method raises
        self._admission_name = admission
        self._admission = get_admission(admission)
        # null sinks by default: every span/counter call is a no-op
        self.obs = obs or NOOP
        self._clock = self.obs.clock
        self.rc = rc or RunConfig(schedule_policy="dynamic", moe_stats=True)
        self.device = resolve_device(device)
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode path "
                             "to serve (it trains by masked prediction)")
        if model.embed.device.type != self.device.type:
            raise ValueError(f"model on {model.embed.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.quant_expert_bytes = None
        if self.rc.ep and cfg.is_moe:
            # load-time transform, as quantization: this rank's experts only
            group = current_ep_group()
            shard_model(model, group.rank, group.size)
        if self.rc.quant != "none" and cfg.is_moe:
            # load-time transform, in place and one stack at a time; a
            # model already quantized under the scheme is left as it is
            quantize_model(model, self.rc.quant)
            # the compressed bytes the routed experts hold
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
        # requests still unfinished when run()'s step budget ran out
        self.dropped: List[Request] = []
        # per-slot prefill source: the prompt, or prompt + out[:-1] when a
        # resume replays a preempted request whose KV is gone
        self._seq: List[Optional[np.ndarray]] = [None] * slots
        # (decode rows, prompt rows) of the last step
        self.last_step = (0, 0)
        # each active request's last step aux (device tensors, moved to
        # the host at retirement), keyed by rid
        self._last_aux: Dict[int, dict] = {}
        # latency timelines keyed by rid (created at admission, popped at
        # retirement) and run()'s submit stamps
        self._timing: Dict[int, RequestTimeline] = {}
        self._submit: Dict[int, float] = {}
        self._step_idx = 0
        # (step kind, static shape) pairs this engine has run
        self._step_shapes: set = set()
        # called as on_token(req, tok) when a token lands in req.out
        self.on_token = None
        # preempted requests' cursors, keyed by rid (the paged table parks
        # in the PagedKVCache under the same key)
        self._parked: Dict[int, dict] = {}
        self.n_preempted = 0
        self.n_resumed = 0
        # step cost for SLO feasibility: the measured EWMA of seconds per
        # step, or step_time_hint when set
        self.step_time_hint: Optional[float] = None
        self._ewma_step_s: Optional[float] = None
        if self.paged:
            self.kv = PagedKVCache(cfg, slots, capacity, kv_block_size,
                                   prefix_cache=prefix_cache,
                                   dtype=self.rc.compute_dtype,
                                   device=self.device)
            self.kv.bind_obs(self.obs.metrics, self.obs.tracer)
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
        if self.obs.enabled:
            # process-global: the last bundle installed wins
            set_plan_hook(self.obs.on_plan)
            if self.quant_expert_bytes is not None:
                self.obs.metrics.set_gauge("serve/quant_expert_bytes",
                                           self.quant_expert_bytes,
                                           scheme=self.rc.quant)

    # ------------------------------------------------------------------
    def admit(self, req: Request) -> bool:
        """Claim a free slot for ``req``; False if every slot is taken.
        Paged: attach prefix-cache hits and set the prompt cursor (the
        prompt is processed in chunks inside later steps), or re-attach a
        preempted request's parked table.  Contiguous: prefill the prompt
        (a resume: prompt + ``out[:-1]``) and emit the first token."""
        if self.n_active >= self.slots:
            return False
        if any(r is not None and r.rid == req.rid for r in self.active):
            raise ValueError(f"rid {req.rid} is already active")
        t_admit = self._clock()
        with self.obs.tracer.span("serve/admit", rid=req.rid,
                                  prompt_tokens=len(req.prompt)):
            self._admit(req, t_admit)
        self.obs.metrics.inc("serve/admitted")
        return True

    def _emit(self, req: Request, tok: int, t: float) -> None:
        """One token into ``req.out`` after the step's host transfer: a
        latency stamp and the streaming hook, no device work."""
        req.out.append(tok)
        self._timing[req.rid].on_token(t)
        if self.on_token is not None:
            self.on_token(req, tok)

    def _req_seed(self, req: Request) -> int:
        """The request's sampling seed: its own, or the engine's base +
        rid, so that the requests of a batch draw distinct streams."""
        return req.seed if req.seed is not None \
            else self.sampling.seed + req.rid

    def draw_keys(self, reqs, counts):
        """(seeds, counters) on the device for rows of ``reqs``: each row's
        request seed and the output index ``counts`` says it produces;
        (None, None) under greedy, whose steps never read them (no copy
        is made)."""
        if self.sampling.method == "greedy":
            return None, None
        return (torch.as_tensor([self._req_seed(r) for r in reqs],
                                dtype=torch.int64, device=self.device),
                torch.as_tensor(counts, dtype=torch.int64,
                                device=self.device))

    def _admit(self, req: Request, t_admit: float) -> None:
        s = self.n_active
        # a resumed request keeps its timeline (TTFT, queue wait and E2E
        # stay anchored at its first submission); a request admitted
        # without run() has no queue wait
        tl = self._timing.get(req.rid)
        resumed = tl is not None
        if tl is None:
            tl = RequestTimeline(submit=self._submit.pop(req.rid, t_admit),
                                 admit=t_admit)
            self._timing[req.rid] = tl
        # a resume without its KV replays prompt + out[:-1] (out[-1] seeds
        # the next decode); greedy decoding recomputes the same KV
        if req.out:
            seq = np.concatenate([np.asarray(req.prompt, np.int64),
                                  np.asarray(req.out[:-1], np.int64)]
                                 ).astype(np.int32)
        else:
            seq = np.asarray(req.prompt, np.int32)
        if self.paged:
            park = self._parked.pop(req.rid, None)
            if park is not None and self.kv.resume_slot(s, req.rid):
                # the parked table back on the slot: nothing recomputed
                self.pos[s] = park["pos"]
                self._prefill_next[s] = park["prefill_next"]
                self._prefix_hit[s] = park["prefix_hit"]
                self._prefill_forwards[s] = park["prefill_forwards"]
                self._seq[s] = park["seq"]
            else:
                # capacity governs, not the block-rounded table size
                limit = min(self.capacity,
                            self.kv.blocks_per_slot * self.kv.block_size)
                if len(seq) > limit:
                    raise ValueError(f"prompt of {len(seq)} tokens exceeds "
                                     f"slot capacity {limit}")
                n_cached = self.kv.attach_prefix(s, seq)
                self.pos[s] = n_cached
                self._prefill_next[s] = n_cached
                self._prefix_hit[s] = n_cached
                self._prefill_forwards[s] = 0
                self._seq[s] = seq
            self._last_aux[req.rid] = {}
        else:
            if len(seq) >= self.capacity:
                raise ValueError(f"prompt of {len(seq)} tokens does not "
                                 f"fit slot capacity {self.capacity}")
            toks = torch.as_tensor(seq.astype(np.int64),
                                   device=self.device)[None]
            seeds, counters = self.draw_keys([req], [0])
            with self.obs.tracer.span("serve/prefill", rid=req.rid,
                                      prompt_tokens=len(seq)):
                tok, self.cache, aux = slot_prefill(
                    self.model, self.cfg, self.rc, self.cache, toks, s,
                    seeds=seeds, counters=counters, sampling=self.sampling,
                    obs=self.obs, shapes=self._step_shapes)
                self.n_forwards += 1
                first = int(tok[0])              # the prefill's transfer
            self.pos[s] = len(seq)
            self._last_aux[req.rid] = aux
            self._seq[s] = seq
        self.active[s] = req
        self.n_active += 1
        if not self.paged and not resumed:
            # a replay's output re-predicts out[-1]: never emitted again
            self._emit(req, first, self._clock())
        if resumed:
            self.n_resumed += 1
            self.obs.metrics.inc("serve/resumed")
            self.obs.tracer.instant("serve/resume", rid=req.rid, slot=s)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One forward over every active slot; returns the number of token
        rows it processed (0 when idle)."""
        t0 = self._clock()
        n = self._step_paged() if self.paged else self._step_contig()
        if n:
            dt = self._clock() - t0
            self._ewma_step_s = dt if self._ewma_step_s is None \
                else 0.7 * self._ewma_step_s + 0.3 * dt
        return n

    def step_time_estimate(self) -> float:
        """Expected seconds per engine step, what the ``slo`` policy prices
        TTFT/TPOT feasibility with: ``step_time_hint`` when set, else the
        measured EWMA (0.0 before the first step)."""
        if self.step_time_hint is not None:
            return self.step_time_hint
        return self._ewma_step_s or 0.0

    # -- paged ---------------------------------------------------------
    def assemble(self) -> PagedBatch:
        """The next paged step's rows: per active slot its decode token, or
        the next chunk of its prompt (or of its replay); allocates the
        blocks they write."""
        rows = []
        last_pos: Dict[int, int] = {}
        for s in range(self.n_active):
            r = self.active[s]
            seq = self._seq[s]
            nx, P = int(self._prefill_next[s]), len(seq)
            if nx < P:
                for j in range(min(self.prefill_chunk, P - nx)):
                    # the last prompt token seeds the first output; a
                    # replay's outputs exist already, so it emits nothing
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
        seeds, counters = self.draw_keys(
            [self.active[s] for s, *_ in rows],
            [len(self.active[s].out) if k == "decode" else 0
             for s, _, _, k in rows])
        return PagedBatch(
            rows=rows,
            tokens=torch.as_tensor([[t] for _, t, _, _ in rows],
                                   dtype=torch.int64, device=dev),
            pos=torch.as_tensor([p for _, _, p, _ in rows],
                                dtype=torch.int32, device=dev),
            tables=torch.as_tensor(self.kv.table_rows([s for s, *_ in rows]),
                                   dtype=torch.int32, device=dev),
            eos=torch.as_tensor(eos, dtype=torch.int32, device=dev),
            seeds=seeds, counters=counters)

    def _step_paged(self) -> int:
        n = self.n_active
        if n == 0:
            return 0
        obs, i_step = self.obs, self._step_idx
        obs.step_begin(i_step)
        with obs.tracer.span("serve/step", step=i_step, active=n):
            with obs.tracer.span("serve/assemble"):
                batch = self.assemble()
            with obs.tracer.span("serve/forward", tokens=len(batch.rows)):
                tok, eos_hit, self.kv.pools, aux = paged_step(
                    self.model, self.cfg, self.rc, self.kv.pools,
                    batch.tokens, batch.pos, batch.tables, batch.eos,
                    seeds=batch.seeds, counters=batch.counters,
                    sampling=self.sampling, obs=obs,
                    shapes=self._step_shapes)
                self.n_forwards += 1
            with obs.tracer.span("serve/host_sync"):     # the one transfer
                host = torch.stack([tok, eos_hit.to(torch.int32)]
                                   ).cpu().numpy()
            # one stamp for every token of the step (one forward made them)
            t_now = self._clock()
            with obs.tracer.span("serve/postprocess"):
                decode_row: Dict[int, int] = {}
                chunks = np.zeros(n, np.int64)
                for i, (s, _, _, kind) in enumerate(batch.rows):
                    r = self.active[s]
                    self._last_aux[r.rid] = aux
                    if kind == "decode":
                        self._emit(r, int(host[0, i]), t_now)
                        self.pos[s] += 1
                        decode_row[s] = i
                    else:
                        chunks[s] += 1
                        if kind == "final":       # prompt complete: 1st token
                            self._emit(r, int(host[0, i]), t_now)
                for s in np.nonzero(chunks)[0]:
                    self._prefill_next[s] += chunks[s]
                    self.pos[s] += chunks[s]
                    self._prefill_forwards[s] += 1
                    self.kv.register_filled(int(s), self._seq[s],
                                            int(self._prefill_next[s]))
                self.last_step = (len(decode_row),
                                  len(batch.rows) - len(decode_row))
                # retire top-down so compaction (move-last-into-freed)
                # never moves a slot still to be examined
                for s in range(n - 1, -1, -1):
                    if s not in decode_row:
                        continue
                    r = self.active[s]
                    if bool(host[1, decode_row[s]]) \
                            or len(r.out) >= r.max_new \
                            or self.pos[s] >= self.capacity - 1:
                        self._retire(s, decode_batch=len(decode_row))
        self._end_step(i_step, tokens=len(batch.rows))
        return len(batch.rows)

    def _end_step(self, i_step: int, *, tokens: int) -> None:
        """Close the step's bracket: straggler window, per-step counters,
        the pool's occupancy gauges."""
        obs = self.obs
        obs.step_end(i_step)
        self._step_idx += 1
        if obs.enabled:
            obs.metrics.inc("serve/steps")
            obs.metrics.inc("serve/step_tokens", tokens)
            if self.paged:
                st = self.kv.stats()
                for k in ("blocks_total", "blocks_in_use", "blocks_parked"):
                    obs.metrics.set_gauge(f"kv/{k}", st[k])

    # -- contiguous ----------------------------------------------------
    def _step_contig(self) -> int:
        n = self.n_active
        if n == 0:
            return 0
        obs, i_step = self.obs, self._step_idx
        obs.step_begin(i_step)
        with obs.tracer.span("serve/step", step=i_step, active=n):
            with obs.tracer.span("serve/assemble"):
                reqs = self.active[:n]
                dev = self.device
                last = torch.as_tensor([[r.out[-1]] for r in reqs],
                                       dtype=torch.int64, device=dev)
                pos = torch.as_tensor(self.pos[:n], dtype=torch.int32,
                                      device=dev)
                eos = torch.as_tensor([-1 if r.eos is None else r.eos
                                       for r in reqs],
                                      dtype=torch.int32, device=dev)
                seeds, counters = self.draw_keys(
                    reqs, [len(r.out) for r in reqs])
            with obs.tracer.span("serve/forward", tokens=n):
                tok, eos_hit, self.cache, aux = slot_decode(
                    self.model, self.cfg, self.rc, self.cache, last, pos,
                    eos, seeds=seeds, counters=counters,
                    sampling=self.sampling, obs=obs,
                    shapes=self._step_shapes)
                self.n_forwards += 1
            with obs.tracer.span("serve/host_sync"):     # the one transfer
                host = torch.stack([tok, eos_hit.to(torch.int32)]
                                   ).cpu().numpy()
            t_now = self._clock()
            with obs.tracer.span("serve/postprocess"):
                for s, r in enumerate(reqs):
                    self._emit(r, int(host[0, s]), t_now)
                    self.pos[s] += 1
                    self._last_aux[r.rid] = aux
                self.last_step = (n, 0)
                # retire top-down so the swap-with-last compaction never
                # moves a slot still to be examined
                for s in range(n - 1, -1, -1):
                    r = self.active[s]
                    if bool(host[1, s]) or len(r.out) >= r.max_new \
                            or self.pos[s] >= self.capacity - 1:
                        self._retire(s, decode_batch=n)
        self._end_step(i_step, tokens=n)
        return n

    # ------------------------------------------------------------------
    def _retire(self, s: int, *, decode_batch: int) -> None:
        """Free slot ``s``: the request's stats, then compaction.  The
        final step's aux leaves the device in one transfer."""
        req = self.active[s]
        aux = self._last_aux.pop(req.rid)
        req.stats = {}
        if aux:
            vals = torch.stack([v.double() for v in aux.values()]
                               ).cpu().tolist()
            req.stats = dict(zip(aux.keys(), vals))
        req.stats["serve/decode_batch"] = float(decode_batch)
        if self.paged:
            req.stats["serve/prefix_hit_tokens"] = float(self._prefix_hit[s])
            req.stats["serve/prefill_forwards"] = \
                float(self._prefill_forwards[s])
            self.kv.release_slot(s)
        else:
            req.stats["serve/prefix_hit_tokens"] = 0.0
            req.stats["serve/prefill_forwards"] = 1.0
        self._compact(s)
        tl = self._timing.pop(req.rid, None)
        if tl is not None:
            req.stats.update(tl.finalize(end=self._clock()))
        req.done = True
        obs = self.obs
        obs.tracer.instant("serve/retire", rid=req.rid)
        if obs.enabled:
            m = obs.metrics
            m.inc("serve/completed")
            for key in ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s"):
                if f"lat/{key}" in req.stats:
                    m.observe(f"serve/{key}", req.stats[f"lat/{key}"])
            if req.slo_ttft is not None \
                    and req.stats.get("lat/ttft_s", 0.0) > req.slo_ttft:
                m.inc("serve/slo_ttft_miss")
            if req.slo_tpot is not None \
                    and req.stats.get("lat/tpot_s", 0.0) > req.slo_tpot:
                m.inc("serve/slo_tpot_miss")
            m.observe_many("", {k: v for k, v in req.stats.items()
                                if k.startswith("sched/")})
            # under EP the drops of the exchange keep their own counter
            if self.rc.ep and "sched/dropped_rows" in req.stats:
                m.inc("serve/ep_dropped_tokens",
                      int(req.stats["sched/dropped_rows"]))

    def _compact(self, s: int) -> None:
        """Vacate slot ``s`` keeping the active prefix contiguous (paged: a
        host-side table move; contiguous: a device row swap).  The slot's
        KV must already be released or parked."""
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

    def preempt(self, s: int) -> Request:
        """Take the request in slot ``s`` out mid-flight.  It keeps
        ``done=False`` and its partial ``out``; the paged engine parks its
        block table under its rid, the contiguous engine drops its cache
        row (the resume replays prompt + generated tokens).  A censored
        ``lat/*`` snapshot lands in ``Request.stats`` at once, so a victim
        that never resumes still reports finite latencies."""
        if not (0 <= s < self.n_active):
            raise ValueError(f"no active request in slot {s} "
                             f"(n_active={self.n_active})")
        req = self.active[s]
        t_now = self._clock()
        if self.paged:
            self._parked[req.rid] = {
                "pos": int(self.pos[s]),
                "prefill_next": int(self._prefill_next[s]),
                "prefix_hit": int(self._prefix_hit[s]),
                "prefill_forwards": int(self._prefill_forwards[s]),
                "seq": self._seq[s],
            }
            self.kv.park_slot(s, req.rid)
        self._compact(s)
        self._last_aux.pop(req.rid, None)
        # the timeline stays keyed, so a resume keeps the submit anchor
        tl = self._timing.get(req.rid)
        if tl is not None:
            req.stats = dict(tl.finalize(end=t_now))
            req.stats["serve/preempted"] = 1.0
        self.n_preempted += 1
        self.obs.metrics.inc("serve/preempted")
        self.obs.tracer.instant("serve/preempt", rid=req.rid, slot=s,
                                decode_tokens=len(req.out))
        return req

    def enqueue(self, requests: List[Request]) -> List[Request]:
        """Stamp submit times and return the requests eligible for
        admission (not done, not in a slot).  A resubmitted request keeps
        its first submit time."""
        live = {id(r) for r in self.active if r is not None}
        pending = [r for r in requests if not r.done and id(r) not in live]
        t_submit = self._clock()
        for r in pending:
            self._submit.setdefault(r.rid, t_submit)
        return pending

    def schedule(self, pending: List[Request]) -> None:
        """One scheduling pass: the admission policy's ``preempt`` hook,
        where it has one, picks slots to preempt (their requests rejoin
        ``pending``), then free slots are filled from ``pending`` (mutated
        in place) in the policy's order."""
        pre = getattr(self._admission, "preempt", None)
        if pre is not None and pending:
            for s in sorted(pre(self, pending), reverse=True):
                pending.append(self.preempt(s))
        while pending and self.n_active < self.slots:
            self.admit(pending.pop(self._admission(pending, engine=self)))

    def run(self, requests: List[Request], max_steps: int = 512):
        """Schedule and step until every request is done or the step budget
        runs out.  Returns the completed requests in submission order;
        unfinished ones keep ``done=False`` with their partial ``out`` and
        a censored ``lat/*`` snapshot, and are kept in ``self.dropped``.  A
        later ``run`` may resume them."""
        pending = self.enqueue(requests)
        self.dropped = []
        for _ in range(max_steps):
            self.schedule(pending)
            if self.step() == 0 and not pending:
                break
        self.dropped = [r for r in requests if not r.done]
        if self.dropped:
            self.finalize_drops(self.dropped)
            self.obs.metrics.inc("serve/dropped", len(self.dropped))
            self.obs.tracer.instant("serve/step_budget_exhausted",
                                    dropped=len(self.dropped))
        return [r for r in requests if r.done]

    def finalize_drops(self, requests: List[Request]) -> None:
        """Give every unfinished request a finite censored ``lat/*``
        snapshot (clocks stopped now) marked ``serve/dropped``; a later
        resume and retirement overwrites it."""
        t_now = self._clock()
        for r in requests:
            if r.done:
                continue
            tl = self._timing.get(r.rid)
            if tl is None:      # never admitted: pure queue wait
                tl = RequestTimeline(
                    submit=self._submit.get(r.rid, t_now), admit=t_now)
            stats = dict(tl.finalize(end=t_now))
            stats["serve/dropped"] = 1.0
            if r.stats.get("serve/preempted"):
                stats["serve/preempted"] = 1.0
            r.stats = stats

    def describe(self, *, seed=None) -> dict:
        """The engine's configuration, one flat dict (for a results row)."""
        d = {"arch": self.cfg.name, "slots": self.slots,
             "capacity": self.capacity, "admission": self._admission_name,
             "executor": self.rc.executor,
             "schedule_policy": self.rc.schedule_policy,
             "quant": self.rc.quant, "kv_block_size": self.kv_block_size,
             "prefill_chunk": self.prefill_chunk if self.paged else 0,
             "paged_attn": self.rc.paged_attn,
             "autotune": self.rc.autotune,
             "sampling": self.sampling.method,
             "temperature": self.sampling.temperature,
             "sampling_seed": self.sampling.seed}
        if seed is not None:
            d["seed"] = seed
        return d
