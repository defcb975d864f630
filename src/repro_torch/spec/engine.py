"""Speculative decoding on the paged engine (counterpart of
``repro.spec.engine``): a draft model proposes, the target verifies k + 1
positions a slot in one forward.

``SpecEngine`` is a ``ServeEngine`` whose steady-state decode step is a
speculative round; admission, chunked prefill, the prefix cache,
preemption and retirement are the base engine's:

1. **Draft.**  The draft model (its own weights and its own
   ``PagedKVCache`` over the same slots) chains k one-token proposal steps
   for every active slot, with no host transfer between them
   (``serve/step.spec_draft_step``).
2. **Verify.**  The target scores the n * (k + 1) rows (each slot's last
   emitted token and its k proposals, at positions pos .. pos + k) in one
   forward, the many-rows-a-slot form of a chunk step: every MoE layer
   builds one plan for the whole sweep.  The accept/reject arithmetic
   runs on the device; the round makes one host transfer.
3. **Rollback.**  The accepted prefix and the bonus token are emitted, and
   both pools are truncated to the new length
   (``PagedKVCache.truncate_slot``): host bookkeeping.  Rows past the new
   length are stale, masked by the next reads' kv limits, and overwritten
   by the next writes.

**Draft state** is derived: ``_dnext[s]`` counts the leading positions of
slot s that the draft has processed, and ``_draft_catch_up`` feeds the
draft any gap [_dnext, pos) through the ordinary paged step, in chunks as
prefill.  That one mechanism covers the draft's prompt prefill, mirroring
after a base step, and resumption after preemption, which releases the
draft's table (the target's parks).

With greedy sampling the emitted tokens are those of the plain engine for
any draft: each accepted or bonus token is the target's argmax at its
output index.  Stochastic sampling is rejection sampling against the draft
distribution, keyed as the reference's, so a seed gives the reference's
tokens."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.models.lm import LM
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.step import (paged_step, spec_draft_step,
                                    spec_verify_step)


def make_draft_config(target_cfg: ModelConfig, base: str = "smollm-360m",
                      *, reduce: bool = False, layers: int = 2,
                      d_model: int = 128) -> ModelConfig:
    """A draft config with ``target_cfg``'s vocabulary (rejection sampling
    compares the two distributions token for token).  ``reduce=True``
    shrinks the draft for CPU runs."""
    cfg = get_config(base)
    if reduce:
        cfg = reduced(cfg, layers=layers, d_model=d_model,
                      vocab=target_cfg.vocab_size)
    return cfg.replace(vocab_size=target_cfg.vocab_size)


class SpecEngine(ServeEngine):
    """``ServeEngine`` with draft-propose / target-verify / rollback
    rounds."""

    def __init__(self, cfg: ModelConfig, model: LM, *,
                 draft_cfg: ModelConfig, draft_model: LM, spec_k: int = 4,
                 **kw):
        prefix_cache = kw.get("prefix_cache", True)
        super().__init__(cfg, model, **kw)
        if not self.paged:
            raise ValueError(
                "speculative decoding needs the paged engine (rollback is "
                "a block-table truncation); got a contiguous cache: pass "
                "kv_block_size > 0")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}; rejection sampling compares the two "
                "distributions per token id (make_draft_config aligns them)")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft_model.embed.device.type != self.device.type:
            raise ValueError(f"draft model on {draft_model.embed.device}, "
                             f"engine on {self.device}")
        self.spec_k = spec_k
        self.draft_cfg = draft_cfg
        self.draft_model = draft_model
        # the draft never quantizes and never collects plan stats
        self.drc = self.rc._replace(quant="none", moe_stats=False)
        self.dkv = PagedKVCache(draft_cfg, self.slots, self.capacity,
                                self.kv_block_size,
                                prefix_cache=prefix_cache,
                                dtype=self.drc.compute_dtype,
                                device=self.device)
        self.dkv.bind_obs(self.obs.metrics, self.obs.tracer)
        # the draft's step shapes (its catch-up and proposal steps are
        # functions of their own, as the reference's separate jits)
        self._draft_shapes: set = set()
        # leading positions of slot s whose tokens the draft has processed
        self._dnext = np.zeros(self.slots, np.int64)
        self.n_spec_rounds = 0
        self.n_drafted = 0
        self.n_accepted = 0
        self.n_draft_forwards = 0

    # ------------------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        """Accepted draft tokens / drafted tokens (1.0 before the first
        round)."""
        return self.n_accepted / self.n_drafted if self.n_drafted else 1.0

    def describe(self, *, seed=None) -> dict:
        d = super().describe(seed=seed)
        d["spec_k"] = self.spec_k
        d["spec_draft"] = self.draft_cfg.name
        return d

    # -- slot lifecycle ------------------------------------------------
    def _admit(self, req, t_admit) -> None:
        super()._admit(req, t_admit)
        s = self.n_active - 1
        # the draft's prefix probe mirrors the target's; on a cold cache
        # it is 0 and catch-up prefills the draft in chunks
        self._dnext[s] = self.dkv.attach_prefix(s, self._seq[s])

    def _retire(self, s: int, *, decode_batch: int) -> None:
        self.dkv.release_slot(s)
        super()._retire(s, decode_batch=decode_batch)

    def preempt(self, s: int):
        # the draft's KV is derived: released, re-derived on resume
        self.dkv.release_slot(s)
        return super().preempt(s)

    def _compact(self, s: int) -> None:
        last = self.n_active - 1
        if s != last:
            self.dkv.move_slot(s, last)
            self._dnext[s] = self._dnext[last]
        self._dnext[last] = 0
        super()._compact(s)

    # -- draft bookkeeping ---------------------------------------------
    def _full_tokens(self, s: int) -> np.ndarray:
        """Tokens at positions [0, pos[s]] of slot s: the prefill source,
        then the outputs past it."""
        seq = np.asarray(self._seq[s], np.int64)
        t = int(self.pos[s]) + 1 - len(seq)
        if t <= 0:
            return seq[:int(self.pos[s]) + 1]
        out = np.asarray(self.active[s].out[-t:], np.int64)
        return np.concatenate([seq, out])

    def _draft_catch_up(self) -> None:
        """Feed the draft every position the target is ahead by
        ([_dnext, pos) a slot), in chunks of ``prefill_chunk``; a no-op
        when every slot is caught up."""
        dev = self.device
        while True:
            rows = []                              # (slot, token, position)
            for s in range(self.n_active):
                dn, p = int(self._dnext[s]), int(self.pos[s])
                if dn >= p:
                    continue
                full = self._full_tokens(s)
                for j in range(min(self.prefill_chunk, p - dn)):
                    rows.append((s, int(full[dn + j]), dn + j))
            if not rows:
                return
            with self.obs.tracer.span("serve/spec_catch_up",
                                      tokens=len(rows)):
                last = {}
                for s, _, p in rows:
                    last[s] = max(last.get(s, -1), p)
                for s, p in last.items():
                    self.dkv.ensure_allocated(s, p)
                tables = torch.as_tensor(
                    self.dkv.table_rows([r[0] for r in rows]),
                    dtype=torch.int32, device=dev)
                toks = torch.as_tensor([[t] for _, t, _ in rows],
                                       dtype=torch.int64, device=dev)
                pos = torch.as_tensor([p for _, _, p in rows],
                                      dtype=torch.int32, device=dev)
                eos = torch.full((len(rows),), -1, dtype=torch.int32,
                                 device=dev)
                # KV only: the step's token pick is discarded, so it
                # takes the argmax whatever the sampling method
                _t, _e, self.dkv.pools, _a = paged_step(
                    self.draft_model, self.draft_cfg, self.drc,
                    self.dkv.pools, toks, pos, tables, eos, obs=self.obs,
                    shapes=self._draft_shapes)
                self.n_draft_forwards += 1
            for s in last:
                self._dnext[s] += sum(1 for sl, _, _ in rows if sl == s)
                seq = np.asarray(self._seq[s])
                self.dkv.register_filled(
                    s, seq, min(int(self._dnext[s]), len(seq)))

    def _spec_ready(self) -> bool:
        """A round covers every active slot (one verify batch, one plan):
        only when all are in steady decode with room for k + 1 more
        positions and the draft caught up."""
        if self.n_active == 0:
            return False
        for s in range(self.n_active):
            r = self.active[s]
            if not r.out or int(self._prefill_next[s]) < len(self._seq[s]):
                return False                      # still prefilling
            if int(self.pos[s]) + self.spec_k + 1 >= self.capacity:
                return False                      # no room to speculate
            if int(self._dnext[s]) != int(self.pos[s]):
                return False                      # draft not caught up
        return True

    # -- the speculative round -----------------------------------------
    def step(self) -> int:
        if self.n_active == 0:
            return 0
        self._draft_catch_up()
        if not self._spec_ready():
            return super().step()
        t0 = self._clock()
        n = self._step_spec()
        if n:
            dt = self._clock() - t0
            self._ewma_step_s = dt if self._ewma_step_s is None \
                else 0.7 * self._ewma_step_s + 0.3 * dt
        return n

    def spec_inputs(self) -> dict:
        """The round's host-side preparation: both pools grown for the
        positions it writes (target pos .. pos + k, draft pos .. pos + k -
        1: the k-th proposal is never fed back), then every input the
        device part needs, copied to the device here."""
        n, k, dev = self.n_active, self.spec_k, self.device
        reqs = self.active[:n]
        pos0 = self.pos[:n].astype(np.int64).copy()
        for s in range(n):
            self.kv.ensure_allocated(s, int(pos0[s]) + k)
            self.dkv.ensure_allocated(s, int(pos0[s]) + k - 1)
        last = [[r.out[-1]] for r in reqs]
        vtables = np.repeat(self.kv.table_rows(list(range(n))), k + 1,
                            axis=0)
        seeds, counters = self.draw_keys(reqs, [len(r.out) for r in reqs])
        return {
            "seeds": seeds, "counters": counters,
            "pos0": pos0,
            "last": torch.as_tensor(last, dtype=torch.int64, device=dev),
            "dpos": torch.as_tensor(pos0[None, :] + np.arange(k)[:, None],
                                    dtype=torch.int32, device=dev),
            "dtables": torch.as_tensor(self.dkv.table_rows(list(range(n))),
                                       dtype=torch.int32, device=dev),
            "vpos": torch.as_tensor(
                (pos0[:, None] + np.arange(k + 1)[None, :]).reshape(-1),
                dtype=torch.int32, device=dev),
            "vtables": torch.as_tensor(vtables, dtype=torch.int32,
                                       device=dev),
        }

    def spec_device(self, inp: dict):
        """The round's device part, with no host transfer: k chained draft
        steps, then the one verify forward over n * (k + 1) rows.  Returns
        (emitted (n, k + 1), n_emit (n,), aux) on the device."""
        n, k, obs = self.n_active, self.spec_k, self.obs
        seeds, counters = inp["seeds"], inp["counters"]
        with obs.tracer.span("serve/spec_draft", proposals=n * k):
            cur = inp["last"]
            dtoks, qdists = [], []
            for t in range(k):
                tok, q, self.dkv.pools, _ = spec_draft_step(
                    self.draft_model, self.draft_cfg, self.drc,
                    self.dkv.pools, cur, inp["dpos"][t], inp["dtables"],
                    seeds, None if counters is None else counters + t,
                    sampling=self.sampling, obs=obs,
                    shapes=self._draft_shapes)
                dtoks.append(tok)
                qdists.append(q)
                cur = tok[:, None].to(torch.int64)
                self.n_draft_forwards += 1
            draft_tok = torch.stack(dtoks, dim=1)              # (n, k)
            draft_q = (None if qdists[0] is None
                       else torch.stack(qdists, dim=1))        # (n, k, V)
        with obs.tracer.span("serve/spec_verify", tokens=n * (k + 1)):
            vtok = torch.cat([inp["last"], draft_tok.to(torch.int64)],
                             dim=1).reshape(n * (k + 1), 1)
            emitted, n_emit, self.kv.pools, aux = spec_verify_step(
                self.model, self.cfg, self.rc, self.kv.pools, vtok,
                inp["vpos"], inp["vtables"], draft_tok, draft_q, seeds,
                counters, k=k, sampling=self.sampling, obs=obs,
                shapes=self._step_shapes)
            self.n_forwards += 1
        return emitted, n_emit, aux

    def _step_spec(self) -> int:
        n, k = self.n_active, self.spec_k
        obs, i_step = self.obs, self._step_idx
        obs.step_begin(i_step)
        reqs = self.active[:n]
        with obs.tracer.span("serve/step", step=i_step, active=n,
                             spec_k=k):
            inp = self.spec_inputs()
            pos0 = inp["pos0"]
            emitted, n_emit, aux = self.spec_device(inp)
            with obs.tracer.span("serve/host_sync"):     # the one transfer
                host = torch.cat([emitted, n_emit.to(torch.int32)[:, None]],
                                 dim=1).cpu().numpy()
            t_now = self._clock()
            with obs.tracer.span("serve/postprocess"):
                acc_round = 0
                for s in range(n):
                    r = reqs[s]
                    self._last_aux[r.rid] = aux
                    ne, m = int(host[s, k + 1]), 0
                    for j in range(ne):
                        if len(r.out) >= r.max_new:
                            break
                        tok = int(host[s, j])
                        self._emit(r, tok, t_now)
                        m += 1
                        if r.eos is not None and tok == r.eos:
                            break
                    # rollback: both pools cut back to the new length
                    new_pos = int(pos0[s]) + m
                    self.pos[s] = new_pos
                    self.kv.truncate_slot(s, new_pos)
                    dn = min(int(pos0[s]) + k, new_pos)
                    self.dkv.truncate_slot(s, dn)
                    self._dnext[s] = dn
                    self.n_drafted += k
                    acc_round += max(0, min(m, ne - 1))
                self.n_accepted += acc_round
                self.n_spec_rounds += 1
                if obs.enabled:
                    obs.metrics.inc("spec/rounds")
                    obs.metrics.inc("spec/drafted", n * k)
                    obs.metrics.inc("spec/accepted", acc_round)
                    obs.metrics.set_gauge("spec/acceptance_rate",
                                          self.acceptance_rate)
                # retire top-down so compaction never moves an unexamined
                # slot; the emit loop stopped at EOS and max_new
                for s in range(n - 1, -1, -1):
                    r = self.active[s]
                    if (r.eos is not None and r.out and r.out[-1] == r.eos) \
                            or len(r.out) >= r.max_new \
                            or self.pos[s] >= self.capacity - 1:
                        self._retire(s, decode_batch=n)
        self._end_step(i_step, tokens=n * (k + 1))
        return n * (k + 1)
