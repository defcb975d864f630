"""Paged KV cache: a block pool on the device and per-slot block tables
(counterpart of ``repro.serve.kv_cache``).

The pool is a list with one ``{"k", "v"}`` pair of (n_blocks, block_size,
Hkv, D) tensors per layer, in the compute dtype, on an explicit device:
``init_cache`` with (batch=n_blocks, seq=block_size).  Slot s owns table
row s, which maps its logical block ``pos // block_size`` to a physical
block.  The forward pass writes through the table in place
(``models/attention.scatter_block_rows``) and reads through it with the
paged-attention kernel or ``gather_block_kv``.

The control plane is host-side numpy, as in the reference: tables,
allocation counts, refcounts, the free list, the chained-hash prefix index
and the LRU pool of cached free blocks.  It runs once per engine step over
a handful of ints; the forward sees only dense int32 table rows.

**Prefix caching.**  Full prompt blocks are content-addressed by a chained
hash (block i's digest covers tokens [0, (i+1) * block_size)), so a hit
means the whole prefix matches.  Hit blocks are attached to the new slot's
table and refcounted; their tokens are never recomputed.  Only full prompt
blocks are shared, so shared blocks are immutable.  A block whose refcount
falls to 0 and that carries a hash parks in the LRU cached-free pool and is
evicted only when the free list is empty.

**Invariant.**  ``n_blocks = slots * ceil(capacity / block_size)``: the
worst case (no sharing) is the contiguous layout's footprint, so
allocation cannot fail.

**Parking (preemption).**  ``park_slot`` detaches a preempted request's
table under its rid with its refcounts kept, so its KV survives for a
host-side resume (``resume_slot``).  Under pool pressure ``_alloc_block``
reclaims the least recently parked table before it evicts a cached block;
that request's resume then replays its tokens.  ``truncate_slot`` rolls a
slot back to a shorter length (speculative decoding's rollback).

Pool events (allocations, evictions, prefix probes, compactions, parks)
feed the ``kv/*`` counters and instants of an ``Observability`` bundle
bound with ``bind_obs`` (null sinks by default).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import group_structure, init_cache
from repro_torch.obs import NULL_METRICS, NULL_TRACER

# block kinds whose caches are positional KV rows, the only thing a pool
# can page
PAGED_KINDS = frozenset(
    {"attn", "attn_local", "attn_global", "moe", "moe_dense"})


def paged_supported(cfg: ModelConfig) -> bool:
    """True when every layer's cache is positional KV (pageable)."""
    prefix, body, _, suffix = group_structure(cfg)
    return all(k in PAGED_KINDS for k in (*prefix, *body, *suffix))


def _chain_digest(prev: bytes, block_tokens: np.ndarray) -> bytes:
    """Chained content hash: covers the whole prefix up to this block."""
    return hashlib.sha256(prev + np.ascontiguousarray(
        block_tokens.astype(np.int32)).tobytes()).digest()


class PagedKVCache:
    """Block pool + per-slot tables + refcounted prefix index."""

    def __init__(self, cfg: ModelConfig, slots: int, capacity: int,
                 block_size: int, *, prefix_cache: bool = True,
                 dtype=torch.float32, device="cuda"):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        if not paged_supported(cfg):
            raise ValueError(f"{cfg.name!r} has non-pageable layer caches; "
                             "use the contiguous engine (kv_block_size=0)")
        self.cfg = cfg
        self.slots = slots
        self.capacity = capacity
        self.block_size = block_size
        self.blocks_per_slot = -(-capacity // block_size)
        self.n_blocks = slots * self.blocks_per_slot
        self.device = resolve_device(device)
        self.pools = init_cache(cfg, self.n_blocks, block_size, dtype=dtype,
                                device=self.device)
        self.tables = np.zeros((slots, self.blocks_per_slot), np.int32)
        self.n_alloc = np.zeros(slots, np.int32)       # allocated entries
        self.refcount = np.zeros(self.n_blocks, np.int64)
        self.free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self.prefix_cache = prefix_cache
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        # refcount-0 blocks with preserved contents, LRU eviction order
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        # per-slot cursor for registering blocks as they fill:
        # (next block index to register, digest of the chain before it)
        self._chain: Dict[int, tuple] = {}
        # preempted requests' parked tables (key -> {table, n_alloc,
        # chain}), LRU order: their blocks stay refcounted until the request
        # resumes or allocation pressure reclaims the record
        self._parked: "OrderedDict[object, dict]" = OrderedDict()
        # read-only probe memo: key -> (index generation, cached tokens)
        self._probe_gen = 0
        self._probe_memo: Dict[object, tuple] = {}
        self.hits = self.misses = self.evictions = 0
        self.park_reclaims = 0
        self.hit_tokens = 0
        self._metrics = NULL_METRICS
        self._tracer = NULL_TRACER

    def bind_obs(self, metrics, tracer) -> None:
        """Attach metrics/tracer sinks (the engine binds its bundle).  Pool
        events are host-side control-plane work: instrumenting them adds
        nothing to the forward."""
        self._metrics = metrics
        self._tracer = tracer

    # -- allocation ----------------------------------------------------
    def _index_mutated(self) -> None:
        """The hash index changed: read-only probe results are stale."""
        self._probe_gen += 1
        self._probe_memo.clear()

    def _alloc_block(self) -> int:
        if self.free:
            self._metrics.inc("kv/blocks_allocated")
            return self.free.pop()
        while not self._cached_free and self._parked:
            self._reclaim_parked()       # may refill free or cached_free
            if self.free:
                self._metrics.inc("kv/blocks_allocated")
                return self.free.pop()
        if not self._cached_free:
            raise RuntimeError("paged pool exhausted: broken refcounting "
                               "(n_blocks guarantees worst-case capacity)")
        b, _ = self._cached_free.popitem(last=False)     # evict the LRU
        del self._hash_to_block[self._block_hash.pop(b)]
        self._index_mutated()
        self.evictions += 1
        self._metrics.inc("kv/blocks_allocated")
        self._metrics.inc("kv/evictions")
        self._tracer.instant("kv/evict", block=b)
        return b

    def _release_blocks(self, table: np.ndarray, n_alloc: int) -> None:
        for j in range(n_alloc):
            b = int(table[j])
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                if b in self._block_hash:
                    self._cached_free[b] = None      # park: contents reusable
                else:
                    self.free.append(b)

    def _reclaim_parked(self) -> None:
        """Allocation pressure: give up the least recently parked table so
        that running slots never starve.  Its request finds no record on
        resume and replays its tokens: a latency cost, never a correctness
        one."""
        key, rec = self._parked.popitem(last=False)
        self._release_blocks(rec["table"], rec["n_alloc"])
        self.park_reclaims += 1
        self._metrics.inc("kv/park_reclaims")
        self._tracer.instant("kv/park_reclaim", key=str(key))

    def ensure_allocated(self, slot: int, last_pos: int) -> None:
        """Grow ``slot``'s table so position ``last_pos`` is addressable.
        Positions at or past the slot's addressable capacity get no block:
        their writes are dropped by ``scatter_block_rows``."""
        need = min(last_pos // self.block_size + 1, self.blocks_per_slot)
        while self.n_alloc[slot] < need:
            b = self._alloc_block()
            self.tables[slot, self.n_alloc[slot]] = b
            self.refcount[b] += 1
            self.n_alloc[slot] += 1

    # -- prefix caching ------------------------------------------------
    def attach_prefix(self, slot: int, prompt: np.ndarray) -> int:
        """Attach the longest run of hash-hit full prompt blocks to
        ``slot``; returns the number of cached tokens.  At least one prompt
        token is always left uncached: its logits seed the first output."""
        bs = self.block_size
        prompt = np.asarray(prompt)
        max_full = min((len(prompt) - 1) // bs, self.blocks_per_slot)
        digest = b""
        n_hit = 0
        if self.prefix_cache:
            with self._tracer.span("serve/prefix_probe", slot=slot,
                                   prompt_tokens=len(prompt)):
                for i in range(max_full):
                    nxt = _chain_digest(digest, prompt[i * bs:(i + 1) * bs])
                    b = self._hash_to_block.get(nxt)
                    if b is None:
                        self.misses += 1
                        self._metrics.inc("kv/prefix_misses")
                        break
                    digest = nxt
                    if self.refcount[b] == 0:           # revive a parked block
                        self._cached_free.pop(b)
                    self.refcount[b] += 1
                    self.tables[slot, i] = b
                    self.n_alloc[slot] += 1
                    self.hits += 1
                    self._metrics.inc("kv/prefix_hits")
                    n_hit = i + 1
        self._chain[slot] = (n_hit, digest)
        self.hit_tokens += n_hit * bs
        self._metrics.inc("kv/prefix_hit_tokens", n_hit * bs)
        return n_hit * bs

    def probe_prefix(self, prompt: np.ndarray, *, memo_key=None) -> int:
        """Read-only lookup: how many tokens of ``prompt`` the index can
        serve now (no attach, no refcounts).  ``memo_key`` memoizes the
        answer until the hash index next changes."""
        if not self.prefix_cache:
            return 0
        if memo_key is not None:
            hit = self._probe_memo.get(memo_key)
            if hit is not None and hit[0] == self._probe_gen:
                return hit[1]
        bs = self.block_size
        prompt = np.asarray(prompt)
        max_full = min((len(prompt) - 1) // bs, self.blocks_per_slot)
        digest = b""
        n = 0
        for i in range(max_full):
            digest = _chain_digest(digest, prompt[i * bs:(i + 1) * bs])
            if digest not in self._hash_to_block:
                break
            n = i + 1
        if memo_key is not None:
            self._probe_memo[memo_key] = (self._probe_gen, n * bs)
        return n * bs

    def register_filled(self, slot: int, prompt: np.ndarray,
                        n_processed: int) -> None:
        """Register every newly full prompt block of ``slot``
        (``n_processed`` prompt tokens have their KV written)."""
        if not self.prefix_cache or slot not in self._chain:
            return
        bs = self.block_size
        i, digest = self._chain[slot]
        while (i + 1) * bs <= n_processed:
            digest = _chain_digest(digest, prompt[i * bs:(i + 1) * bs])
            b = int(self.tables[slot, i])
            if digest not in self._hash_to_block:
                self._hash_to_block[digest] = b
                self._block_hash[b] = digest
                self._index_mutated()
            i += 1
        self._chain[slot] = (i, digest)

    def truncate_slot(self, slot: int, n_tokens: int) -> int:
        """Roll ``slot`` back to its first ``n_tokens`` positions, the
        speculative rollback: host bookkeeping only.  Whole blocks past
        ``ceil(n_tokens / block_size)`` are released (a refcount-0 block
        with a hash goes to the cached-free pool, as at retirement).  The
        kept tail block may hold stale rows past ``n_tokens``: reads mask
        them by each row's kv_limit and the next write there overwrites
        them.  A chain cursor past the cut is dropped (digests chain
        forward only), so the slot registers no more blocks.  Returns the
        number of blocks freed."""
        keep = 0 if n_tokens <= 0 else min(-(-n_tokens // self.block_size),
                                           self.blocks_per_slot)
        na = int(self.n_alloc[slot])
        if keep >= na:
            return 0
        self._release_blocks(self.tables[slot, keep:na], na - keep)
        self.tables[slot, keep:na] = 0
        self.n_alloc[slot] = keep
        ch = self._chain.get(slot)
        if ch is not None and ch[0] > keep:
            del self._chain[slot]
        freed = na - keep
        self._metrics.inc("kv/blocks_truncated", freed)
        self._tracer.instant("kv/truncate", slot=slot, n_tokens=n_tokens,
                             freed=freed)
        return freed

    # -- release / park / views ----------------------------------------
    def release_slot(self, slot: int) -> None:
        self._release_blocks(self.tables[slot], int(self.n_alloc[slot]))
        self.tables[slot, :] = 0
        self.n_alloc[slot] = 0
        self._chain.pop(slot, None)

    def park_slot(self, slot: int, key) -> None:
        """Preemption: detach ``slot``'s table into a parked record under
        ``key`` (the request's rid).  Its blocks keep their refcounts, so
        the request's KV survives for a host-side resume; under allocation
        pressure the least recently parked record is reclaimed instead.
        The slot is left empty."""
        self._parked[key] = {"table": self.tables[slot].copy(),
                             "n_alloc": int(self.n_alloc[slot]),
                             "chain": self._chain.get(slot)}
        self.tables[slot, :] = 0
        self.n_alloc[slot] = 0
        self._chain.pop(slot, None)
        self._metrics.inc("kv/tables_parked")
        self._tracer.instant("kv/park", slot=slot, key=str(key))

    def resume_slot(self, slot: int, key) -> bool:
        """Re-attach the table parked under ``key`` to the empty ``slot``.
        False when the record was reclaimed: the caller replays instead."""
        rec = self._parked.pop(key, None)
        if rec is None:
            return False
        if self.n_alloc[slot] != 0:
            raise ValueError(f"resume target slot {slot} is not empty")
        self.tables[slot] = rec["table"]
        self.n_alloc[slot] = rec["n_alloc"]
        if rec["chain"] is not None:
            self._chain[slot] = rec["chain"]
        self._metrics.inc("kv/tables_resumed")
        self._tracer.instant("kv/resume", slot=slot, key=str(key))
        return True

    def drop_parked(self, key) -> None:
        """Discard a parked record (the request will never resume)."""
        rec = self._parked.pop(key, None)
        if rec is not None:
            self._release_blocks(rec["table"], rec["n_alloc"])

    def move_slot(self, dst: int, src: int) -> None:
        """Host-side slot compaction: moving a request between slots is two
        numpy row writes."""
        self.tables[dst] = self.tables[src]
        self.n_alloc[dst] = self.n_alloc[src]
        if src in self._chain:
            self._chain[dst] = self._chain.pop(src)
        elif dst in self._chain:
            del self._chain[dst]
        self.tables[src] = 0
        self.n_alloc[src] = 0
        self._metrics.inc("kv/compactions")
        self._tracer.instant("kv/compaction", src=src, dst=dst)

    def table_rows(self, slot_ids) -> np.ndarray:
        """(len(slot_ids), blocks_per_slot) int32 rows for a step batch."""
        return self.tables[np.asarray(slot_ids, np.int64)]

    # -- metamorphic helper (tests) ------------------------------------
    def permute_physical_blocks(self, perm) -> None:
        """Relabel physical block ids: block ``b`` becomes ``perm[b]``.  The
        pool's contents move with their ids and every host structure is
        remapped, so greedy tokens must not change."""
        perm = np.asarray(perm, np.int64)
        assert sorted(perm.tolist()) == list(range(self.n_blocks))
        inv = torch.as_tensor(np.argsort(perm), device=self.device)
        for layer in self.pools:
            for key, t in layer.items():
                layer[key] = t.index_select(0, inv)
        self.tables = perm[self.tables].astype(np.int32)
        self.refcount = self.refcount[np.argsort(perm)]
        self.free = [int(perm[b]) for b in self.free]
        self._hash_to_block = {h: int(perm[b])
                               for h, b in self._hash_to_block.items()}
        self._block_hash = {int(perm[b]): h
                            for b, h in self._block_hash.items()}
        self._cached_free = OrderedDict(
            (int(perm[b]), None) for b in self._cached_free)
        for rec in self._parked.values():
            rec["table"] = perm[rec["table"]].astype(np.int32)

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        return {"blocks_total": self.n_blocks,
                "blocks_in_use": int((self.refcount > 0).sum()),
                "blocks_parked": len(self._cached_free),
                "prefix_hits": self.hits, "prefix_misses": self.misses,
                "prefix_hit_tokens": self.hit_tokens,
                "evictions": self.evictions,
                "parked_tables": len(self._parked),
                "park_reclaims": self.park_reclaims}
