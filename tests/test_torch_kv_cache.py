"""The port's ``PagedKVCache`` against ``repro.serve.kv_cache.PagedKVCache``:
the same sequence of calls (prefix attach and probe, allocation, block
registration, release, compaction, parking and reviving refcount-0 blocks,
LRU eviction) must leave equal tables, allocation counts, refcounts, free
lists, return values and hit counts.  Physical-block relabelling must move
the pool with its ids and leave served tokens unchanged."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.paged_attention import gather_block_kv
from repro_torch.serve.kv_cache import PAGED_KINDS, PagedKVCache, \
    paged_supported
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

STAT_KEYS = ("blocks_total", "blocks_in_use", "blocks_parked", "prefix_hits",
             "prefix_misses", "prefix_hit_tokens", "evictions",
             "parked_tables", "park_reclaims")


def pair(slots=3, capacity=12, bs=4, prefix_cache=True):
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=2)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    return (JaxPagedKVCache(jcfg, slots, capacity, bs,
                            prefix_cache=prefix_cache),
            PagedKVCache(tcfg, slots, capacity, bs, prefix_cache=prefix_cache,
                         device="cpu"))


def assert_same_state(j, t):
    np.testing.assert_array_equal(t.tables, j.tables)
    np.testing.assert_array_equal(t.n_alloc, j.n_alloc)
    np.testing.assert_array_equal(t.refcount, j.refcount)
    assert t.free == j.free
    assert list(t._cached_free) == list(j._cached_free)
    assert t._hash_to_block == j._hash_to_block
    js = j.stats()
    assert t.stats() == {k: js[k] for k in STAT_KEYS}


def both(j, t, method, *args, **kw):
    a = getattr(j, method)(*args, **kw)
    b = getattr(t, method)(*args, **kw)
    assert a == b, (method, a, b)
    assert_same_state(j, t)
    return b


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_same_calls_same_state(prefix_cache):
    j, t = pair(prefix_cache=prefix_cache)
    assert t.pools[0]["k"].shape == (9, 4, t.cfg.n_kv_heads, t.cfg.head_dim)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 100, 8).astype(np.int32)
    p0 = np.concatenate([shared, [1, 2, 3]]).astype(np.int32)
    p1 = np.concatenate([shared, [7]]).astype(np.int32)
    p2 = rng.integers(0, 100, 10).astype(np.int32)

    assert both(j, t, "attach_prefix", 0, p0) == 0
    both(j, t, "ensure_allocated", 0, len(p0) - 1)
    both(j, t, "register_filled", 0, p0, 6)          # one full block
    both(j, t, "register_filled", 0, p0, len(p0))    # the second
    hit = both(j, t, "probe_prefix", p1, memo_key=1)
    assert hit == (8 if prefix_cache else 0)
    assert both(j, t, "probe_prefix", p1, memo_key=1) == hit   # memoized
    assert both(j, t, "attach_prefix", 1, p1) == hit
    both(j, t, "ensure_allocated", 1, len(p1))
    both(j, t, "attach_prefix", 2, p2)
    both(j, t, "ensure_allocated", 2, 11)
    both(j, t, "register_filled", 2, p2, len(p2))
    np.testing.assert_array_equal(t.table_rows([2, 0, 0]),
                                  j.table_rows([2, 0, 0]))
    both(j, t, "release_slot", 0)                    # hashed blocks park
    both(j, t, "move_slot", 0, 2)                    # compaction
    both(j, t, "release_slot", 1)
    both(j, t, "attach_prefix", 1, p0)               # revives parked blocks
    both(j, t, "ensure_allocated", 1, 11)
    both(j, t, "release_slot", 0)
    both(j, t, "release_slot", 1)
    for s in range(3):                               # fill the pool: evicts
        both(j, t, "attach_prefix", s, rng.integers(0, 100, 5))
        both(j, t, "ensure_allocated", s, 11)
    if prefix_cache:
        assert t.stats()["evictions"] > 0 and t.stats()["prefix_hits"] > 0


def test_permute_physical_blocks_moves_pool_with_ids():
    j, t = pair()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 100, n).astype(np.int32) for n in (9, 6)]
    for s, p in enumerate(prompts):
        both(j, t, "attach_prefix", s, p)
        both(j, t, "ensure_allocated", s, len(p) - 1)
        both(j, t, "register_filled", s, p, len(p))
    for layer in t.pools:
        for key in layer:
            layer[key] = torch.randn(layer[key].shape,
                                     generator=torch.Generator().manual_seed(2))
    before = [gather_block_kv(t.pools[0]["k"], torch.from_numpy(
        t.table_rows([s]))) for s in range(2)]
    perm = rng.permutation(t.n_blocks)
    j.permute_physical_blocks(perm)
    t.permute_physical_blocks(perm)
    assert_same_state(j, t)
    after = [gather_block_kv(t.pools[0]["k"], torch.from_numpy(
        t.table_rows([s]))) for s in range(2)]
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_engine_tokens_invariant_under_block_relabelling():
    """Relabel the pool's physical blocks between steps: greedy tokens
    are identical to an undisturbed run (the table is the only consumer of
    physical ids)."""
    from repro_torch.models.lm import RunConfig, init_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    model = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 5)]

    def serve(relabel):
        eng = ServeEngine(cfg, model, slots=2, capacity=24, kv_block_size=4,
                          prefill_chunk=4, rc=RunConfig(), device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        pending = list(reqs)
        for i in range(64):
            while pending and eng.n_active < eng.slots:
                eng.admit(pending.pop(0))
            if relabel and i % 2 == 1:
                eng.kv.permute_physical_blocks(
                    np.random.default_rng(i).permutation(eng.kv.n_blocks))
            if eng.step() == 0 and not pending:
                break
        assert all(r.done for r in reqs)
        return [r.out for r in reqs]

    assert serve(True) == serve(False)


def test_paged_supported():
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    assert paged_supported(cfg)
    assert {"moe", "moe_dense"} <= PAGED_KINDS
    with pytest.raises(ValueError, match="block_size"):
        PagedKVCache(cfg, 1, 8, 0, device="cpu")
