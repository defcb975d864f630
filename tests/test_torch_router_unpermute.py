"""The router's kernel walk, modelled in plain PyTorch, and the combine's
plain version, against the JAX package; and the paged read's routing of
the shapes its fused kernels refuse.

On the card the router (``csrc/router_topk.cu``) takes all k picks of a row
in one pass by ranking 64-bit keys (the score's bits over ~expert), past 32
experts only the keys at or above tau, the k-th largest of the 32 lanes'
largest keys.  ``router_topk_walk`` repeats that selection; here it is held
against ``router_topk_plain`` and ``repro.kernels.router_topk`` in
interpret mode on numpy-seeded logits with all-equal rows, ties at the k-th
place and -inf logits: indices exactly, weights within rtol 1e-5 / atol
1e-6.  The combine's kernel (``csrc/unpermute.cu``) is held bitwise
against ``unpermute_plain`` on the card, so here the plain version must
equal the reference's Pallas ``unpermute`` bit for bit, weighted and
folded, at row widths from 8 to 5,120.  Last, ``paged_fused`` under
``paged_attn="auto"`` must run the fused paged read on every pool shape its
kernels take (deepseek-v2's 64-position blocks among them) and raise,
naming the shape, on one they refuse, never falling back to the gather."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.unpermute import unpermute as jax_unpermute  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.router_topk import (router_layout,
                                             router_topk_plain,
                                             router_topk_walk)
from repro_torch.kernels.unpermute import unpermute_plain
from repro_torch.models import mla as mla_mod
from repro_torch.models.lm import (RunConfig, init_cache, init_params,
                                   paged_fused)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROUTINGS = {"softmax": dict(gating="softmax", norm_topk=False,
                            routed_scale=16.0),
            "sigmoid_renorm": dict(gating="sigmoid", norm_topk=True,
                                   routed_scale=2.446)}
EK = [(E, k) for E in (8, 64, 160, 256) for k in (1, 2, 6, 8, 16) if k <= E]


def router_logits(E: int, k: int, seed: int) -> np.ndarray:
    """16 rows: random ones, an all-equal row, rows whose k-th place is a
    tie of three (the k-1 above it distinct), -inf on every third expert,
    coarse values with many ties, and a row ordered by (e % 32, e // 32),
    which gives the ranking its most candidates ((k-1) * E/32 + 1 past 32
    experts: every key of the lanes that hold the k-1 largest)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, E)).astype(np.float32)
    x[1] = 0.25
    for r in (2, 3):
        x[r] = rng.standard_normal(E) * 0.1 - 5.0
        top = rng.permutation(E)
        x[r, top[:k - 1]] = 3.0 + np.arange(k - 1)
        x[r, top[k - 1:k + 2]] = 2.0
    x[4, 1::3] = -np.inf
    x[5] = np.round(x[5] * 2) / 2
    x[6, :] = -np.inf
    x[6, rng.permutation(E)[:max(1, E // 4)]] = 1.0
    e = np.arange(E)
    x[7] = 3.0 - 0.1 * (e % 32) - 0.001 * (e // 32)
    return x


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("E,k", EK)
def test_router_walk_matches_plain_and_reference(E, k, routing):
    kw = ROUTINGS[routing]
    logits = router_logits(E, k, seed=E * 31 + k)
    w_w, i_w = router_topk_walk(torch.from_numpy(logits), k, **kw)
    w_p, i_p = router_topk_plain(torch.from_numpy(logits), k, **kw)
    w_j, i_j = jops.router_topk(jnp.asarray(logits), top_k=k, **kw)
    assert i_w.dtype == torch.int32 and w_w.dtype == torch.float32
    for w_ref, i_ref in ((w_p.numpy(), i_p.numpy()),
                         (np.asarray(w_j), np.asarray(i_j))):
        np.testing.assert_array_equal(i_w.numpy(), i_ref)
        np.testing.assert_allclose(w_w.numpy(), w_ref, rtol=1e-5, atol=1e-6)
    for row in i_w.tolist():
        assert len(set(row)) == k


@pytest.mark.parametrize("E", [1, 2, 3, 8, 16, 17, 32, 33, 64, 100, 160,
                               256])
def test_router_layout_covers_every_expert_once(E):
    lanes, per = router_layout(E)
    assert 32 % lanes == 0 and lanes * per >= E
    if E <= 32:
        assert per == 1 and lanes >= E and lanes // 2 < E
    else:
        assert lanes == 32 and 32 * (per - 1) < E
    # every shape the wrapper takes: 0 < k <= min(E, 16)
    logits = router_logits(E, min(E, 16), seed=E)
    for k in sorted({1, min(E, 2), min(E, 16)}):
        for kw in ROUTINGS.values():
            w_w, i_w = router_topk_walk(torch.from_numpy(logits), k, **kw)
            w_p, i_p = router_topk_plain(torch.from_numpy(logits), k, **kw)
            assert torch.equal(i_w, i_p)
            torch.testing.assert_close(w_w, w_p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("T,k,d", [(1, 1, 8), (2, 6, 64), (5, 3, 40),
                                   (17, 8, 128), (64, 2, 24), (9, 16, 2048),
                                   (33, 6, 5120)])
def test_unpermute_plain_bitwise_reference(T, k, d, weighted, dtype):
    rng = np.random.default_rng(T * 7 + k)
    cap = T * k + 5
    y = rng.standard_normal((cap, d)).astype(np.float32)
    pos = rng.permutation(cap)[:T * k].reshape(T, k).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32) if weighted else None
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ty = torch.from_numpy(y).to(tdt)
    tw = None if w is None else torch.from_numpy(w)
    out = unpermute_plain(ty, torch.from_numpy(pos), tw)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = jax_unpermute(jnp.asarray(y, jdt), jnp.asarray(pos),
                         None if w is None else jnp.asarray(w),
                         interpret=True)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def meta_pool(cfg, bs: int) -> dict:
    return init_cache(cfg, 4, bs, dtype=torch.bfloat16, device="meta")[0]


def test_auto_routes_refused_pool_shapes_to_the_gather():
    """``auto`` on ``cuda`` takes the fused read wherever its kernels take
    the pool, and raises, naming the shape, where they refuse it: it routes
    nothing to the gather on its own."""
    cuda = RunConfig(executor="cuda")
    deepseek = get_config("deepseek-v2-236b")
    moonshot = get_config("moonshot-v1-16b-a3b")
    wide = dataclasses.replace(moonshot, head_dim=288)
    for bs in (16, 32, 48, 64):
        assert paged_fused(cuda, meta_pool(deepseek, bs))
    assert paged_fused(cuda, meta_pool(moonshot, 16))
    assert paged_fused(cuda, None)
    with pytest.raises(ValueError, match="at most 64 positions.*not 128"):
        paged_fused(cuda, meta_pool(deepseek, 128))
    with pytest.raises(ValueError, match="D=288.*paged_attn='gather'"):
        paged_fused(cuda, meta_pool(wide, 16))
    # an explicit request is kept, and the kernel's wrapper refuses it
    assert paged_fused(cuda._replace(paged_attn="fused"),
                       meta_pool(deepseek, 128))
    assert not paged_fused(cuda._replace(paged_attn="gather"),
                           meta_pool(moonshot, 16))
    assert not paged_fused(RunConfig(executor="plain"),
                           meta_pool(moonshot, 16))


@pytest.mark.parametrize("kv_block,fused_calls", [(64, True), (8, True),
                                                 (128, False)])
def test_engine_auto_read_follows_the_pool_shape(monkeypatch, kv_block,
                                                 fused_calls):
    """A reduced deepseek-v2 engine on the ``cuda`` executor (plain versions
    here): with 8- and 64-position blocks ``auto`` enters the fused MLA read
    and serves the gather's tokens; with 128-position blocks, more than the
    MLA kernels take, it raises rather than read by the gather."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("deepseek-v2-236b"), layers=2)
    model = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3)]
    calls = []
    real = mla_mod._mla_fused_paged_decode

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(mla_mod, "_mla_fused_paged_decode", counted)
    outs = {}
    for read in ("auto", "gather"):
        eng = ServeEngine(cfg, model, slots=2, capacity=128,
                          kv_block_size=kv_block, prefill_chunk=8,
                          rc=RunConfig(schedule_policy="dynamic",
                                       paged_attn=read), device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new=3)
                for i, p in enumerate(prompts)]
        if read == "auto" and not fused_calls:
            with pytest.raises(ValueError, match="not 128"):
                eng.run(reqs)
            assert not calls
            continue
        eng.run(reqs)
        outs[read] = [r.out for r in reqs]
        if read == "auto":
            assert calls
    assert len(outs["gather"]) == 2
    if fused_calls:
        assert outs["auto"] == outs["gather"]
