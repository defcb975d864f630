"""The port's speculative decoding (``repro_torch.spec``) against the
port's plain engine and ``repro.spec.SpecEngine``, on reduced
moonshot-v1-16b-a3b (3 layers: 1 dense + 2 MoE; fp32) as the target:

* greedy: token for token the plain engine's, for k in {1, 2, 4} x blocks
  of 4 and 8 x three drafts (the target itself, which accepts nearly
  every proposal; a perturbed copy, which rejects mid-chain; a reduced
  smollm-360m with the target's vocabulary, which accepts almost none);
  so every rollback point is taken.  On two of those cases (two prompts
  of 4 tokens: each reference engine compiles a step a shape) the
  reference ``SpecEngine``'s tokens, rounds, drafted and accepted counts
  and forwards are the port's;
* stochastic (``temperature`` with the smollm draft, ``top_p`` with the
  self-draft): tokens and the ``spec/*`` and ``kv/blocks_truncated``
  counters equal to the reference's at fixed seeds;
* the verify forward is one plan per MoE layer over all n * (k + 1) rows;
* ``truncate_slot``'s tables, refcounts, free list, cached-free pool and
  ``kv/blocks_truncated`` equal to the reference ``PagedKVCache``'s, call
  for call;
* EOS and ``max_new`` inside a round, the constructor's refusals, and a
  preemption and resumption under speculation (the tokens of an
  uninterrupted run)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.execution.base import set_plan_hook as jax_set_plan_hook  # noqa
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.obs import Observability as JaxObservability  # noqa: E402
from repro.sampling import SamplingConfig as JaxSamplingConfig  # noqa
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache  # noqa
from repro.spec import SpecEngine as JaxSpecEngine  # noqa: E402
from repro.spec import make_draft_config as jax_make_draft_config  # noqa
from repro_torch.configs import get_config, reduced
from repro_torch.execution.base import set_plan_hook
from repro_torch.kernels import ops
from repro_torch.models.lm import n_moe_layers
from repro_torch.obs import MetricsRegistry, Observability
from repro_torch.sampling import SamplingConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.spec import SpecEngine, make_draft_config
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

WIDTH = dict(layers=3, d_model=64, vocab=128)
JAX_RC = JaxRunConfig(executor="xla", schedule_policy="dynamic",
                      moe_stats=True, q_chunk=64, kv_chunk=64)
ENGINE_KW = dict(slots=2, capacity=64, prefill_chunk=4)


def seeded_tree(jcfg, seed, scale=0.3):
    """A numpy tree in the reference's layout (norm scales 1, every matrix
    N(0, scale^2))."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.key(0)))

    def leaf(path, s):
        if "scale" in jax.tree_util.keystr(path):
            return np.ones(s.shape, s.dtype)
        return (rng.standard_normal(s.shape) * scale).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def perturbed(tree, eps, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + (eps * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)


@pytest.fixture(scope="module")
def models():
    """{name: (jax cfg, jax params, port cfg, port model)} for the target
    and its three drafts."""
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), **WIDTH)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), **WIDTH)
    jd = jax_make_draft_config(jcfg, reduce=True, layers=1, d_model=32)
    td = make_draft_config(tcfg, reduce=True, layers=1, d_model=32)
    assert td.vocab_size == tcfg.vocab_size == jd.vocab_size
    trees = {"target": (jcfg, tcfg, seeded_tree(jcfg, 0)),
             "smollm": (jd, td, seeded_tree(jd, 1))}
    trees["perturbed"] = (jcfg, tcfg,
                          perturbed(trees["target"][2], 0.03, 2))
    out = {}
    for name, (jc, tc, tree) in trees.items():
        out[name] = (jc, jax.tree.map(jnp.asarray, tree), tc,
                     from_jax_params(tc, tree, device="cpu"))
    out["self"] = out["target"]
    return out


def prompts(ref=False):
    """Three prompts of 3-8 tokens; against the reference two of 4 (each
    reference engine compiles a step a shape: keep the shapes few)."""
    rng = np.random.default_rng(0)
    if ref:
        return [rng.integers(1, 128, 4).astype(np.int32) for _ in range(2)]
    return [rng.integers(1, 128, int(rng.integers(3, 9))).astype(np.int32)
            for _ in range(3)]


def port_run(models, *, draft=None, k=2, kvbs=4, sampling=None, max_new=6,
             eos=None, obs=None, reqs=None, ref=False):
    _, _, tcfg, model = models["target"]
    kw = dict(ENGINE_KW, kv_block_size=kvbs, sampling=sampling, obs=obs,
              device="cpu")
    if draft is None:
        eng = ServeEngine(tcfg, model, **kw)
    else:
        _, _, dcfg, dmodel = models[draft]
        eng = SpecEngine(tcfg, model, draft_cfg=dcfg, draft_model=dmodel,
                         spec_k=k, **kw)
    reqs = reqs or [Request(rid=i, prompt=p, max_new=max_new, eos=eos)
                    for i, p in enumerate(prompts(ref))]
    try:
        eng.run(reqs, max_steps=256)
    finally:
        set_plan_hook(None)
    assert all(r.done for r in reqs)
    return eng, {r.rid: list(r.out) for r in reqs}


def jax_run(models, *, draft=None, k=2, kvbs=4, sampling=None, max_new=6,
            obs=None):
    jcfg, params, _, _ = models["target"]
    kw = dict(ENGINE_KW, kv_block_size=kvbs, rc=JAX_RC, obs=obs,
              sampling=sampling)
    if draft is None:
        eng = JaxServeEngine(jcfg, params, **kw)
    else:
        djcfg, dparams, _, _ = models[draft]
        eng = JaxSpecEngine(jcfg, params, draft_cfg=djcfg,
                            draft_params=dparams, spec_k=k, **kw)
    reqs = [JaxRequest(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts(ref=True))]
    try:
        eng.run(reqs, max_steps=256)
    finally:
        jax_set_plan_hook(None)
    assert all(r.done for r in reqs)
    return eng, {r.rid: list(r.out) for r in reqs}


_BASE = {}


def baseline(models, kvbs, ref=False):
    """The port's plain greedy engine's tokens (memoized)."""
    if (kvbs, ref) not in _BASE:
        _BASE[kvbs, ref] = port_run(models, kvbs=kvbs, ref=ref)[1]
    return _BASE[kvbs, ref]


# ---------------------------------------------------------------------------
# Greedy identity
# ---------------------------------------------------------------------------
REF_CASES = {(4, 2, "self"), (8, 4, "perturbed")}


@pytest.mark.parametrize("draft", ["self", "perturbed", "smollm"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kvbs", [4, 8])
def test_greedy_spec_identity(models, kvbs, k, draft):
    base = baseline(models, kvbs)
    eng, out = port_run(models, draft=draft, k=k, kvbs=kvbs)
    assert out == base, (kvbs, k, draft)
    assert eng.n_spec_rounds > 0
    assert eng.n_drafted >= eng.n_accepted >= 0
    assert 0.0 <= eng.acceptance_rate <= 1.0
    if draft == "self":
        assert eng.acceptance_rate > 0.9
    if (kvbs, k, draft) in REF_CASES:
        eng, out = port_run(models, draft=draft, k=k, kvbs=kvbs, ref=True)
        assert out == baseline(models, kvbs, ref=True)
        jeng, ref = jax_run(models, draft=draft, k=k, kvbs=kvbs)
        assert out == ref
        assert (eng.n_spec_rounds, eng.n_drafted, eng.n_accepted,
                eng.n_forwards) == (jeng.n_spec_rounds, jeng.n_drafted,
                                    jeng.n_accepted, jeng.n_forwards)


def test_rollback_points_are_fuzzed(models):
    """The perturbed draft rejects inside a chain: some rounds accept part
    of k, so the truncation cuts inside the proposals."""
    eng, _ = port_run(models, draft="perturbed", k=4)
    assert 0.0 < eng.acceptance_rate < 1.0
    eng, _ = port_run(models, draft="smollm", k=4)
    assert eng.acceptance_rate < 0.2


# ---------------------------------------------------------------------------
# Stochastic speculation against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method,draft,k", [
    ("temperature", "smollm", 2), ("top_p", "self", 4)])
def test_stochastic_spec_tokens_and_counters_equal_reference(models, method,
                                                             draft, k):
    kw = (dict(method="temperature", temperature=0.8, seed=5)
          if method == "temperature"
          else dict(method="top_p", top_p=0.9, temperature=0.9, seed=6))
    obs = Observability.memory(clock=lambda: 0.0)
    jobs = JaxObservability.memory(clock=lambda: 0.0)
    eng, out = port_run(models, draft=draft, k=k,
                        sampling=SamplingConfig(**kw), obs=obs, ref=True)
    jeng, ref = jax_run(models, draft=draft, k=k,
                        sampling=JaxSamplingConfig(**kw), obs=jobs)
    assert out == ref
    assert (eng.n_spec_rounds, eng.n_drafted, eng.n_accepted) \
        == (jeng.n_spec_rounds, jeng.n_drafted, jeng.n_accepted)
    for name in ("spec/rounds", "spec/drafted", "spec/accepted",
                 "kv/blocks_truncated", "serve/steps"):
        assert obs.metrics.counter_value(name) \
            == jobs.metrics.counter_value(name), name
    assert obs.metrics.gauge_value("spec/acceptance_rate") \
        == pytest.approx(jobs.metrics.gauge_value("spec/acceptance_rate"))
    assert eng.n_spec_rounds > 0
    # the same seeds again: the same tokens
    _, again = port_run(models, draft=draft, k=k,
                        sampling=SamplingConfig(**kw), ref=True)
    assert again == out
    if draft == "self":
        assert eng.acceptance_rate > 0.5


# ---------------------------------------------------------------------------
# One plan per MoE layer per verify
# ---------------------------------------------------------------------------
def test_one_plan_per_moe_layer_per_verify(models, monkeypatch):
    """A round = k draft forwards (a dense draft: no plan) and one verify
    forward whose every MoE layer routes all n * (k + 1) rows in one
    router call."""
    _, _, tcfg, model = models["target"]
    _, _, dcfg, dmodel = models["smollm"]
    rows = []
    real = ops.router_topk
    monkeypatch.setattr(ops, "router_topk", lambda logits, **kw: (
        rows.append(int(logits.shape[0])), real(logits, **kw))[1])
    k = 3
    eng = SpecEngine(tcfg, model, draft_cfg=dcfg, draft_model=dmodel,
                     spec_k=k, kv_block_size=4, device="cpu", **ENGINE_KW)
    for i in range(2):
        eng.admit(Request(rid=i, prompt=np.asarray([1 + i, 2, 3], np.int32),
                          max_new=16))
    rounds = 0
    for _ in range(8):
        before = eng.n_spec_rounds
        rows.clear()
        eng.step()
        if eng.n_spec_rounds > before:
            assert rows == [2 * (k + 1)] * n_moe_layers(tcfg), rows
            rounds += 1
    assert rounds >= 2 and n_moe_layers(tcfg) == 2


# ---------------------------------------------------------------------------
# Rollback bookkeeping
# ---------------------------------------------------------------------------
def pool_state(kv):
    return (kv.tables.tolist(), kv.n_alloc.tolist(), kv.refcount.tolist(),
            list(kv.free), list(kv._cached_free), sorted(kv._chain))


def test_truncate_slot_bookkeeping_equals_reference(models):
    jcfg, _, tcfg, _ = models["smollm"]
    reg, jreg = MetricsRegistry(), JaxObservability.memory().metrics
    kv = PagedKVCache(tcfg, 2, 32, 4, prefix_cache=True, device="cpu")
    jkv = JaxPagedKVCache(jcfg, 2, 32, 4, prefix_cache=True)
    kv.bind_obs(reg, Observability.memory().tracer)
    jkv.bind_obs(jreg, JaxObservability.memory().tracer)
    prompt = np.arange(1, 14, dtype=np.int32)
    calls = [("attach_prefix", 0, prompt), ("ensure_allocated", 0, 12),
             ("register_filled", 0, prompt, 12),
             ("ensure_allocated", 1, 10), ("truncate_slot", 1, 5),
             ("truncate_slot", 1, 5), ("truncate_slot", 0, 13),
             ("truncate_slot", 0, 6), ("release_slot", 0),
             ("attach_prefix", 0, prompt), ("truncate_slot", 1, 0),
             ("ensure_allocated", 1, 3), ("truncate_slot", 0, 0)]
    for name, *args in calls:
        got = getattr(kv, name)(*args)
        want = getattr(jkv, name)(*args)
        assert got == want, (name, args)
        assert pool_state(kv) == pool_state(jkv), (name, args)
    assert reg.counter_value("kv/blocks_truncated") \
        == jreg.counter_value("kv/blocks_truncated") > 0


# ---------------------------------------------------------------------------
# EOS, max_new, refusals, preemption
# ---------------------------------------------------------------------------
def test_spec_respects_eos_and_max_new(models):
    probe = port_run(models, max_new=8)[1]
    eos = probe[0][2]
    for kw in (dict(max_new=8, eos=eos), dict(max_new=3)):
        _, base = port_run(models, **kw)
        _, out = port_run(models, draft="self", k=3, **kw)
        assert out == base, kw
    assert all(len(v) <= 3 for v in base.values())


def test_spec_engine_validation(models):
    _, _, tcfg, model = models["target"]
    _, _, dcfg, dmodel = models["smollm"]
    kw = dict(slots=2, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpecEngine(tcfg, model, draft_cfg=dcfg.replace(
            vocab_size=dcfg.vocab_size + 1), draft_model=dmodel,
            kv_block_size=4, **kw)
    with pytest.raises(ValueError, match="paged"):
        SpecEngine(tcfg, model, draft_cfg=dcfg, draft_model=dmodel,
                   kv_block_size=0, **kw)
    with pytest.raises(ValueError, match="spec_k"):
        SpecEngine(tcfg, model, draft_cfg=dcfg, draft_model=dmodel,
                   spec_k=0, kv_block_size=4, **kw)
    eng = SpecEngine(tcfg, model, draft_cfg=dcfg, draft_model=dmodel,
                     kv_block_size=4, **kw)
    d = eng.describe()
    assert d["spec_k"] == 4 and d["spec_draft"] == dcfg.name
    assert eng.acceptance_rate == 1.0


@pytest.mark.parametrize("draft", ["smollm", "self"])
def test_preempt_and_resume_under_speculation(models, draft):
    """preempt(0) after 3 steps: the target's table parks, the draft's is
    released; the resumed request re-derives the draft's KV by catch-up
    and every request ends with the uninterrupted run's tokens."""
    _, _, tcfg, model = models["target"]
    _, _, dcfg, dmodel = models[draft]
    base = baseline(models, 4)
    eng = SpecEngine(tcfg, model, draft_cfg=dcfg, draft_model=dmodel,
                     spec_k=2, kv_block_size=4, device="cpu", **ENGINE_KW)
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts())]
    pending = eng.enqueue(reqs)
    for _ in range(3):
        eng.schedule(pending)
        eng.step()
    assert eng.n_spec_rounds > 0 or draft == "smollm"
    victim = eng.preempt(0)
    assert not victim.done and eng.dkv.n_alloc.sum() >= 0
    assert int(eng.dkv.n_alloc[eng.n_active]) == 0
    eng.run(reqs, max_steps=256)
    set_plan_hook(None)
    assert all(r.done for r in reqs) and eng.n_resumed == 1
    assert {r.rid: r.out for r in reqs} == base
