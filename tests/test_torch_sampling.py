"""The port's seeded sampling (``repro_torch.sampling``) against
``repro.sampling``:

* threefry bits: ``PRNGKey``, ``fold_in``, random bits, ``uniform`` and
  ``uniform_rows`` bitwise equal to ``jax.random``'s (threefry2x32,
  partitionable counters), over seeds of both signs and counters past
  2**16; ``gumbel`` within 2**-23 + one ulp (one ulp of the inner
  ``-log(u)``, which the outer ``log`` turns into an absolute 2**-23) and
  ``log`` itself within one ulp of XLA's;
* the four processors within 1e-6 of the reference's (the same -inf set);
* ``sample_rows`` tokens identical for every method at several seeds, and
  independent of the batch (a row alone draws what it draws in the batch);
* the engine (reduced moonshot-v1-16b-a3b, 2 layers: 1 dense + 1 MoE;
  fp32), paged under ``temperature``, ``top_k`` and ``top_p`` and
  contiguous under ``top_p``: every request's tokens equal to
  ``repro.serve.ServeEngine``'s at the same seeds, in a batch and served
  alone; greedy calls the kernels' wrappers as often as before and reads
  no seed."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.execution.base import set_plan_hook as jax_set_plan_hook  # noqa
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
import repro.sampling as jsamp  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.sampling import (ROLE_ACCEPT, ROLE_DRAFT, ROLE_RESIDUAL,
                                  ROLE_SAMPLE, SamplingConfig,
                                  available_samplers, get_sampler,
                                  process_logits, row_key, sample_rows,
                                  uniform_rows)
from repro_torch.sampling import threefry
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SEEDS = (0, 1, 7, 123456, 2 ** 31 - 1, -1, -5)
METHODS = {
    "temperature": dict(method="temperature", temperature=0.8),
    "top_k": dict(method="top_k", temperature=0.8, top_k=5),
    "top_p": dict(method="top_p", temperature=0.8, top_p=0.9),
}
JAX_RC = JaxRunConfig(executor="xla", schedule_policy="dynamic",
                      moe_stats=True, q_chunk=64, kv_chunk=64)


def jkey(seed):
    return jax.random.PRNGKey(jnp.int32(seed))


def words(key):
    return tuple(int(w) for w in key)


# ---------------------------------------------------------------------------
# Threefry, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bitwise(seed):
    k = threefry.prng_key(torch.tensor(seed, dtype=torch.int32))
    assert words(k) == words(np.asarray(jkey(seed)))
    for data in (0, 1, 3, 65537, 2 ** 31 - 1):
        got = threefry.fold_in(k, data)
        want = np.asarray(jax.random.fold_in(jkey(seed), data))
        assert words(got) == words(want), data
    # a tensor of seeds folds a tensor of counters, row by row
    ks = threefry.prng_key(torch.tensor([seed, 3], dtype=torch.int32))
    fk = threefry.fold_in(ks, torch.tensor([9, 10]))
    for i, (s, c) in enumerate(((seed, 9), (3, 10))):
        want = np.asarray(jax.random.fold_in(jkey(s), c))
        assert (int(fk[0][i]), int(fk[1][i])) == words(want)


@pytest.mark.parametrize("seed,counter,role", [
    (0, 0, ROLE_SAMPLE), (5, 3, ROLE_DRAFT), (-2, 70000, ROLE_ACCEPT),
    (2 ** 31 - 1, 12, ROLE_RESIDUAL)])
def test_bits_uniform_gumbel_match_jax_random(seed, counter, role):
    jk = jsamp.row_key(jnp.int32(seed), jnp.int32(counter), role)
    tk = row_key(torch.tensor(seed, dtype=torch.int32),
                 torch.tensor(counter), role)
    assert (int(tk[0]), int(tk[1])) == words(np.asarray(jk))
    n = 4099                                   # odd, past a power of two
    np.testing.assert_array_equal(
        threefry.random_bits(tk, n).numpy(),
        np.asarray(jax.random.bits(jk, (n,))).astype(np.int64))
    np.testing.assert_array_equal(threefry.uniform(tk, n).numpy(),
                                  np.asarray(jax.random.uniform(jk, (n,))))
    assert threefry.uniform(tk).item() == float(jax.random.uniform(jk))
    want = np.asarray(jax.random.gumbel(jk, (n,)))
    got = threefry.gumbel(tk, n).numpy()
    # g = -log(v), v = -log(u): one ulp of v (relative 2**-23) is an
    # absolute 2**-23 in g, plus g's own rounding
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(got)))
    assert (np.abs(got - want) <= 2.0 ** -23 + ulp).all()
    # the categorical draw over random logits is the reference's
    logits = np.random.default_rng(counter).standard_normal(
        (n,)).astype(np.float32)
    assert int(threefry.categorical(tk, torch.tensor(logits))) \
        == int(jax.random.categorical(jk, jnp.asarray(logits)))


def test_log_within_one_ulp_of_xla():
    x = np.random.default_rng(0).random(200_000).astype(np.float32) + 1e-30
    want = np.asarray(jnp.log(x))
    got = torch.log(torch.tensor(x)).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


def test_uniform_rows_bitwise_and_aligned_with_counters():
    seeds = np.asarray([4, 4, 9, -3], np.int32)
    ctr = np.asarray([0, 3, 5, 2 ** 20], np.int32)
    got = uniform_rows(torch.tensor(seeds), torch.tensor(ctr), 5).numpy()
    want = np.asarray(jsamp.uniform_rows(jnp.asarray(seeds),
                                         jnp.asarray(ctr), 5))
    np.testing.assert_array_equal(got, want)
    shifted = uniform_rows(torch.tensor(seeds), torch.tensor(ctr + 1),
                           5).numpy()
    np.testing.assert_array_equal(got[:, 1:], shifted[:, :-1])
    assert ((0.0 <= got) & (got < 1.0)).all()


# ---------------------------------------------------------------------------
# Processors and row draws
# ---------------------------------------------------------------------------
def test_registry_and_unknown_method():
    assert set(available_samplers()) == set(jsamp.available_samplers())
    with pytest.raises(ValueError, match="unknown sampling method"):
        get_sampler("nope")


@pytest.mark.parametrize("kw", [
    dict(method="greedy"), dict(method="temperature", temperature=0.5),
    dict(method="top_k", top_k=7), dict(method="top_k", top_k=0),
    dict(method="top_k", top_k=300, temperature=2.0),
    dict(method="top_p", top_p=0.9, temperature=0.8),
    dict(method="top_p", top_p=1e-6), dict(method="top_p", top_p=1.0)],
    ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_processors_match_reference(kw):
    lg = np.random.default_rng(1).standard_normal((5, 257)).astype(
        np.float32) * 3
    got = process_logits(torch.tensor(lg), SamplingConfig(**kw)).numpy()
    want = np.asarray(jsamp.process_logits(jnp.asarray(lg),
                                           jsamp.SamplingConfig(**kw)))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    assert fin.any(axis=-1).all()              # never an all -inf row


@pytest.mark.parametrize("method", ["greedy", *METHODS])
def test_sample_rows_tokens_match_reference(method):
    kw = METHODS.get(method, dict(method="greedy"))
    cfg, jcfg = SamplingConfig(**kw), jsamp.SamplingConfig(**kw)
    rng = np.random.default_rng(2)
    lg = rng.standard_normal((6, 300)).astype(np.float32) * 2
    for seed in (0, 3, 11, -7):
        seeds = np.asarray([seed, seed, seed + 1, 5, 5, 9], np.int32)
        ctr = np.asarray([0, 1, 2, 3, 40, 1000], np.int32)
        got = sample_rows(torch.tensor(lg), cfg, torch.tensor(seeds),
                          torch.tensor(ctr)).numpy()
        want = np.asarray(jsamp.sample_rows(jnp.asarray(lg), jcfg,
                                            jnp.asarray(seeds),
                                            jnp.asarray(ctr)))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        # a row alone draws what it draws in the batch
        solo = [int(sample_rows(torch.tensor(lg[i:i + 1]), cfg,
                                torch.tensor(seeds[i:i + 1]),
                                torch.tensor(ctr[i:i + 1]))[0])
                for i in range(len(lg))]
        assert solo == got.tolist()
    if method == "greedy":
        assert (got == lg.argmax(-1)).all()


def test_roles_draw_independent_streams():
    ka = row_key(3, 7, ROLE_SAMPLE)
    kb = row_key(3, 7, ROLE_ACCEPT)
    assert (int(ka[0]), int(ka[1])) != (int(kb[0]), int(kb[1]))


# ---------------------------------------------------------------------------
# The engine against the reference engine
# ---------------------------------------------------------------------------
def seeded_params(jcfg):
    """The reference's parameter tree from a numpy seed (norm scales 1,
    every matrix N(0, 0.05^2))."""
    from repro.models.lm import init_params as jax_init_params
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.key(0)))

    def leaf(path, s):
        if "scale" in jax.tree_util.keystr(path):
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(
            (rng.standard_normal(s.shape) * 0.5).astype(s.dtype))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    width = dict(layers=2, d_model=64, vocab=128)
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), **width)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), **width)
    params = seeded_params(jcfg)
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, tcfg, params, model


def proto(n=3, max_new=5):
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, 128, 5).astype(np.int32), max_new,
             None if i == 1 else 10 + i) for i in range(n)]


ENGINE_KW = dict(slots=2, capacity=32, prefill_chunk=4)
# every method on the paged engine; the contiguous engine under top_p (its
# draws go through the same steps; each reference engine compiles its own
# step shapes, about 7 s)
ENGINE_CASES = [("temperature", None), ("top_k", None), ("top_p", None),
                ("top_p", 0)]


@pytest.fixture(scope="module")
def reference_tokens(pair):
    """{(method, kv_block_size): {rid: tokens}} from the reference engine,
    batched (requests 0-2 on 2 slots; request 1 has no seed of its own:
    engine base 4 + rid)."""
    jcfg, _, params, _ = pair
    out = {}
    try:
        for method, kvb in ENGINE_CASES:
            eng = JaxServeEngine(jcfg, params, rc=JAX_RC, kv_block_size=kvb,
                                 sampling=jsamp.SamplingConfig(
                                     **METHODS[method], seed=4),
                                 **ENGINE_KW)
            reqs = [JaxRequest(rid=i, prompt=p, max_new=m, seed=s)
                    for i, p, m, s in proto()]
            eng.run(reqs, max_steps=128)
            assert all(r.done for r in reqs)
            out[method, kvb] = {r.rid: list(r.out) for r in reqs}
    finally:
        jax_set_plan_hook(None)
    return out


@pytest.mark.parametrize("method,kvb", ENGINE_CASES,
                         ids=[f"{'paged' if kvb is None else 'contiguous'}-"
                              f"{m}" for m, kvb in ENGINE_CASES])
def test_sampled_engine_tokens_equal_reference(pair, reference_tokens,
                                               method, kvb):
    _, tcfg, _, model = pair
    sampling = SamplingConfig(**METHODS[method], seed=4)
    want = reference_tokens[method, kvb]
    eng = ServeEngine(tcfg, model, kv_block_size=kvb, sampling=sampling,
                      device="cpu", **ENGINE_KW)
    reqs = [Request(rid=i, prompt=p, max_new=m, seed=s)
            for i, p, m, s in proto()]
    eng.run(reqs, max_steps=128)
    assert {r.rid: r.out for r in reqs} == want
    assert eng.describe()["sampling"] == method
    # alone on an engine of its own: the same tokens (keyed draws)
    for i, p, m, s in proto():
        solo = ServeEngine(tcfg, model, kv_block_size=kvb,
                           sampling=sampling, device="cpu", **ENGINE_KW)
        r = Request(rid=i, prompt=p, max_new=m, seed=s)
        solo.run([r], max_steps=64)
        assert r.out == want[i], (method, i)
    # the tokens are drawn, not the argmax: some differ from greedy
    greedy = ServeEngine(tcfg, model, kv_block_size=kvb, device="cpu",
                         **ENGINE_KW)
    greqs = [Request(rid=i, prompt=p, max_new=m) for i, p, m, _ in proto()]
    greedy.run(greqs, max_steps=128)
    assert [r.out for r in greqs] != [r.out for r in reqs]


def test_greedy_engine_reads_no_seed_and_calls_wrappers_as_before(
        pair, monkeypatch):
    """Under greedy the steps get no seeds or counters (no copy to the
    device) and the MoE wrappers are called as often as with an explicit
    greedy config; the tokens are equal."""
    _, tcfg, _, model = pair
    calls = {}
    for name in ("router_topk", "permute", "unpermute", "fused_gate_up",
                 "grouped_gemm"):
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, wrapped)
    import repro_torch.sampling.base as base
    monkeypatch.setattr(base, "row_key", lambda *a, **k: pytest.fail(
        "greedy drew a key"))
    outs = []
    for sampling in (None, SamplingConfig(seed=99)):
        calls.clear()
        eng = ServeEngine(tcfg, model, sampling=sampling, device="cpu",
                          **ENGINE_KW)
        assert eng.sampling.method == "greedy"
        reqs = [Request(rid=i, prompt=p, max_new=m, seed=s)
                for i, p, m, s in proto()]
        eng.run(reqs, max_steps=128)
        outs.append(([r.out for r in reqs], dict(calls)))
    assert outs[0] == outs[1] and outs[0][1]["router_topk"] > 0
