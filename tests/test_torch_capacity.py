"""The port's ``capacity_factor`` policy against the reference's, on the
CPU, on seeded numpy routing.

* ``expert_capacity``, ``capacity_slots`` and ``build_capacity_schedule``
  integer-equal to ``repro.scheduling.capacity``'s (every field), with and
  without the ``cap=`` override, over T in {2, 64, 512}, E in {8, 64,
  160}, k in {2, 6}, capacity_factor in {0.5, 1.25, 2.0} and random,
  Zipf-skewed and one-expert routing.
* ``schedule_stats`` equal to the reference's on all three policies.
* ``moe_ffn`` on ``capacity_factor`` (the port's ``cuda`` executor, whose
  kernels run their plain versions here) against the reference's on its
  ``pallas`` executor in interpret mode, fp32, within
  ``tests/test_kernels.py``'s 2e-5, folded and unfolded combine, with
  ``emit_stats``: the ``sched/*`` keys and values equal.
* A token whose every assignment is dropped gets an MoE output of exactly
  0 (its pos points at the sentinel block, which no kernel writes but
  with zeros), so the residual passes it through.
* The loss within 1e-5 and every gradient within 1e-4 of
  ``repro.models.lm.loss_fn`` through reduced moonshot-v1-16b-a3b (2
  layers: 1 dense + 1 MoE) on ``capacity_factor``, with ``moe_stats``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.dispatch import MoEDispatchConfig as JaxDispatchConfig  # noqa: E402
from repro.core.dispatch import moe_ffn as jax_moe_ffn  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.models.lm import loss_fn as jax_loss_fn  # noqa: E402
from repro.scheduling import build_schedule as jax_build_schedule  # noqa: E402
from repro.scheduling import capacity as jcap  # noqa: E402
from repro.scheduling import schedule_stats as jax_schedule_stats  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
from repro_torch.execution import plan_dispatch
from repro_torch.models.lm import RunConfig, loss_fn
from repro_torch.scheduling import (DEFAULT_POLICY_SWEEP, ScheduleStats,
                                    build_capacity_schedule, build_schedule,
                                    capacity_slots, expert_capacity,
                                    schedule_stats)
from repro_torch.weights import from_jax_params, from_jax_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def routing(kind, T, E, k, seed):
    """(T, k) int32 expert picks: ``random`` (k distinct a token, uniform),
    ``zipf`` (k distinct a token, expert e drawn with weight 1/(e+1)^1.2)
    or ``one`` (every assignment to expert 0)."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        return np.zeros((T, k), np.int32)
    if kind == "random":
        return np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
            np.int32)
    p = 1.0 / np.arange(1, E + 1) ** 1.2
    p /= p.sum()
    return np.stack([rng.choice(E, k, replace=False, p=p)
                     for _ in range(T)]).astype(np.int32)


# the reference's builders, jitted once per shape (eager jnp compiles each op)
jax_capacity_schedule = jax.jit(
    jcap.build_capacity_schedule, static_argnums=(1, 2),
    static_argnames=("capacity_factor", "cap"))
jax_capacity_slots = jax.jit(jcap.capacity_slots, static_argnums=(1,))
jax_schedule = jax.jit(jax_build_schedule, static_argnums=(1, 2, 3),
                       static_argnames=("capacity_factor",))


def assert_same_schedule(st, sj):
    for field in st._fields:
        a, b = getattr(st, field), getattr(sj, field)
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.int32, field
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=field)
        else:
            assert a == b, field


@pytest.mark.parametrize("kind", ["random", "zipf", "one"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("E", [8, 64, 160])
@pytest.mark.parametrize("T", [2, 64, 512])
def test_capacity_schedule_is_the_reference(T, E, k, cf, kind):
    idx = routing(kind, T, E, k, seed=T * 1000 + E * 10 + k)
    M = 128 if E > 8 else 8
    assert expert_capacity(T, k, E, M, cf) \
        == jcap.expert_capacity(T, k, E, M, cf)
    slot, counts = capacity_slots(torch.from_numpy(idx.reshape(-1)), E)
    slot_j, counts_j = jax_capacity_slots(jnp.asarray(idx.reshape(-1)), E)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    st = build_capacity_schedule(torch.from_numpy(idx), E, M,
                                 capacity_factor=cf)
    sj = jax_capacity_schedule(jnp.asarray(idx), E, M, capacity_factor=cf)
    assert_same_schedule(st, sj)
    # the registry reaches the same builder with the dispatch config's field
    reg = build_schedule(torch.from_numpy(idx), E, M,
                         policy="capacity_factor", capacity_factor=cf)
    assert torch.equal(reg.src_tok, st.src_tok)


@pytest.mark.parametrize("cap", [8, 16, 256])
@pytest.mark.parametrize("kind", ["random", "one"])
def test_capacity_schedule_cap_override_is_the_reference(kind, cap):
    idx = routing(kind, 64, 8, 2, seed=cap)
    st = build_capacity_schedule(torch.from_numpy(idx), 8, 8, cap=cap)
    sj = jax_capacity_schedule(jnp.asarray(idx), 8, 8, cap=cap)
    assert_same_schedule(st, sj)
    assert st.capacity == 8 * cap + 8


POLICY_KW = dict(DEFAULT_POLICY_SWEEP)


@pytest.mark.parametrize("kind", ["random", "zipf", "one"])
@pytest.mark.parametrize("T,E,k,M", [(2, 64, 6, 128), (64, 8, 2, 8),
                                     (512, 160, 6, 128)])
@pytest.mark.parametrize("policy", sorted(POLICY_KW))
def test_schedule_stats_are_the_reference(policy, T, E, k, M, kind):
    idx = routing(kind, T, E, k, seed=T + E)
    kw = POLICY_KW[policy]
    st = build_schedule(torch.from_numpy(idx), E, M, policy=policy, **kw)
    sj = jax_schedule(jnp.asarray(idx), E, M, policy, **kw)
    got, want = schedule_stats(st), jax_schedule_stats(sj)
    assert got._fields == want._fields == ScheduleStats._fields
    for field in got._fields:
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dim() == 0, field
        assert a.is_floating_point() == np.issubdtype(b.dtype, np.floating)
        assert float(a) == float(b), (field, float(a), float(b))


D, F, BM = 64, 96, 8


def layer_inputs(E, T, seed, hot=None):
    """fp32 layer inputs; ``hot`` experts get a large router bias (a
    constant input feature), so the routing piles onto them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if hot is not None:
        x[:, 0] = 1.0
        router[0] = 0.0
        router[0, list(hot)] = 8.0
    return {
        "x": x, "router": router,
        "w_gate": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        "w_up": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        "w_down": (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32),
    }


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("cf,hot", [(0.5, None), (1.25, None), (2.0, None),
                                    (1.25, (0, 3))])
def test_moe_ffn_on_capacity_matches_pallas_reference(cf, hot, fold):
    E, k, T = 8, 2, 32
    inp = layer_inputs(E, T, seed=int(cf * 4), hot=hot)
    kw = dict(n_experts=E, top_k=k, block_m=BM, fold_combine=fold,
              schedule_policy="capacity_factor", capacity_factor=cf,
              emit_stats=True)
    y_j, aux_j = jax_moe_ffn(*(jnp.asarray(v) for v in inp.values()),
                             JaxDispatchConfig(executor="pallas", **kw))
    y_t, aux_t = moe_ffn(*(torch.from_numpy(v) for v in inp.values()),
                         MoEDispatchConfig(executor="cuda", **kw))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5,
                               atol=2e-5)
    assert set(aux_t) == set(aux_j)
    for key in aux_j:
        if key.startswith("sched/"):
            assert float(aux_t[key]) == float(aux_j[key]), key
        else:
            np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]),
                                       rtol=1e-5, atol=1e-6)
    if cf == 0.5 or hot is not None:
        assert float(aux_t["sched/dropped_rows"]) > 0


@pytest.mark.parametrize("fold", [True, False])
def test_fully_dropped_token_gets_exact_zero(fold):
    """Every token prefers experts 0 and 3, whose buckets hold 16 rows of
    the 48 assignments each: the later tokens lose both picks."""
    E, k, T = 8, 2, 48
    inp = {n: torch.from_numpy(v)
           for n, v in layer_inputs(E, T, seed=5, hot=(0, 3)).items()}
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=BM,
                            executor="cuda", fold_combine=fold,
                            schedule_policy="capacity_factor",
                            capacity_factor=1.25)
    plan = plan_dispatch(inp["x"], inp["router"], cfg)
    sched = plan.schedule
    cap = int(sched.group_offsets[1])
    dropped = (sched.pos == E * cap).all(dim=1)
    assert int(dropped.sum()) >= 8
    y, _ = moe_ffn(inp["x"], inp["router"], inp["w_gate"], inp["w_up"],
                   inp["w_down"], cfg)
    assert torch.equal(y[dropped], torch.zeros_like(y[dropped]))
    assert (y[~dropped].abs().amax(dim=1) > 0).all()


def test_two_layer_loss_and_gradients_on_capacity_match_jax():
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=2)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    params = jax_init_params(jcfg, jax.random.key(0))
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    kw = dict(schedule_policy="capacity_factor", capacity_factor=1.25,
              loss_chunk=8, moe_stats=True)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, JaxRunConfig(**kw),
                              {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu").requires_grad_(True)
    loss_t, m_t = loss_fn(model, tcfg, RunConfig(**kw),
                          {"tokens": torch.from_numpy(toks)})
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss_t, list(named.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5, atol=1e-5)
    sched_keys = {k for k in m_j if k.startswith("sched/")}
    assert sched_keys == {f"sched/{f}" for f in ScheduleStats._fields}
    for key in sched_keys:
        assert float(m_t[key]) == float(m_j[key]), key
    want = from_jax_tree(tcfg, jax.tree.map(np.asarray, g_j))
    assert set(want) == set(named)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
