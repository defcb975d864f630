"""The port's ``fixed`` and ``dynamic`` schedules against
``repro.scheduling.fixed`` and ``repro.scheduling.dynamic``: every array and
the static capacity must be equal, integer for integer, for random,
all-one-expert, exactly-tied and Zipf-skewed routings (``dynamic`` at
``block_m_min`` 8, 16 and 32).  The plan's combine-scale rows and router
aux losses are held against the reference too."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.core.dispatch import combine_scale_rows as jax_combine_rows
from repro.execution.base import router_aux_losses as jax_aux
from repro.scheduling.dynamic import build_dynamic_schedule as jax_dynamic
from repro.scheduling.dynamic import sub_block as jax_sub_block
from repro.scheduling.fixed import build_fixed_schedule as jax_fixed
from repro_torch.execution import combine_scale_rows, router_aux_losses
from repro_torch.scheduling import (build_dynamic_schedule,
                                    build_fixed_schedule, build_schedule,
                                    sub_block)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ("counts", "group_offsets", "src_tok", "pos", "block_expert",
          "block_active", "seg_start")


def routing(kind, T, E, k, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.stack([rng.permutation(E)[:k] for _ in range(T)]
                        ).astype(np.int32)
    if kind == "one_expert":          # every token's first choice is one expert
        idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
        hot = E // 2
        for t in range(T):
            row = [hot] + [e for e in idx[t] if e != hot][:k - 1]
            idx[t] = row
        return idx.astype(np.int32)
    if kind == "tied":                # every expert gets exactly T*k/E rows
        return (np.arange(T * k).reshape(T, k) % E).astype(np.int32)
    if kind == "zipf":                # expert e drawn with weight 1/(e+1)^1.5
        p = 1.0 / np.arange(1, E + 1) ** 1.5
        p = p / p.sum()
        return np.stack([rng.choice(E, k, replace=False, p=p)
                         for _ in range(T)]).astype(np.int32)
    raise ValueError(kind)


def assert_schedules_equal(ts, js):
    assert ts.capacity == js.capacity and ts.block_m == js.block_m
    for f in FIELDS:
        t, j = getattr(ts, f), getattr(js, f)
        assert t.dtype == torch.int32, f
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)


@pytest.mark.parametrize("kind", ["random", "one_expert", "tied"])
@pytest.mark.parametrize("T,E,k,M", [(32, 4, 1, 8), (64, 8, 2, 8),
                                     (48, 16, 4, 16), (4, 64, 6, 128),
                                     (16, 256, 8, 8)])
def test_fixed_schedule_equals_reference(kind, T, E, k, M):
    idx = routing(kind, T, E, k)
    js = jax_fixed(jnp.asarray(idx), E, M)
    ts = build_fixed_schedule(torch.from_numpy(idx), E, M)
    assert_schedules_equal(ts, js)


@pytest.mark.parametrize("block_m_min", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "zipf", "one_expert"])
@pytest.mark.parametrize("T,E,k,M", [(2, 64, 6, 128), (64, 64, 6, 128),
                                     (48, 16, 4, 32), (64, 8, 2, 8),
                                     (16, 256, 8, 64)])
def test_dynamic_schedule_equals_reference(kind, T, E, k, M, block_m_min):
    idx = routing(kind, T, E, k, seed=T + E)
    js = jax_dynamic(jnp.asarray(idx), E, M, block_m_min=block_m_min)
    ts = build_dynamic_schedule(torch.from_numpy(idx), E, M,
                                block_m_min=block_m_min)
    assert ts.block_m == jax_sub_block(M, block_m_min) \
        == sub_block(M, block_m_min)
    assert_schedules_equal(ts, js)


def test_dynamic_pads_no_more_than_fixed():
    """At moonshot's decode and prefill sizes the dynamic schedule's
    padded rows never exceed the fixed schedule's, on the same
    envelope."""
    for T in (2, 4, 64):
        idx = torch.from_numpy(routing("random", T, 64, 6, seed=T))
        d, f = build_dynamic_schedule(idx, 64, 128), \
            build_fixed_schedule(idx, 64, 128)
        assert d.capacity == f.capacity and d.block_m == 8
        assert int(d.block_active.sum()) * d.block_m \
            <= int(f.block_active.sum()) * f.block_m


def test_build_schedule_registry_defaults_to_fixed():
    idx = torch.from_numpy(routing("random", 16, 8, 2))
    a, b = build_schedule(idx, 8, 8), build_fixed_schedule(idx, 8, 8)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    c = build_schedule(idx, 8, 32, policy="dynamic", block_m_min=16)
    d = build_dynamic_schedule(idx, 8, 32, block_m_min=16)
    for f in FIELDS:
        assert torch.equal(getattr(c, f), getattr(d, f))
    with pytest.raises(ValueError):
        build_schedule(idx, 8, 8, policy="no-such-policy")


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_combine_rows_and_aux_equal_reference(kind):
    T, E, k, M = 24, 8, 2, 8
    rng = np.random.default_rng(3)
    idx = routing(kind, T, E, k)
    w = rng.random((T, k)).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    js = jax_fixed(jnp.asarray(idx), E, M)
    ts = build_fixed_schedule(torch.from_numpy(idx), E, M)
    np.testing.assert_array_equal(
        combine_scale_rows(ts, torch.from_numpy(w)).numpy(),
        np.asarray(jax_combine_rows(js, jnp.asarray(w))))

    class Cfg:
        n_experts = E
    ja = jax_aux(jnp.asarray(logits), jnp.asarray(idx), Cfg)
    ta = router_aux_losses(torch.from_numpy(logits), torch.from_numpy(idx),
                           Cfg)
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(ta[key]), float(ja[key]),
                                   rtol=1e-5, atol=1e-6)
