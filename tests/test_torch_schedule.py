"""The port's ``fixed`` schedule against ``repro.scheduling.fixed``: every
array and the static capacity must be equal, integer for integer, for
random, all-one-expert and exactly-tied routings.  The plan's combine-scale
rows and router aux losses are held against the reference too."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.core.dispatch import combine_scale_rows as jax_combine_rows
from repro.execution.base import router_aux_losses as jax_aux
from repro.scheduling.fixed import build_fixed_schedule as jax_fixed
from repro_torch.execution import combine_scale_rows, router_aux_losses
from repro_torch.scheduling import build_fixed_schedule, build_schedule

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
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "one_expert", "tied"])
@pytest.mark.parametrize("T,E,k,M", [(32, 4, 1, 8), (64, 8, 2, 8),
                                     (48, 16, 4, 16), (4, 64, 6, 128),
                                     (16, 256, 8, 8)])
def test_fixed_schedule_equals_reference(kind, T, E, k, M):
    idx = routing(kind, T, E, k)
    js = jax_fixed(jnp.asarray(idx), E, M)
    ts = build_fixed_schedule(torch.from_numpy(idx), E, M)
    assert ts.capacity == js.capacity and ts.block_m == js.block_m
    for f in FIELDS:
        t, j = getattr(ts, f), getattr(js, f)
        assert t.dtype == torch.int32, f
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)


def test_build_schedule_registry_defaults_to_fixed():
    idx = torch.from_numpy(routing("random", 16, 8, 2))
    a, b = build_schedule(idx, 8, 8), build_fixed_schedule(idx, 8, 8)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
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
