"""The port's model forward against ``repro.models.lm.forward`` on reduced
moonshot-v1-16b-a3b (3 layers: 1 dense + 2 MoE; E=8, k=2, block_m=8, two
shared experts, sigmoid gating with renormalisation and routed_scale).

The JAX side runs the ``pallas`` executor (interpret mode) with the
``fixed`` policy in fp32; its weights are carried across with
``repro_torch.weights.from_jax_params``.  Prefill logits, two decode steps'
logits and the K/V cache rows must agree within atol = rtol = 1e-4 (sums
run in other orders across the layers; RoPE'd K is compared with a
tolerance, never bitwise: ROADMAP C2)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import RunConfig, forward, init_cache
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, CAP = 2, 12, 32


def configs():
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=3)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    return jcfg, tcfg


def jax_cache_rows(cache, layer, key):
    """The reference cache's (B, CAP, H, D) rows for one layer."""
    if layer == 0:
        return np.asarray(cache["prefix"][0]["kv"][key])
    return np.asarray(cache["body"]["b0"]["kv"][key][layer - 1])


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = configs()
    assert tcfg.moe.n_experts == 8 and tcfg.moe.block_m == 8
    params = jax_init_params(jcfg, jax.random.key(0))
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (2, B, 1)).astype(np.int32)

    jrc = JaxRunConfig(executor="pallas", schedule_policy="fixed",
                       q_chunk=64, kv_chunk=64)
    jc = jax_init_cache(jcfg, B, CAP)
    j_logits, jc, _ = jax_forward(params, jcfg, jrc,
                                  {"tokens": jnp.asarray(prompt)},
                                  mode="prefill", cache=jc)
    j_out = [(np.asarray(j_logits), jc)]
    tc = init_cache(tcfg, B, CAP, device="cpu")
    rc = RunConfig()
    t_logits, tc, _ = forward(model, tcfg, rc,
                              {"tokens": torch.from_numpy(prompt).long()},
                              mode="prefill", cache=tc)
    t_out = [(t_logits.numpy(), [{k: v.clone() for k, v in layer.items()}
                                 for layer in tc])]
    for i in range(2):
        pos = np.full((B,), S + i, np.int32)
        j_logits, jc, _ = jax_forward(params, jcfg, jrc,
                                      {"tokens": jnp.asarray(steps[i])},
                                      mode="decode", cache=jc,
                                      pos=jnp.asarray(pos))
        j_out.append((np.asarray(j_logits), jc))
        t_logits, tc, _ = forward(model, tcfg, rc,
                                  {"tokens": torch.from_numpy(steps[i]).long()},
                                  mode="decode", cache=tc,
                                  pos=torch.from_numpy(pos))
        t_out.append((t_logits.numpy(),
                      [{k: v.clone() for k, v in layer.items()}
                       for layer in tc]))
    return j_out, t_out


@pytest.mark.parametrize("step", [0, 1, 2], ids=["prefill", "decode1",
                                                 "decode2"])
def test_logits_match_reference(runs, step):
    (j_logits, _), (t_logits, _) = runs[0][step], runs[1][step]
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits, j_logits, **TOL)


@pytest.mark.parametrize("key", ["k", "v"])
@pytest.mark.parametrize("step", [0, 2], ids=["prefill", "decode2"])
def test_cache_rows_match_reference(runs, step, key):
    (_, jc), (_, tc) = runs[0][step], runs[1][step]
    for layer in range(3):
        np.testing.assert_allclose(tc[layer][key].numpy(),
                                   jax_cache_rows(jc, layer, key), **TOL)


def test_default_device_needs_cuda():
    """Entry points default to the card; without one they raise instead of
    running elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.models.lm import init_params
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(tcfg, 1, 8)
