"""The port's multi-head latent attention (deepseek-v2) against the JAX
package.

Module level: ``repro_torch.models.mla.mla_block`` against
``repro.models.mla.mla_block`` on the same numpy weights and inputs (d_model
64, 4 heads, the reduced MLA ranks 48/32/16/8/16): prefill (decompressed),
contiguous absorbed decode, the paged gather read and the paged fused read
(the port's plain kernel version against the reference's Pallas kernel in
interpret mode), fp32 within 1e-5 and bf16 within 2e-2; the absorbed query
rounds twice in bf16, bitwise as the reference's.

Model level: reduced deepseek-v2-236b (3 layers: 1 dense + 2 MoE) carried
over with ``from_jax_params``; logits and latent cache rows against
``repro.models.lm.forward`` within 1e-4 for prefill, two contiguous decode
steps, and a paged prompt-chunk step and decode step through the fused and
the gather reads.  The reference runs the ``xla`` executor (JAX's own tests
hold xla == pallas)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import MLAConfig as JaxMLAConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import mla as jax_mla
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro_torch.configs import MLAConfig, get_config, reduced
from repro_torch.kernels.paged_attention import scale_q
from repro_torch.models import mla as port_mla
from repro_torch.models.lm import RunConfig, forward, init_cache
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODULE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TOL = dict(rtol=1e-4, atol=1e-4)

# ---------------------------------------------------------------------------
# Module level
# ---------------------------------------------------------------------------
D_MODEL, H = 64, 4
RANKS = dict(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16)
B, S, CAP, BS, NB = 2, 6, 12, 4, 3


def mla_leaves(seed=0):
    """The reference's ``init_mla`` leaves as numpy, fan-in scaled, with
    non-zero norm scales."""
    rng = np.random.default_rng(seed)
    r, dn, dr, dv = (RANKS[k] for k in ("kv_lora_rank", "qk_nope_head_dim",
                                        "qk_rope_head_dim", "v_head_dim"))
    qr = RANKS["q_lora_rank"]

    def w(*shape):
        return (rng.standard_normal(shape) * shape[0] ** -0.5
                ).astype(np.float32)
    return {"wq_a": w(D_MODEL, qr),
            "q_norm": {"scale": (0.1 * rng.standard_normal(qr)
                                 ).astype(np.float32)},
            "wq_b": w(qr, H * (dn + dr)), "wkv_a": w(D_MODEL, r + dr),
            "kv_norm": {"scale": (0.1 * rng.standard_normal(r)
                                  ).astype(np.float32)},
            "wkv_b": w(r, H * (dn + dv)), "wo": w(H * dv, D_MODEL)}


def both_modules(leaves):
    """The reference's leaf dict and the port's ``MLA`` (fp32 weights, as
    the reference's; both cast them to the input's dtype) on ``leaves``."""
    jp = jax.tree.map(jnp.asarray, leaves)
    tp = port_mla.MLA(D_MODEL, H, MLAConfig(**RANKS),
                      torch.Generator().manual_seed(0), torch.float32,
                      torch.device("cpu"))
    with torch.no_grad():
        for name, param in tp.named_parameters():
            a = leaves
            for part in name.split("."):
                a = a[part]
            param.copy_(torch.from_numpy(a))
    return jp, tp


def module_inputs(seed=1):
    """x for one step per path, the contiguous latent cache and the paged
    pools (random contents), tables and positions."""
    rng = np.random.default_rng(seed)
    r, dr = RANKS["kv_lora_rank"], RANKS["qk_rope_head_dim"]
    n_blocks = B * NB + 1
    return {
        "x_prefill": rng.standard_normal((B, S, D_MODEL)).astype(np.float32),
        "x_step": rng.standard_normal((B, 1, D_MODEL)).astype(np.float32),
        "ckv": rng.standard_normal((B, CAP, r)).astype(np.float32),
        "kr": rng.standard_normal((B, CAP, dr)).astype(np.float32),
        "ckv_pool": rng.standard_normal((n_blocks, BS, r)).astype(np.float32),
        "kr_pool": rng.standard_normal((n_blocks, BS, dr)).astype(np.float32),
        "tables": rng.permutation(n_blocks)[:B * NB].reshape(B, NB).astype(
            np.int32),
        "pos": np.asarray([7, 2], np.int32),
    }


def run_module(path, dtype):
    """(port out, reference out, port cache, reference cache) on one path."""
    jp, tp = both_modules(mla_leaves())
    inp = module_inputs()
    jdt, tdt = JDT[dtype], TDT[dtype]
    jmla, tmla = JaxMLAConfig(**RANKS), MLAConfig(**RANKS)

    def j(a):
        return jnp.asarray(a, jdt)

    def t(a):
        return torch.from_numpy(a).to(tdt)
    if path == "prefill":
        x = inp["x_prefill"]
        want, _ = jax_mla.mla_block(jp, j(x), n_heads=H, mla=jmla,
                                    positions=jnp.arange(S), q_chunk=64,
                                    kv_chunk=64)
        got = port_mla.mla_block(tp, t(x), n_heads=H, mla=tmla,
                                 positions=torch.arange(S))
        return got, want, None, None
    x, pos = inp["x_step"], inp["pos"]
    paged = path.startswith("paged")
    keys = ("ckv_pool", "kr_pool") if paged else ("ckv", "kr")
    jcache = {"ckv": j(inp[keys[0]]), "kr": j(inp[keys[1]])}
    tcache = {"ckv": t(inp[keys[0]]), "kr": t(inp[keys[1]])}
    kw = {}
    if paged:
        kw = dict(block_tables=inp["tables"],
                  paged_fused=path == "paged_fused")
    want, jcache = jax_mla.mla_block(
        jp, j(x), n_heads=H, mla=jmla, positions=jnp.asarray(pos)[:, None],
        cache=jcache, cache_pos=jnp.asarray(pos),
        **{k: (jnp.asarray(v) if k == "block_tables" else v)
           for k, v in kw.items()})
    got = port_mla.mla_block(
        tp, t(x), n_heads=H, mla=tmla,
        positions=torch.from_numpy(pos)[:, None],
        cache=tcache, cache_pos=torch.from_numpy(pos),
        **{k: (torch.from_numpy(v) if k == "block_tables" else v)
           for k, v in kw.items()})
    return got, want, tcache, jcache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["prefill", "contiguous", "paged_gather",
                                  "paged_fused"])
def test_mla_block_matches_reference(path, dtype):
    got, want, tcache, jcache = run_module(path, dtype)
    assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **MODULE_TOL[dtype])
    if tcache is not None:                 # this step's latent row, written
        for key in ("ckv", "kr"):
            np.testing.assert_allclose(tcache[key].float().numpy(),
                                       np.asarray(jcache[key], np.float32),
                                       **MODULE_TOL[dtype])


def test_absorbed_query_rounds_twice_as_the_reference():
    """In bf16 the absorbed query is rounded after the compensation scale
    and again after the attention scale, as the reference rounds it; one
    rounding of the product of the two scales gives other bits."""
    r, dn, dr = (RANKS[k] for k in ("kv_lora_rank", "qk_nope_head_dim",
                                    "qk_rope_head_dim"))
    comp, scale = (r + dr) ** 0.5 / (dn + dr) ** 0.5, (r + dr) ** -0.5
    q = np.random.default_rng(2).standard_normal((B, 1, H, r)).astype(
        np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    want = (jq * jnp.asarray(comp, jnp.bfloat16)) * jnp.asarray(
        scale, jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = scale_q(scale_q(tq, comp), scale)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert not torch.equal(scale_q(tq, comp * scale), got)


# ---------------------------------------------------------------------------
# Model level: reduced deepseek-v2 against repro.models.lm.forward
# ---------------------------------------------------------------------------
MB, MS, MCAP = 2, 10, 24
PBS, PNB, PN_BLOCKS = 4, 3, 8


def jax_layer_leaf(cache, layer, key):
    if layer == 0:
        return np.asarray(cache["prefix"][0]["kv"][key])
    return np.asarray(cache["body"]["b0"]["kv"][key][layer - 1])


@pytest.fixture(scope="module")
def deepseek():
    jcfg = jax_reduced(jax_get_config("deepseek-v2-236b"), layers=3)
    tcfg = reduced(get_config("deepseek-v2-236b"), layers=3)
    assert tcfg.mla == MLAConfig(**RANKS) and tcfg.moe.n_experts == 8
    params = jax_init_params(jcfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, np_params


@pytest.fixture(scope="module")
def contiguous_runs(deepseek):
    jcfg, tcfg, params, np_params = deepseek
    model = from_jax_params(tcfg, np_params, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tcfg.vocab_size, (MB, MS)).astype(np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (2, MB, 1)).astype(np.int32)
    jrc = JaxRunConfig(executor="xla", schedule_policy="fixed", q_chunk=64,
                       kv_chunk=64)
    jc = jax_init_cache(jcfg, MB, MCAP)
    tc = init_cache(tcfg, MB, MCAP, device="cpu")
    j_logits, jc, _ = jax_forward(params, jcfg, jrc,
                                  {"tokens": jnp.asarray(prompt)},
                                  mode="prefill", cache=jc)
    t_logits, tc, _ = forward(model, tcfg, RunConfig(),
                              {"tokens": torch.from_numpy(prompt).long()},
                              mode="prefill", cache=tc)
    out = [(np.asarray(j_logits), t_logits.numpy(), jc,
            [{k: v.clone() for k, v in layer.items()} for layer in tc])]
    for i in range(2):
        pos = np.full((MB,), MS + i, np.int32)
        j_logits, jc, _ = jax_forward(params, jcfg, jrc,
                                      {"tokens": jnp.asarray(steps[i])},
                                      mode="decode", cache=jc,
                                      pos=jnp.asarray(pos))
        toks = torch.from_numpy(steps[i]).long()
        t_logits, tc, _ = forward(model, tcfg, RunConfig(), {"tokens": toks},
                                  mode="decode", cache=tc,
                                  pos=torch.from_numpy(pos))
        out.append((np.asarray(j_logits), t_logits.numpy(), jc,
                    [{k: v.clone() for k, v in layer.items()}
                     for layer in tc]))
    return out


@pytest.mark.parametrize("step", [0, 1, 2],
                         ids=["prefill", "decode1", "decode2"])
def test_contiguous_logits_and_latent_cache_match_reference(contiguous_runs,
                                                             step):
    j_logits, t_logits, jc, tc = contiguous_runs[step]
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits, j_logits, **TOL)
    for layer in range(3):
        assert set(tc[layer]) == {"ckv", "kr"}
        for key in ("ckv", "kr"):
            np.testing.assert_allclose(tc[layer][key].numpy(),
                                       jax_layer_leaf(jc, layer, key), **TOL)


@pytest.fixture(scope="module")
def paged_runs(deepseek):
    """A chunk step (slot 0 prompt positions 0-4, slot 1 positions 0-2) and
    a decode step (one row per slot) over latent pools, through the
    reference's gather read and the port's fused and gather reads."""
    jcfg, tcfg, params, np_params = deepseek
    model = from_jax_params(tcfg, np_params, device="cpu")
    rng = np.random.default_rng(3)
    slot_tables = np.asarray([[3, 5, 0], [1, 6, 2]], np.int32)
    steps = []
    for slots, positions in (([0] * 5 + [1] * 3, list(range(5)) + [0, 1, 2]),
                             ([0, 1], [5, 3])):
        toks = rng.integers(0, tcfg.vocab_size, (len(slots), 1))
        steps.append((toks.astype(np.int32), np.asarray(positions, np.int32),
                      slot_tables[slots]))
    jrc = JaxRunConfig(executor="xla", schedule_policy="dynamic",
                       paged_attn="gather", q_chunk=64, kv_chunk=64)
    jc = jax_init_cache(jcfg, PN_BLOCKS, PBS)
    ref = []
    for toks, pos, tables in steps:
        logits, jc, _ = jax_forward(params, jcfg, jrc,
                                    {"tokens": jnp.asarray(toks)},
                                    mode="decode", cache=jc,
                                    pos=jnp.asarray(pos),
                                    block_tables=jnp.asarray(tables))
        ref.append((np.asarray(logits), jc))
    ports = {}
    for read in ("fused", "gather"):
        rc = RunConfig(schedule_policy="dynamic", paged_attn=read)
        pools = init_cache(tcfg, PN_BLOCKS, PBS, device="cpu")
        outs = []
        for toks, pos, tables in steps:
            logits, pools, _ = forward(
                model, tcfg, rc, {"tokens": torch.from_numpy(toks).long()},
                mode="decode", cache=pools, pos=torch.from_numpy(pos),
                block_tables=torch.from_numpy(tables))
            outs.append((logits.numpy(), [{k: t.clone() for k, t in
                                           layer.items()} for layer in pools]))
        ports[read] = outs
    return ref, ports


@pytest.mark.parametrize("read", ["fused", "gather"])
@pytest.mark.parametrize("step", [0, 1], ids=["chunk", "decode"])
def test_paged_logits_and_latent_pools_match_reference(paged_runs, read,
                                                       step):
    ref, ports = paged_runs
    (j_logits, jc), (t_logits, pools) = ref[step], ports[read][step]
    np.testing.assert_allclose(t_logits, j_logits, **TOL)
    for layer in range(3):
        for key in ("ckv", "kr"):
            np.testing.assert_allclose(pools[layer][key].numpy(),
                                       jax_layer_leaf(jc, layer, key), **TOL)


def test_from_jax_params_carries_mla_leaves_and_names_a_missing_one(deepseek):
    """Every MLA leaf lands under the reference's name; a tree missing one
    is refused with that leaf's name."""
    _, tcfg, _, np_params = deepseek
    model = from_jax_params(tcfg, np_params, device="cpu")
    attn = model.layers[1].attn
    assert isinstance(attn, port_mla.MLA)
    np.testing.assert_array_equal(
        attn.wkv_b.numpy(), np_params["body"]["b0"]["attn"]["wkv_b"][0])
    np.testing.assert_array_equal(
        model.layers[0].attn.q_norm.scale.numpy(),
        np_params["prefix"][0]["attn"]["q_norm"]["scale"])
    broken = jax.tree.map(lambda a: a, np_params)
    del broken["prefix"][0]["attn"]["kv_norm"]
    with pytest.raises(ValueError, match=r"layer 0: .*attn\.kv_norm\.scale"):
        from_jax_params(tcfg, broken, device="cpu")
