"""The port's paged decode attention against the JAX package.

Kernel level: the plain version beside the CUDA kernel (B6, which a CPU
tensor runs) against ``repro.kernels.paged_attention.paged_decode_attention``
in interpret mode, over the cases of tests/test_paged_attention.py: masks
(kv_limit vector and scalar, causal, sliding window), softcap, the
block-size grid, GQA, Dv != D, unallocated table entries over poisoned
blocks, and physical-block permutation; and the MLA second score operand
(``q2``, ``k2_pool``, the latent pool as the value) over block sizes, vector
and scalar kv_limit, masks and poisoned blocks.  fp32 within atol = rtol =
2e-5 (the reference's own tolerance), bf16 within 2e-2.

Model level: the paged write and read (``scatter_block_rows``,
``gather_block_kv``) equal the reference's, and the paged forward's per-row
logits on reduced moonshot-v1-16b-a3b equal ``repro.models.lm.forward(...,
block_tables=...)`` within 1e-4, for a prompt-chunk step and a decode step,
through the fused read and the gather read."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.paged_attention import paged_decode_attention as jax_paged
from repro.models.attention import gather_block_kv as jax_gather
from repro.models.attention import scatter_block_rows as jax_scatter
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.paged_attention import (gather_block_kv,
                                                  paged_decode_attention)
from repro_torch.models.attention import scatter_block_rows
from repro_torch.models.lm import RunConfig, forward, init_cache
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def case(seed=0, *, B=3, nb=2, n_blocks=8, bs=4, Hkv=2, G=2, D=16, Dv=None):
    """numpy inputs as tests/test_paged_attention.py builds them: distinct
    physical blocks per row, random inclusive limits."""
    Dv = D if Dv is None else Dv
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_blocks, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, Hkv, Dv)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:B * nb].reshape(B, nb).astype(np.int32)
    lim = rng.integers(0, nb * bs, B).astype(np.int32)
    return q, k, v, tables, lim


def both(q, k, v, tables, dtype):
    jx = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)] + \
        [jnp.asarray(tables)]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)] + \
        [torch.from_numpy(tables)]
    return jx, tx


def run_both(inputs, dtype="float32", lim=None, q_pos=None, **kw):
    q, k, v, tables, lim0 = inputs
    lim = lim0 if lim is None else lim
    (qj, kj, vj, tj), (qt, kt, vt, tt) = both(q, k, v, tables, dtype)
    jkw, tkw = dict(kw), dict(kw)
    if q_pos is not None:
        jkw["q_pos"] = jnp.asarray(q_pos)
        tkw["q_pos"] = torch.from_numpy(q_pos)
    want = jax_paged(qj, kj, vj, tj, jnp.asarray(lim), interpret=True, **jkw)
    got = paged_decode_attention(qt, kt, vt, tt, torch.as_tensor(lim), **tkw)
    assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_basic(dtype):
    got, want = run_both(case(0), dtype)
    np.testing.assert_allclose(got, want, **tol(dtype))


def test_scalar_kv_limit_and_scale():
    got, want = run_both(case(1), lim=np.int32(5), scale=0.3)
    np.testing.assert_allclose(got, want, **tol("float32"))


@pytest.mark.parametrize("window", [None, 3])
def test_causal_and_window_masks(window):
    got, want = run_both(case(2), q_pos=np.asarray([1, 4, 7], np.int32),
                         causal=True, window=window)
    np.testing.assert_allclose(got, want, **tol("float32"))


def test_logit_softcap():
    got, want = run_both(case(3), logit_softcap=8.0)
    np.testing.assert_allclose(got, want, **tol("float32"))


@pytest.mark.parametrize("bs,nb", [(2, 5), (4, 3), (8, 2), (16, 4)])
def test_block_size_grid(bs, nb):
    got, want = run_both(case(5 + bs, nb=nb, n_blocks=3 * nb + 2, bs=bs))
    np.testing.assert_allclose(got, want, **tol("float32"))


@pytest.mark.parametrize("Hkv,G,D,Dv", [(2, 4, 16, 16), (1, 8, 32, 32),
                                        (4, 1, 32, 32), (2, 2, 16, 24)])
def test_gqa_groups_and_value_width(Hkv, G, D, Dv):
    got, want = run_both(case(11, Hkv=Hkv, G=G, D=D, Dv=Dv, n_blocks=9,
                              nb=3))
    np.testing.assert_allclose(got, want, **tol("float32"))


def test_unallocated_entries_over_poisoned_blocks():
    """Table entries past kv_limit may name any block; poisoning those
    blocks with huge values leaks nothing, and both sides agree."""
    q, k, v, tables, _ = case(8)
    lim = np.asarray([2, 2, 2], np.int32)          # only block 0 attended
    clean, want = run_both((q, k, v, tables, lim))
    k2, v2 = k.copy(), v.copy()
    k2[tables[:, 1]] = 1e4
    v2[tables[:, 1]] = 1e4
    poisoned, want_p = run_both((q, k2, v2, tables, lim))
    assert np.array_equal(clean, poisoned)
    np.testing.assert_allclose(poisoned, want_p, **tol("float32"))
    np.testing.assert_allclose(clean, want, **tol("float32"))


def test_physical_block_permutation_invariance():
    q, k, v, tables, lim = case(6)
    out, _ = run_both((q, k, v, tables, lim))
    perm = np.random.default_rng(7).permutation(k.shape[0])
    inv = np.argsort(perm)
    out_p, want_p = run_both((q, k[inv], v[inv],
                              perm[tables].astype(np.int32), lim))
    assert np.array_equal(out, out_p)
    np.testing.assert_allclose(out_p, want_p, **tol("float32"))


def test_wrapper_refuses_what_it_does_not_serve():
    q, k, v, tables, lim = (torch.from_numpy(a) for a in case(9))
    with pytest.raises(ValueError, match="both q2 and k2_pool"):
        paged_decode_attention(q, k, v, tables, lim, q2=q)
    with pytest.raises(ValueError, match="second score operand"):
        paged_decode_attention(q, k, v, tables, lim, q2=q[:, :, :1],
                               k2_pool=k)
    with pytest.raises(ValueError, match="q_pos"):
        paged_decode_attention(q, k, v, tables, lim, causal=True)


# ---------------------------------------------------------------------------
# The MLA second score operand: s = q . k + q2 . k2, the latent as value
# ---------------------------------------------------------------------------
def mla_case(seed=0, *, B=3, nb=3, bs=4, G=4, D=32, D2=8):
    """MLA-shaped inputs (one KV head, G query heads): the latent pool
    doubles as the value, the rope-key pool is the second operand."""
    rng = np.random.default_rng(seed)
    n_blocks = B * nb + 2
    ckv = rng.standard_normal((n_blocks, bs, 1, D)).astype(np.float32)
    kr = rng.standard_normal((n_blocks, bs, 1, D2)).astype(np.float32)
    q = rng.standard_normal((B, 1, G, D)).astype(np.float32)
    q2 = rng.standard_normal((B, 1, G, D2)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:B * nb].reshape(B, nb).astype(np.int32)
    lim = rng.integers(0, nb * bs, B).astype(np.int32)
    return q, q2, ckv, kr, tables, lim


def run_mla(inputs, dtype="float32", lim=None, **kw):
    q, q2, ckv, kr, tables, lim0 = inputs
    lim = lim0 if lim is None else lim
    jq, jq2, jckv, jkr = (jnp.asarray(a, JDT[dtype]) for a in (q, q2, ckv, kr))
    tq, tq2, tckv, tkr = (torch.from_numpy(a).to(TDT[dtype])
                          for a in (q, q2, ckv, kr))
    want = jax_paged(jq, jckv, jckv, jnp.asarray(tables), jnp.asarray(lim),
                     q2=jq2, k2_pool=jkr, interpret=True, **kw)
    got = paged_decode_attention(tq, tckv, tckv, torch.from_numpy(tables),
                                 torch.as_tensor(lim), q2=tq2, k2_pool=tkr,
                                 **kw)
    assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs,nb", [(2, 5), (4, 3), (16, 2)])
def test_mla_operand_plain_matches_pallas(dtype, bs, nb):
    """deepseek's absorbed-decode scale (r + dr)^-0.5 applied to q and q2
    in their own dtype, vector kv_limit, several block sizes."""
    got, want = run_mla(mla_case(20 + bs, bs=bs, nb=nb), dtype,
                        scale=40 ** -0.5)
    np.testing.assert_allclose(got, want, **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_operand_scalar_kv_limit_and_default_scale(dtype):
    """A scalar kv_limit; with no scale, q and q2 both take D^-0.5 of q."""
    got, want = run_mla(mla_case(31), dtype, lim=np.int32(6))
    np.testing.assert_allclose(got, want, **tol(dtype))


def test_mla_operand_masks_and_separate_value():
    """Causal and window masks, softcap, and a value pool of its own
    (several KV heads): the plain version keeps the reference's generality."""
    q, k, v, tables, lim = case(32, Hkv=2, G=3, D=16, Dv=24, n_blocks=9,
                                nb=3)
    rng = np.random.default_rng(33)
    q2 = rng.standard_normal((3, 2, 3, 8)).astype(np.float32)
    k2 = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    q_pos = np.asarray([2, 5, 9], np.int32)
    want = jax_paged(*(jnp.asarray(a) for a in (q, k, v, tables, lim)),
                     q2=jnp.asarray(q2), k2_pool=jnp.asarray(k2),
                     q_pos=jnp.asarray(q_pos), causal=True, window=4,
                     logit_softcap=5.0, interpret=True)
    got = paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, lim)),
        q2=torch.from_numpy(q2), k2_pool=torch.from_numpy(k2),
        q_pos=torch.from_numpy(q_pos), causal=True, window=4,
        logit_softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_operand_poisoned_blocks_past_kv_limit(dtype):
    """Table entries past kv_limit over poisoned blocks: 1e4 in both pools,
    then NaN in the rope-key pool, leak nothing.  (NaN in the latent pool,
    the value, reaches the reference's p @ V as 0 * NaN; the card's kernel
    skips those blocks, and tests/test_torch_gpu.py holds it to that.)"""
    q, q2, ckv, kr, tables, _ = mla_case(34)
    lim = np.asarray([3, 3, 3], np.int32)          # only block 0 attended
    clean, want = run_mla((q, q2, ckv, kr, tables, lim), dtype)
    np.testing.assert_allclose(clean, want, **tol(dtype))
    past = tables[:, 1:].reshape(-1)
    ckv1, kr1 = ckv.copy(), kr.copy()
    ckv1[past], kr1[past] = 1e4, 1e4
    got, want = run_mla((q, q2, ckv1, kr1, tables, lim), dtype)
    assert np.array_equal(got, clean)
    np.testing.assert_allclose(got, want, **tol(dtype))
    kr1[past] = np.nan
    got, want = run_mla((q, q2, ckv1, kr1, tables, lim), dtype)
    assert np.array_equal(got, clean)
    np.testing.assert_allclose(got, want, **tol(dtype))


def test_gather_and_scatter_equal_reference():
    """The paged read is the reference's gather; the paged write lands
    where the reference's does and drops a position past the table."""
    rng = np.random.default_rng(12)
    n_blocks, bs, H, D, B, nb = 7, 4, 2, 8, 3, 2
    pool = rng.standard_normal((n_blocks, bs, H, D)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:B * nb].reshape(B, nb).astype(np.int32)
    val = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    pos = np.asarray([5, 0, nb * bs + 1], np.int32)      # last one dropped
    want = jax_scatter(jnp.asarray(pool), jnp.asarray(val),
                       jnp.asarray(tables), jnp.asarray(pos))
    got = torch.from_numpy(pool.copy())
    scatter_block_rows(got, torch.from_numpy(val), torch.from_numpy(tables),
                       torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        gather_block_kv(got, torch.from_numpy(tables)).numpy(),
        np.asarray(jax_gather(want, jnp.asarray(tables))))


# ---------------------------------------------------------------------------
# Paged forward: per-row logits against repro.models.lm.forward
# ---------------------------------------------------------------------------
BS, NB, N_BLOCKS = 4, 3, 8


def jax_pool_rows(cache, layer, key):
    if layer == 0:
        return np.asarray(cache["prefix"][0]["kv"][key])
    return np.asarray(cache["body"]["b0"]["kv"][key][layer - 1])


@pytest.fixture(scope="module")
def paged_runs():
    """Two paged steps on reduced moonshot (3 layers): a chunk step (slot 0
    prompt positions 0-4, slot 1 positions 0-2) and a decode step (one row
    per slot), through the reference (xla executor, gather read) and the
    port (fused and gather reads)."""
    jcfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=3)
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    params = jax_init_params(jcfg, jax.random.key(1))
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
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
    jc = jax_init_cache(jcfg, N_BLOCKS, BS)
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
        pools = init_cache(tcfg, N_BLOCKS, BS, device="cpu")
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
def test_paged_forward_logits_match_reference(paged_runs, read, step):
    ref, ports = paged_runs
    (j_logits, jc), (t_logits, pools) = ref[step], ports[read][step]
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    for layer in range(3):
        for key in ("k", "v"):
            np.testing.assert_allclose(pools[layer][key].numpy(),
                                       jax_pool_rows(jc, layer, key),
                                       rtol=1e-4, atol=1e-4)


def test_paged_attn_is_validated_and_decode_only():
    tcfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2)
    from repro_torch.models.lm import init_params
    model = init_params(tcfg, 0, device="cpu")
    pools = init_cache(tcfg, 4, BS, device="cpu")
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.int64)}
    tables = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="paged_attn"):
        forward(model, tcfg, RunConfig(paged_attn="bogus"), batch,
                mode="decode", cache=pools, pos=pos, block_tables=tables)
    with pytest.raises(ValueError, match="decode-only"):
        forward(model, tcfg, RunConfig(), batch, mode="prefill",
                block_tables=tables)
