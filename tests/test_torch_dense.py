"""The port's dense family against the JAX package.

Module level, on the same numpy inputs:

* ``flash_attention`` (chunked online softmax, fixed chunks with a ragged
  last one, fully masked KV chunks skipped) against the reference's
  ``flash_attention`` (which cuts each axis into its largest divisor of a
  chunk) and against the port's whole-score ``attention``: S of 80 and 77
  (prime factors only: the reference's chunks are 7 and 11 positions),
  windows of 24 and none, softcap 50, GQA groups of 3 and 7, a per-row
  ``kv_limit``; fp32 within 1e-5, bf16 within 2e-2;
* layernorm, GeGLU and ``gelu_mlp`` against ``repro.models.blocks`` and
  ``repro.models.ffn`` within 1e-6.

Model level, on reduced qwen2-7b, smollm-360m, starcoder2-3b and gemma2-9b
(2 layers, d_model 32, vocab 128; the reference's weights carried over with
``from_jax_params``, every bias and norm leaf made non-zero): the logits of
an 80-token prefill (past reduced gemma2's 64-position window) and of two
decode steps, and every K/V row, against ``repro.models.lm.forward``;
contiguous, and paged through the gather read and the fused read (the
kernel's plain version on the CPU); within 1e-4.  Then ``loss_fn`` on
gemma2 and starcoder2 within 1e-5 and gemma2's gradients within 1e-4, and
the three repairs the dense family needs: the final softcap on served
logits, ``n_moe_layers`` counting MoE blocks, and the tied head; the
``auto`` paged read takes the fused kernel on every dense pool; an odd
gemma2 depth raises."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import forward as jax_forward_eager  # noqa: E402
from repro.models.lm import init_cache as jax_init_cache  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.models.lm import loss_fn as jax_loss_fn  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as tattn
from repro_torch.models.blocks import LayerNorm, RMSNorm, make_norm
from repro_torch.models.ffn import FFN
from repro_torch.models.lm import (RunConfig, forward, head_matrix,
                                   init_cache, init_params, loss_fn,
                                   n_moe_layers, paged_fused)
from repro_torch.weights import from_jax_params, from_jax_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

DENSE = ["qwen2-7b", "smollm-360m", "starcoder2-3b", "gemma2-9b"]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
FLASH_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TOL = dict(rtol=1e-4, atol=1e-4)
# one compile a step shape (the eager forward retraces its layer scan at
# every call)
jax_forward = jax.jit(jax_forward_eager, static_argnames=("cfg", "rc",
                                                          "mode"))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
# (S, window, softcap, Hkv, G, kv_limit): S = 77 is 7 x 11, so the
# reference's chunks are 7 (queries) and 11 (keys) where the port's are 8
# and 16 with a ragged last one
FLASH_CASES = [
    (80, None, None, 2, 3, False),
    (80, 24, None, 2, 3, False),
    (77, 24, 50.0, 1, 7, False),
    (77, None, 50.0, 2, 3, True),
    (80, 24, 50.0, 1, 7, True),
]


def flash_inputs(S, Hkv, G, dtype, seed=0, B=2, D=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32) * 2
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32) * 2
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lim = np.asarray([S // 2, S - 3], np.int32)
    return [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)], lim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,cap,Hkv,G,limit", FLASH_CASES)
def test_flash_attention_matches_reference_and_whole_score(S, window, cap,
                                                           Hkv, G, limit,
                                                           dtype):
    (q, k, v), lim = flash_inputs(S, Hkv, G, dtype)
    kw = dict(causal=True, window=window, logit_softcap=cap)
    got = tattn.flash_attention(
        q, k, v, **kw, kv_limit=torch.from_numpy(lim) if limit else None,
        q_chunk=8, kv_chunk=16)
    want = jattn.flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(JDT[dtype])
          for t in (q, k, v)),
        **kw, kv_limit=jnp.asarray(lim) if limit else None, q_chunk=8,
        kv_chunk=16)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **FLASH_TOL[dtype])
    whole = tattn.attention(q, k, v, **kw,
                            kv_limit=torch.from_numpy(lim) if limit else None)
    np.testing.assert_allclose(got.float().numpy(), whole.float().numpy(),
                               **FLASH_TOL[dtype])


def test_flash_attention_skips_chunks_the_masks_remove(monkeypatch):
    """A window of 24 over 77 positions in chunks of 8 (queries) and 16
    (keys, the last one 13): a query chunk scores only the KV chunks that
    its causal band (and window) reaches, two products each.  The prime
    length keeps chunks of the requested size, where the reference's
    largest-divisor rule takes one position at 8191 (ROADMAP C6)."""
    (q, k, v), _ = flash_inputs(77, 1, 3, "float32")
    n_products = [0]
    real = torch.matmul

    def counting(a, b):
        n_products[0] += 1
        return real(a, b)

    monkeypatch.setattr(tattn.torch, "matmul", counting)
    for window in (None, 24):
        n_products[0] = 0
        tattn.flash_attention(q, k, v, causal=True, window=window,
                              q_chunk=8, kv_chunk=16)
        want = sum(1 for q0 in range(0, 77, 8) for k0 in range(0, 77, 16)
                   if k0 <= min(q0 + 8, 77) - 1
                   and (window is None or min(k0 + 16, 77) - 1 > q0 - window))
        assert n_products[0] == 2 * want, window
    assert want < 30 < 10 * 5                 # 10 x 5 chunk pairs in all
    assert jattn._pick_chunk(8191, 512) == 1


# ---------------------------------------------------------------------------
# norms and FFNs
# ---------------------------------------------------------------------------
def test_layernorm_and_rmsnorm_match_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 24)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    ln = make_norm("layernorm", 24, "cpu")
    assert isinstance(ln, LayerNorm)
    ln.scale.data.copy_(torch.from_numpy(scale))
    ln.bias.data.copy_(torch.from_numpy(bias))
    want = jblocks.apply_norm({"scale": scale, "bias": bias},
                              jnp.asarray(x), "layernorm")
    np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    rms = make_norm("rmsnorm", 24, "cpu")
    assert isinstance(rms, RMSNorm) and not hasattr(rms, "bias")
    rms.scale.data.copy_(torch.from_numpy(scale))
    want = jblocks.apply_norm({"scale": scale}, jnp.asarray(x), "rmsnorm")
    np.testing.assert_allclose(rms(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    fresh = make_norm("layernorm", 24, "cpu")
    assert torch.equal(fresh.scale, torch.ones(24)) \
        and torch.equal(fresh.bias, torch.zeros(24))


@pytest.mark.parametrize("act,bias", [("geglu", False), ("gelu_mlp", True),
                                      ("swiglu", False)])
def test_ffn_variants_match_reference(act, bias):
    d, f = 16, 40
    rng = np.random.default_rng(2)
    ffn = FFN(d, f, act, bias, torch.Generator().manual_seed(0),
              torch.float32, "cpu")
    leaves = {}
    for name, p in ffn.named_parameters():     # fan-in scaled; biases drawn
        if name.startswith("b_"):
            p.data.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        leaves[name] = p.detach().numpy().copy()
    want_names = ({"w_up", "w_down", "b_up", "b_down"} if act == "gelu_mlp"
                  else {"w_gate", "w_up", "w_down"})
    assert set(leaves) == want_names
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = jffn.apply_ffn(leaves, jnp.asarray(x), act)
    np.testing.assert_allclose(ffn(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------
B, S, CAP = 2, 80, 96
BS, NB = 16, 6                       # pool blocks of 16; 6 a slot (96)
SLOT_TABLES = np.asarray([[7, 2, 10, 4, 0, 9], [3, 11, 5, 1, 8, 6]],
                         np.int32)
PORT_RC = RunConfig(q_chunk=24, kv_chunk=20)      # ragged chunks
JAX_RC = JaxRunConfig(executor="xla", q_chunk=16, kv_chunk=16)


def configs(arch, layers=2):
    return (jax_reduced(jax_get_config(arch), layers=layers, d_model=32,
                        vocab=128),
            reduced(get_config(arch), layers=layers, d_model=32, vocab=128))


def perturbed(tree, seed):
    """The reference's tree with every bias and norm leaf drawn away from
    its zeros / ones init (so that a missed bias or norm shows)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (walk(v) if isinstance(v, (dict, list)) else
                        (np.asarray(v) + rng.standard_normal(np.shape(v))
                         .astype(np.float32) * 0.2
                         if k in ("scale", "bias", "bq", "bk", "bv", "b_up",
                                  "b_down") else np.asarray(v)))
                    for k, v in node.items()}
        return [walk(v) for v in node]
    return walk(tree)


def jax_kv(cache, cfg, layer, key):
    n_body = 2 if cfg.layer_pattern == "local_global" else 1
    g, i = divmod(layer, n_body)
    return np.asarray(cache["body"][f"b{i}"]["kv"][key][g])


def clone(cache):
    return [{k: t.clone() for k, t in layer.items()} for layer in cache]


@pytest.fixture(scope="module", params=DENSE)
def model_runs(request):
    """Per config: (cfg, [(reference logits, reference cache), ...],
    {path: [(logits, cache), ...]}) over prefill + 2 decode steps
    (contiguous) and a prompt-chunk step + 2 decode steps (paged)."""
    arch = request.param
    jcfg, tcfg = configs(arch)
    tree = perturbed(jax.tree.map(np.asarray,
                                  jax_init_params(jcfg, jax.random.key(0))),
                     seed=1)
    params = jax.tree.map(jnp.asarray, tree)
    model = from_jax_params(tcfg, tree, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    dec = rng.integers(0, tcfg.vocab_size, (2, B, 1)).astype(np.int32)
    ref, port = {}, {}

    jc = jax_init_cache(jcfg, B, CAP)
    tc = init_cache(tcfg, B, CAP, device="cpu")
    lj, jc, _ = jax_forward(params, cfg=jcfg, rc=JAX_RC,
                            batch={"tokens": jnp.asarray(prompt)},
                            mode="prefill", cache=jc)
    lt, tc, _ = forward(model, tcfg, PORT_RC,
                        {"tokens": torch.from_numpy(prompt).long()},
                        mode="prefill", cache=tc)
    ref["contiguous"], port["contiguous"] = [(np.asarray(lj), jc)], \
        [(lt.numpy(), clone(tc))]
    for i in range(2):
        pos = np.full((B,), S + i, np.int32)
        lj, jc, _ = jax_forward(params, cfg=jcfg, rc=JAX_RC,
                                batch={"tokens": jnp.asarray(dec[i])},
                                mode="decode", cache=jc, pos=jnp.asarray(pos))
        lt, tc, _ = forward(model, tcfg, PORT_RC,
                            {"tokens": torch.from_numpy(dec[i]).long()},
                            mode="decode", cache=tc,
                            pos=torch.from_numpy(pos))
        ref["contiguous"].append((np.asarray(lj), jc))
        port["contiguous"].append((lt.numpy(), clone(tc)))

    # paged: one step of prompt rows (slot 0 all 80, slot 1 its first 40),
    # then two decode steps of one row a slot
    steps = [(np.concatenate([prompt[0], prompt[1, :40]])[:, None],
              np.r_[np.arange(S), np.arange(40)].astype(np.int32),
              SLOT_TABLES[[0] * S + [1] * 40])]
    for i in range(2):
        steps.append((dec[i], np.asarray([S + i, 40 + i], np.int32),
                      SLOT_TABLES))
    jpools = jax_init_cache(jcfg, 2 * NB, BS)
    jrc = JAX_RC._replace(paged_attn="gather")
    ref["paged"] = []
    for toks, pos, tables in steps:
        lj, jpools, _ = jax_forward(params, cfg=jcfg, rc=jrc,
                                    batch={"tokens": jnp.asarray(toks)},
                                    mode="decode", cache=jpools,
                                    pos=jnp.asarray(pos),
                                    block_tables=jnp.asarray(tables))
        ref["paged"].append((np.asarray(lj), jpools))
    for read in ("gather", "fused"):
        pools = init_cache(tcfg, 2 * NB, BS, device="cpu")
        rc = PORT_RC._replace(paged_attn=read)
        port[read] = []
        for toks, pos, tables in steps:
            lt, pools, _ = forward(model, tcfg, rc,
                                   {"tokens": torch.from_numpy(toks).long()},
                                   mode="decode", cache=pools,
                                   pos=torch.from_numpy(pos),
                                   block_tables=torch.from_numpy(tables))
            port[read].append((lt.numpy(), clone(pools)))
    return tcfg, ref, port


@pytest.mark.parametrize("path", ["contiguous", "gather", "fused"])
def test_logits_and_kv_match_reference(model_runs, path):
    cfg, ref, port = model_runs
    refs = ref["contiguous" if path == "contiguous" else "paged"]
    for step, ((lj, jc), (lt, tc)) in enumerate(zip(refs, port[path])):
        assert lt.shape == lj.shape and np.isfinite(lt).all()
        np.testing.assert_allclose(lt, lj, **TOL, err_msg=f"step {step}")
        for layer in range(cfg.n_layers):
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    tc[layer][key].numpy(), jax_kv(jc, cfg, layer, key),
                    **TOL, err_msg=f"step {step} layer {layer} {key}")
    if cfg.final_logit_softcap is not None:
        assert np.abs(port[path][0][0]).max() < cfg.final_logit_softcap


def test_window_bites_in_contiguous_prefill_only():
    """Reduced gemma2's local layer drops keys more than 64 positions back
    in prefill, so an 80-token prompt's logits differ with and without the
    window; decode keeps the reference's window-free read (C1): the last
    token decoded over a window-free prefill's cache gives the window-free
    prefill's logits, not the windowed one's."""
    _, tcfg = configs("gemma2-9b")
    assert tcfg.local_window == 64 and tcfg.layer_pattern == "local_global"
    model = init_params(tcfg, 0, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(0))
    full, _, _ = forward(model, tcfg, PORT_RC, {"tokens": toks},
                         mode="prefill")
    nowin = tcfg.replace(local_window=None)
    full_nowin, _, _ = forward(model, nowin, PORT_RC, {"tokens": toks},
                               mode="prefill")
    assert not torch.allclose(full, full_nowin, atol=1e-5)
    cache = init_cache(tcfg, 1, CAP, device="cpu")
    forward(model, nowin, PORT_RC, {"tokens": toks[:, :-1]}, mode="prefill",
            cache=cache)
    dec, _, _ = forward(model, tcfg, PORT_RC, {"tokens": toks[:, -1:]},
                        mode="decode", cache=cache, pos=S - 1)
    np.testing.assert_allclose(dec.numpy(), full_nowin.numpy(), **TOL)
    assert not torch.allclose(dec, full, atol=1e-5)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,grads", [("gemma2-9b", True),
                                        ("starcoder2-3b", False)])
def test_loss_and_gradients_match_reference(arch, grads):
    jcfg, tcfg = configs(arch)
    tree = perturbed(jax.tree.map(np.asarray,
                                  jax_init_params(jcfg, jax.random.key(1))),
                     seed=2)
    params = jax.tree.map(jnp.asarray, tree)
    model = from_jax_params(tcfg, tree, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, S)).astype(np.int32)
    jrc = JaxRunConfig(executor="xla", q_chunk=16, kv_chunk=16,
                       loss_chunk=40)
    rc = RunConfig(q_chunk=24, kv_chunk=20, loss_chunk=40)
    batch = {"tokens": torch.from_numpy(toks).long()}
    jb = {"tokens": jnp.asarray(toks)}
    if not grads:
        lj, _ = jax.jit(lambda p: jax_loss_fn(p, jcfg, jrc, jb))(params)
        lt, _ = loss_fn(model, tcfg, rc, batch)
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5,
                                   atol=1e-5)
        return
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jrc, jb), has_aux=True))(params)
    model.requires_grad_(True)
    lt, metrics = loss_fn(model, tcfg, rc, batch)
    assert set(metrics) == {"ce", "tokens"}
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5, atol=1e-5)
    want = from_jax_tree(tcfg, jax.tree.map(np.asarray, gj))
    got = dict(model.named_parameters())
    assert set(got) == set(want) and "head" not in got
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# the repairs the dense family needs
# ---------------------------------------------------------------------------
def test_served_logits_take_the_final_softcap():
    """gemma2's final softcap (30) bounds the served logits, prefill and
    decode: here the head is scaled so that the uncapped logits pass 30."""
    _, tcfg = configs("gemma2-9b")
    model = init_params(tcfg, 0, device="cpu")
    with torch.no_grad():
        model.embed.mul_(500.0)
    toks = torch.arange(10)[None] % tcfg.vocab_size
    cache = init_cache(tcfg, 1, 16, device="cpu")
    capped, _, _ = forward(model, tcfg, RunConfig(), {"tokens": toks},
                           mode="prefill", cache=cache)
    raw, _, _ = forward(model, tcfg.replace(final_logit_softcap=None),
                        RunConfig(), {"tokens": toks}, mode="prefill")
    assert raw.abs().max() > 31 and capped.abs().max() <= 30
    torch.testing.assert_close(capped, 30 * torch.tanh(raw / 30))
    dec, _, _ = forward(model, tcfg, RunConfig(), {"tokens": toks[:, :1]},
                        mode="decode", cache=cache, pos=10)
    assert dec.abs().max() <= 30


def test_n_moe_layers_counts_moe_blocks():
    assert n_moe_layers(configs("gemma2-9b")[1]) == 0
    assert n_moe_layers(reduced(get_config("qwen2-7b"), layers=3)) == 0
    moon = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    assert n_moe_layers(moon) == 2        # one dense layer first
    assert n_moe_layers(get_config("moonshot-v1-16b-a3b")) == 47


@pytest.mark.parametrize("arch,tied", [("smollm-360m", True),
                                       ("qwen2-7b", False)])
def test_tied_configs_have_no_head_and_read_the_embedding(arch, tied):
    _, tcfg = configs(arch)
    assert tcfg.tie_embeddings == tied
    model = init_params(tcfg, 0, device="cpu")
    names = dict(model.named_parameters())
    assert ("head" in names) != tied
    w = head_matrix(model, tcfg)
    assert w.shape == (tcfg.d_model, tcfg.vocab_size)
    if tied:
        assert w.data_ptr() == model.embed.data_ptr()
        toks = torch.arange(6)[None]
        logits, _, _ = forward(model, tcfg, RunConfig(), {"tokens": toks},
                               mode="prefill")
        with torch.no_grad():
            model.embed[:, 0] += 1.0          # moves every logit's input
        moved, _, _ = forward(model, tcfg, RunConfig(), {"tokens": toks},
                              mode="prefill")
        assert not torch.allclose(logits, moved)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", DENSE)
def test_auto_reads_every_dense_pool_with_the_fused_kernel(arch, dtype):
    """``paged_attn="auto"`` on the cuda executor takes the fused read for
    each dense config's pool of 16-position blocks (heads of 64 to 256):
    ``fused_read_refusal`` refuses none, so nothing raises (C4)."""
    cfg = get_config(arch)
    shape = (4, 16, cfg.n_kv_heads, cfg.head_dim)
    pool = {key: torch.empty(shape, dtype=dtype, device="meta")
            for key in ("k", "v")}
    assert paged_fused(RunConfig(executor="cuda"), pool)


def test_odd_depth_of_an_alternating_model_raises():
    with pytest.raises(ValueError, match="groups of two"):
        init_params(get_config("gemma2-9b").replace(n_layers=3), 0,
                    device="cpu")
