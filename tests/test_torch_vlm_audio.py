"""The port's last two families against ``repro`` on the CPU, in fp32:
llama-3.2-vision-11b (``vlm``: groups of attention blocks with a
cross-attention block to image embeddings, second from the end of each)
and hubert-xlarge (``audio``: a bidirectional encoder over feature frames,
trained by masked prediction).

* structure: ``group_structure`` and the parameter count equal the
  reference's, reduced and at full size (9,775,157,248 and 945,104,640;
  the vlm cut to one group of 5 layers 2,141,237,248); the configs field
  for field;
* weights: ``from_jax_params`` carries ``mask_emb`` and the cross blocks
  across with no reference leaf left over;
* train mode: the final hidden states within 1e-5, ``loss_fn`` within
  1e-5 and every gradient within 1e-4 (remat bitwise the same), with
  random non-zero image embeddings and attention chunks that differ from
  the reference's (several chunks, a ragged last one);
* serving the vlm: prefill and two decode steps' logits and every block's
  cache (the cross blocks' image K/V included) within 1e-4, with random
  non-zero image embeddings; the contiguous engine's greedy tokens equal
  the reference engine's (zero image embeddings, as both engines feed);
  the slot helpers reach the cross cache; a cross block's decode takes no
  logit softcap, as the reference's (ROADMAP C15);
* ``make_batch``: the arrays equal the reference's;
* refusals: ``block_tables`` on a cross model, an encoder's
  prefill, ``ServeEngine`` and the serve launcher on an encoder, a vlm
  depth that is not whole groups, a cross block with no image;
* the train launcher on both reduced configs.

The engine feeds zero image embeddings, and the vlm has no QKV biases, so
its cached image K/V are zero and every cross block's output is exactly
0 there: only the forward-level checks, with random embeddings, can see a
broken cross block."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import make_batch as jax_make_batch  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import forward as jax_forward_eager  # noqa: E402
from repro.models.lm import group_structure as jax_group_structure  # noqa
from repro.models.lm import init_cache as jax_init_cache  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.models.lm import loss_fn as jax_loss_fn  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models.lm import (LM, RunConfig, forward, group_structure,
                                   init_cache, layer_kinds, loss_fn,
                                   slice_cache_slots, swap_cache_slots)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv_cache import paged_supported
from repro_torch.weights import (_flatten, _map_jax_tree, from_jax_params,
                                 from_jax_tree)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

VLM, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"
ARCHS = (VLM, AUDIO)
FULL_PARAMS = {VLM: 9_775_157_248, AUDIO: 945_104_640}
VLM_ONE_GROUP_PARAMS = 2_141_237_248          # 5 layers
HIDDEN_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 40
# the reference cuts 40 into chunks of 8; the port's 16 / 12 leave a ragged
# last chunk, so the sums run in another order
JAX_RC = JaxRunConfig(executor="xla", q_chunk=8, kv_chunk=8, loss_chunk=20)
PORT_RC = RunConfig(q_chunk=16, kv_chunk=12, loss_chunk=20)
# leaves the reference inits to constants: drawn away from them
PERTURB = ("scale", "bias", "bq", "bk", "bv", "b_up", "b_down")
jax_forward = jax.jit(jax_forward_eager, static_argnames=("cfg", "rc",
                                                          "mode"))


def configs(arch):
    """Reduced (the vlm at 4 layers: two groups of [cross, attn])."""
    kw = dict(layers=4 if arch == VLM else 2, d_model=32, vocab=128)
    return (jax_reduced(jax_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        return {k: (walk(v) if isinstance(v, (dict, list)) else
                    np.asarray(v) + (rng.standard_normal(np.shape(v))
                                     .astype(np.float32) * 0.2
                                     if k in PERTURB else 0))
                for k, v in node.items()}
    return walk(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference config, port config, reference params, port
    model, numpy batch)."""
    arch = request.param
    jcfg, tcfg = configs(arch)
    tree = perturbed(jax_init_params(jcfg, jax.random.key(0)), 1)
    params = jax.tree.map(jnp.asarray, tree)
    model = from_jax_params(tcfg, tree, device="cpu")
    batch = jax_make_batch(jcfg, B, S, step=0, seed=3)
    return arch, jcfg, tcfg, params, model, batch


def port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ----------------------------------------------------------------------
# structure, configs, weights
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_group_structure_and_parameter_count_match_reference(arch):
    jcfg, tcfg = configs(arch)
    assert group_structure(tcfg) == jax_group_structure(jcfg)
    tree = jax_init_params(jcfg, jax.random.key(0))
    n_ref = sum(np.size(v) for v in jax.tree.leaves(tree))
    model = LM(tcfg, None, torch.float32, torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    cases = [(get_config(arch), jax_get_config(arch), FULL_PARAMS[arch])]
    if arch == VLM:
        cases.append((get_config(arch).replace(n_layers=5),
                      jax_get_config(arch).replace(n_layers=5),
                      VLM_ONE_GROUP_PARAMS))
    for full, jfull, want in cases:
        assert group_structure(full) == jax_group_structure(jfull)
        shapes = jax.eval_shape(lambda k: jax_init_params(jfull, k),
                                jax.random.key(0))
        assert sum(int(np.prod(v.shape)) for v in
                   jax.tree.leaves(shapes)) == want
        model = LM(full, None, torch.bfloat16, torch.device("meta"))
        assert sum(p.numel() for p in model.parameters()) == want
    if arch == VLM:
        assert group_structure(get_config(arch))[1:3] == (
            ["attn", "attn", "attn", "cross", "attn"], 8)
        assert layer_kinds(tcfg) == ["cross", "attn"] * 2
        assert not paged_supported(tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references_field_by_field(arch):
    jred, tred = configs(arch)
    for tcfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                       (tred, jred)):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_weights_carry_across_with_no_leaf_left_over(pair):
    arch, jcfg, tcfg, params, model, _ = pair
    flat = _flatten(jax.tree.map(np.asarray, params))
    names = dict(model.named_parameters())
    mapped, dead = _map_jax_tree(tcfg, jax.tree.map(np.asarray, params))
    assert set(mapped) == set(names) and not dead
    assert {src for src, _ in mapped.values()} == set(flat)
    assert ("mask_emb" in names) == (arch == AUDIO)
    assert ("embed" in names) == (arch == VLM)
    if arch == VLM:                    # layer 0 is a cross block
        assert model.layers[0].kind == "cross"
        np.testing.assert_array_equal(
            names["layers.2.attn.wq"].detach().numpy(),
            flat["body.b0.attn.wq"][1])
    with pytest.raises(ValueError, match="no port parameter takes"):
        from_jax_params(tcfg, dict(jax.tree.map(np.asarray, params),
                                   stray=np.zeros(2)), device="cpu")


# ----------------------------------------------------------------------
# train mode
# ----------------------------------------------------------------------
def test_train_hidden_states_match_reference(pair):
    _, jcfg, tcfg, params, model, batch = pair
    hj, _, _ = jax_forward(params, cfg=jcfg, rc=JAX_RC,
                           batch=jax.tree.map(jnp.asarray, batch),
                           mode="train")
    with torch.no_grad():
        ht, _, _ = forward(model, tcfg, PORT_RC, port_batch(batch),
                           mode="train")
    assert ht.shape == (B, S, tcfg.d_model)
    torch.testing.assert_close(ht, torch.from_numpy(np.array(hj)),
                               **HIDDEN_TOL)


def test_loss_and_gradients_match_reference(pair):
    arch, jcfg, tcfg, params, model, batch = pair
    jb = jax.tree.map(jnp.asarray, batch)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, JAX_RC, jb), has_aux=True))(params)
    want = from_jax_tree(tcfg, jax.tree.map(np.asarray, gj))
    tb = port_batch(batch)
    got = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        model.requires_grad_(True)
        lt, mt = loss_fn(model, tcfg, PORT_RC._replace(remat=remat), tb)
        lt.backward()
        model.requires_grad_(False)
        got[remat] = (lt.detach(), {n: p.grad.clone() for n, p in
                                    model.named_parameters()})
    lt, grads = got[False]
    assert float(mt["tokens"]) == float(mj["tokens"]) > 0
    if arch == AUDIO:                  # the masked frames only
        assert float(mt["tokens"]) == batch["mask"].sum()
    np.testing.assert_allclose(lt.item(), float(lj), **LOSS_TOL)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL,
                                   err_msg=name)
        assert torch.equal(g, got[True][1][name]), name
    assert torch.equal(lt, got[True][0])


# ----------------------------------------------------------------------
# serving the vlm
# ----------------------------------------------------------------------
def jax_block_kv(cache, cfg, layer, key):
    per = cfg.cross_attn_every
    g, i = divmod(layer, per)
    return np.asarray(cache["body"][f"b{i}"]["kv"][key][g])


@pytest.fixture(scope="module")
def vlm_pair():
    jcfg, tcfg = configs(VLM)
    tree = perturbed(jax_init_params(jcfg, jax.random.key(4)), 5)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            from_jax_params(tcfg, tree, device="cpu"))


def test_vlm_prefill_decode_logits_and_caches_match_reference(vlm_pair):
    jcfg, tcfg, params, model = vlm_pair
    rng = np.random.default_rng(6)
    P, cap = 20, 24
    prompt = rng.integers(0, tcfg.vocab_size, (B, P)).astype(np.int32)
    img = (rng.standard_normal((B, tcfg.n_image_tokens, tcfg.d_model))
           * 0.3).astype(np.float32)
    dec = rng.integers(0, tcfg.vocab_size, (2, B, 1)).astype(np.int32)
    jc = jax_init_cache(jcfg, B, cap)
    tc = init_cache(tcfg, B, cap, device="cpu")
    steps = [("prefill", {"tokens": prompt, "image_embeds": img}, None)]
    steps += [("decode", {"tokens": dec[i]}, np.full((B,), P + i, np.int32))
              for i in range(2)]
    for mode, b, pos in steps:
        lj, jc, _ = jax_forward(params, cfg=jcfg, rc=JAX_RC,
                                batch=jax.tree.map(jnp.asarray, b),
                                mode=mode, cache=jc,
                                pos=None if pos is None else jnp.asarray(pos))
        lt, tc, _ = forward(model, tcfg, PORT_RC,
                            {k: torch.from_numpy(v).long() if k == "tokens"
                             else torch.from_numpy(v) for k, v in b.items()},
                            mode=mode, cache=tc,
                            pos=None if pos is None else torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=mode)
        for layer, kind in enumerate(layer_kinds(tcfg)):
            for key in ("k", "v"):
                want = jax_block_kv(jc, tcfg, layer, key)
                assert tc[layer][key].shape == want.shape
                np.testing.assert_allclose(tc[layer][key].numpy(), want,
                                           **TOL, err_msg=f"{mode} {layer}")
            if kind == "cross":        # the image's K/V, not zeros
                assert tc[layer]["k"].abs().min() > 0


def test_slot_helpers_reach_the_cross_cache():
    _, tcfg = configs(VLM)
    cache = init_cache(tcfg, 3, 8, device="cpu")
    cross = layer_kinds(tcfg).index("cross")
    assert cache[cross]["k"].shape == (3, tcfg.n_image_tokens,
                                       tcfg.n_kv_heads, tcfg.head_dim)
    for layer in cache:
        for t in layer.values():
            t.copy_(torch.arange(3.0).reshape(3, *([1] * (t.dim() - 1))))
    swap_cache_slots(cache, 0, 2)
    assert cache[cross]["v"][0].eq(2).all() and cache[cross]["v"][2].eq(0
                                                                        ).all()
    slice_cache_slots(cache, 1, 1)[cross]["k"].zero_()
    assert cache[cross]["k"][1].eq(0).all()


def test_vlm_engine_tokens_match_reference_engine(vlm_pair):
    """Three requests on two slots (a retirement compacts the cross cache
    with the rest), then the same with the request in slot 0 preempted
    after two steps (its rows dropped; the resume replays the prompt, which
    writes its image K/V again)."""
    jcfg, tcfg, params, model = vlm_pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, 10).astype(np.int32)
               for _ in range(3)]
    max_new, cap = (3, 6, 4), 24
    jeng = JaxServeEngine(jcfg, params, slots=2, capacity=cap)
    assert not jeng.paged
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    jeng.run(jreqs, max_steps=64)
    want = [r.out for r in jreqs]
    eng = ServeEngine(tcfg, model, slots=2, capacity=cap, device="cpu")
    assert not eng.paged and eng.kv_block_size == 0
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    eng.run(reqs, max_steps=64)
    assert [r.out for r in reqs] == want
    eng = ServeEngine(tcfg, model, slots=2, capacity=cap, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    pending = eng.enqueue(reqs)
    for i in range(64):
        if i == 2:
            pending.append(eng.preempt(0))
        eng.schedule(pending)
        if eng.step() == 0 and not pending:
            break
    assert (eng.n_preempted, eng.n_resumed) == (1, 1)
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == want


def test_cross_decode_takes_no_softcap_as_the_reference():
    """ROADMAP C15: the reference's cross decode runs without the logit
    softcap its prefill applies.  With no softcap a decoded token's logits
    are the prefill's of the same token; with a softcap of 0.5 they are not,
    in the reference and in the port alike, which agree within 1e-4."""
    jcfg, tcfg = configs(VLM)
    tree = perturbed(jax_init_params(jcfg, jax.random.key(8)), 9)
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(10)
    P, cap = 12, 16
    toks = rng.integers(0, tcfg.vocab_size, (1, P + 1)).astype(np.int32)
    img = (rng.standard_normal((1, tcfg.n_image_tokens, tcfg.d_model))
           * 0.3).astype(np.float32)

    def port(cfg):
        model = from_jax_params(cfg, tree, device="cpu")
        b = {"tokens": torch.from_numpy(toks).long(),
             "image_embeds": torch.from_numpy(img)}
        whole, _, _ = forward(model, cfg, PORT_RC, b, mode="prefill",
                              cache=init_cache(cfg, 1, cap, device="cpu"))
        cache = init_cache(cfg, 1, cap, device="cpu")
        forward(model, cfg, PORT_RC, {"tokens": b["tokens"][:, :P],
                                      "image_embeds": b["image_embeds"]},
                mode="prefill", cache=cache)
        dec, _, _ = forward(model, cfg, PORT_RC,
                            {"tokens": b["tokens"][:, P:]}, mode="decode",
                            cache=cache, pos=torch.tensor([P]))
        return whole.numpy(), dec.numpy()
    whole, dec = port(tcfg)
    np.testing.assert_allclose(dec, whole, **TOL)
    jcfg, tcfg = (c.replace(attn_logit_softcap=0.5) for c in (jcfg, tcfg))
    whole, dec = port(tcfg)
    jb = {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)}
    jwhole, _, _ = jax_forward(params, cfg=jcfg, rc=JAX_RC, batch=jb,
                               mode="prefill", cache=jax_init_cache(jcfg, 1,
                                                                    cap))
    _, jc, _ = jax_forward(params, cfg=jcfg, rc=JAX_RC,
                           batch={"tokens": jb["tokens"][:, :P],
                                  "image_embeds": jb["image_embeds"]},
                           mode="prefill", cache=jax_init_cache(jcfg, 1, cap))
    jdec, _, _ = jax_forward(params, cfg=jcfg, rc=JAX_RC,
                             batch={"tokens": jb["tokens"][:, P:]},
                             mode="decode", cache=jc,
                             pos=jnp.asarray([P], jnp.int32))
    np.testing.assert_allclose(whole, np.asarray(jwhole), **TOL)
    np.testing.assert_allclose(dec, np.asarray(jdec), **TOL)
    assert np.abs(dec - whole).max() > 1e-2
    assert np.abs(np.asarray(jdec) - np.asarray(jwhole)).max() > 1e-2


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("accum", [1, 2])
def test_make_batch_equals_reference(arch, accum):
    jcfg, tcfg = configs(arch)
    want = jax_make_batch(jcfg, 3, 16, step=2, accum=accum, seed=5)
    got = make_batch(tcfg, 3, 16, step=2, accum=accum, seed=5)
    keys = {VLM: {"tokens", "image_embeds"},
            AUDIO: {"features", "labels", "mask"}}[arch]
    assert set(got) == set(want) == keys
    for k in keys:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
def test_refusals(pair):
    arch, _, tcfg, _, model, batch = pair
    tb = port_batch(batch)
    if arch == AUDIO:
        with pytest.raises(ValueError, match="encoder-only: no decode path"):
            forward(model, tcfg, PORT_RC, tb, mode="prefill",
                    cache=init_cache(tcfg, B, S, device="cpu"))
        with pytest.raises(ValueError, match="encoder-only: no decode path"):
            ServeEngine(tcfg, model, device="cpu")
        with pytest.raises(SystemExit, match="encoder-only: no decode path"):
            serve_main(["--arch", arch, "--reduce", "--device", "cpu"])
        return
    toks = tb["tokens"][:, :1].long()
    with pytest.raises(ValueError, match="cross blocks have no positional"):
        forward(model, tcfg, PORT_RC, {"tokens": toks}, mode="decode",
                cache=init_cache(tcfg, 4, 4, device="cpu"),
                pos=torch.zeros(B, dtype=torch.int32),
                block_tables=torch.zeros((B, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="image_embeds"):
        forward(model, tcfg, PORT_RC, {"tokens": tb["tokens"].long()},
                mode="train")
    with pytest.raises(ValueError, match="multiple of it, not 3"):
        group_structure(tcfg.replace(n_layers=3))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_reduced(arch, capsys):
    out = train_main(["--arch", arch, "--reduce", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "done: ce" in capsys.readouterr().out
