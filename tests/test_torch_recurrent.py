"""The port's recurrent families against ``repro`` on the CPU, in fp32:
rwkv6-1.6b (``ssm``: time-mix and channel-mix layers) and zamba2-7b
(``hybrid``: Mamba2 layers and shared attention blocks).

* modules: ``time_mix``, ``channel_mix``, ``ssm_block`` and ``ssd_chunked``
  against the reference's on the same inputs and weights (the reference's
  ``init_*`` leaves with every fp32 vector and norm drawn away from its
  init), from a zero and from a random cache: outputs and new caches
  within 1e-5.  ``ssd_chunked`` runs ceil(S / chunk) chunks (at S = 37 and
  chunk 16: 3, where the reference's divisor rule runs 37, ROADMAP C12);
* model: reduced rwkv6 and zamba2 reduced with ``layers=7`` (2 groups, so
  ``g % 2`` takes both shared blocks, then the suffix's own block; the
  default reduced zamba2 has no group, ROADMAP C11): prefill logits and
  every block's cache within 1e-4, a decode step's logits against the
  reference's and against the prefill of one more token, 8 greedy tokens
  through ``forward`` equal to the reference's;
* configs: both, full and reduced, field for field the reference's;
* weights: the port's parameter count is the reference's less the groups'
  unread ``body.b0`` blocks (also at full size: 7.162 B for zamba2), the
  groups' ``shared_attn`` layers are the two ``shared`` modules and the
  suffix's is a third; ``from_jax_params`` refuses a tree with any other
  leaf left over; ``init_cache`` has one cache per block (95 for zamba2);
* what A8 once refused runs: train mode's hidden states within 1e-5 of
  the reference's, ``rc.ep`` bitwise the plain prefill, a train forward
  under a 1x1 grid's rules bitwise the plain one (here and for the vlm and
  audio families, whose structures are the reference's); still refused:
  a hybrid depth under 3 and a paged read of a recurrent block
  (tests/test_torch_recurrent_train.py holds their training)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import rwkv6 as jax_rwkv  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import forward as jax_forward  # noqa: E402
from repro.models.lm import group_structure as jax_group_structure  # noqa
from repro.models.lm import init_cache as jax_init_cache  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed.ctx import use_rules
from repro_torch.distributed.group import make_grid
from repro_torch.models import rwkv6, ssm
from repro_torch.models.lm import (LM, RunConfig, forward, group_structure,
                                   init_cache, init_params, layer_kinds)
from repro_torch.train.step import grid_rules
from repro_torch.weights import _flatten, _map_jax_tree, from_jax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"rwkv6-1.6b": {}, "zamba2-7b": {"layers": 7}}
# leaves the reference inits to constants: drawn away from them
PERTURB = ("scale", "bias", "mu", "w0", "u", "a_log", "dt_bias", "d_skip",
           "conv_b")


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


def loaded(module, tree):
    """``module`` holding the reference tree's leaves, by name."""
    flat = _flatten(tree)
    names = dict(module.named_parameters())
    assert set(names) == set(flat)
    with torch.no_grad():
        for n, p in names.items():
            p.copy_(t(flat[n]))
    return module


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, tol=TOL):
    torch.testing.assert_close(got, t(want), **tol)


def configs(arch):
    kw = dict(ARCHS[arch])
    return (jax_reduced(jax_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


# ----------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def rwkv_parts():
    jcfg, tcfg = configs("rwkv6-1.6b")
    k1, k2 = jax.random.split(jax.random.key(0))
    d = tcfg.d_model
    tm = perturbed(jax_rwkv.init_time_mix(k1, d, jcfg.rwkv), 1)
    cm = perturbed(jax_rwkv.init_channel_mix(k2, d, jcfg.d_ff), 2)
    return jcfg, tcfg, tm, cm


def rwkv_cache(rng, B, d, H, n):
    return {"shift": rng.standard_normal((B, 1, d)).astype(np.float32),
            "state": (rng.standard_normal((B, H, n, n)) * 0.3
                      ).astype(np.float32)}


@pytest.mark.parametrize("from_cache", [False, True])
def test_time_mix_matches_reference(rwkv_parts, from_cache):
    jcfg, tcfg, tm, _ = rwkv_parts
    d, n = tcfg.d_model, tcfg.rwkv.head_size
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    cache = rwkv_cache(rng, 2, d, d // n, n) if from_cache else \
        {"shift": np.zeros((2, 1, d), np.float32),
         "state": np.zeros((2, d // n, n, n), np.float32)}
    want, wc = jax.jit(lambda p, x, c: jax_rwkv.time_mix(
        p, x, jcfg.rwkv, cache=c))(tm, x, cache)
    mod = loaded(rwkv6.TimeMix(d, tcfg.rwkv, None, torch.float32, "cpu"), tm)
    got, gc = rwkv6.time_mix(mod, t(x), tcfg.rwkv,
                             cache={k: t(v) for k, v in cache.items()})
    close(got, want)
    close(gc["shift"], wc["shift"])
    close(gc["state"], wc["state"])
    assert gc["state"].dtype == torch.float32
    # no cache: zeros in, no cache out
    got0, none = rwkv6.time_mix(mod, t(x), tcfg.rwkv)
    assert none is None
    if not from_cache:
        torch.testing.assert_close(got0, got, rtol=0, atol=0)


@pytest.mark.parametrize("from_cache", [False, True])
def test_channel_mix_matches_reference(rwkv_parts, from_cache):
    jcfg, tcfg, _, cm = rwkv_parts
    d = tcfg.d_model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    shift = (rng.standard_normal((2, 1, d)) if from_cache
             else np.zeros((2, 1, d))).astype(np.float32)
    want, wc = jax.jit(lambda p, x, c: jax_rwkv.channel_mix(
        p, x, cache=c))(cm, x, {"shift": shift})
    mod = loaded(rwkv6.ChannelMix(d, tcfg.d_ff, None, torch.float32, "cpu"),
                 cm)
    got, gc = rwkv6.channel_mix(mod, t(x), cache={"shift": t(shift)})
    close(got, want)
    close(gc["shift"], wc["shift"])


def test_rwkv_decode_steps_continue_the_prefill(rwkv_parts):
    """Time-mix over 9 positions equals 6 positions, then 3 steps of one
    from the cache (the recurrence carries over exactly)."""
    _, tcfg, tm, _ = rwkv_parts
    d, n = tcfg.d_model, tcfg.rwkv.head_size
    mod = loaded(rwkv6.TimeMix(d, tcfg.rwkv, None, torch.float32, "cpu"), tm)
    x = torch.randn(2, 9, d, generator=torch.Generator().manual_seed(5))
    zero = {"shift": torch.zeros(2, 1, d),
            "state": torch.zeros(2, d // n, n, n)}
    whole, wc = rwkv6.time_mix(mod, x, tcfg.rwkv, cache=zero)
    part, c = rwkv6.time_mix(mod, x[:, :6], tcfg.rwkv, cache=zero)
    outs = [part]
    for i in range(6, 9):
        o, c = rwkv6.time_mix(mod, x[:, i:i + 1], tcfg.rwkv, cache=c)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), whole, **TOL)
    torch.testing.assert_close(c["state"], wc["state"], **TOL)


@pytest.fixture(scope="module")
def mamba_parts():
    jcfg, tcfg = configs("zamba2-7b")
    p = perturbed(jax_ssm.init_ssm(jax.random.key(1), tcfg.d_model,
                                   jcfg.ssm), 6)
    return jcfg, tcfg, p


@pytest.mark.parametrize("from_cache", [False, True])
def test_ssm_block_matches_reference(mamba_parts, from_cache):
    """S = 37 (prime): the reference's chunk falls to 1, the port runs
    chunks of 16, 16 and 5."""
    jcfg, tcfg, p = mamba_parts
    d, s = tcfg.d_model, tcfg.ssm
    d_in = s.expand * d
    H, C = d_in // s.head_dim, d_in + 2 * s.n_groups * s.d_state
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    cache = {"conv": rng.standard_normal((2, s.conv_kernel - 1, C)),
             "state": rng.standard_normal((2, H, s.head_dim, s.d_state))
             * 0.3} if from_cache else \
        {"conv": np.zeros((2, s.conv_kernel - 1, C)),
         "state": np.zeros((2, H, s.head_dim, s.d_state))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    want, wc = jax.jit(lambda p, x, c: jax_ssm.ssm_block(
        p, x, jcfg.ssm, cache=c))(p, x, cache)
    mod = loaded(ssm.Mamba2(d, tcfg.ssm, None, torch.float32, "cpu"), p)
    got, gc = ssm.ssm_block(mod, t(x), tcfg.ssm,
                            cache={k: t(v) for k, v in cache.items()})
    close(got, want)
    close(gc["conv"], wc["conv"])
    close(gc["state"], wc["state"])
    assert gc["state"].dtype == torch.float32


@pytest.mark.parametrize("S", [37, 32, 5, 1])
def test_ssd_chunked_fixed_chunks_match_reference(S, monkeypatch):
    """Chunks of 16 with a ragged last one: ceil(S / 16) chunks (counted as
    the state's hand-overs), y and the final state within 1e-5 of the
    reference's divisor-sized chunks."""
    rng = np.random.default_rng(S)
    B, H, P, G, N, chunk = 2, 4, 8, 1, 16, 16
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32)
    want_y, want_s = jax.jit(lambda *z: jax_ssm.ssd_chunked(
        *z[:5], chunk, z[5]))(xh, dt, Bm, Cm, a, s0)
    handovers = []
    addcmul = torch.addcmul

    def counting(*args, **kw):
        handovers.append(1)
        return addcmul(*args, **kw)
    monkeypatch.setattr(torch, "addcmul", counting)
    y, s = ssm.ssd_chunked(t(xh), t(dt), t(Bm), t(Cm), t(a), chunk, t(s0))
    monkeypatch.undo()
    assert len(handovers) == -(-S // chunk)
    close(y, want_y)
    close(s, want_s)


# ----------------------------------------------------------------------
# model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module", params=list(ARCHS))
def model_pair(request):
    jcfg, tcfg = configs(request.param)
    tree = perturbed(jax_init_params(jcfg, jax.random.key(2)), 8)
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, tree, params, from_jax_params(tcfg, tree,
                                                     device="cpu")


def jax_cache_layers(jcfg, cache):
    """The reference's cache as the port's: one flat dict per block."""
    prefix, body, n_groups, suffix = group_structure(jcfg)

    def flat(kind, c):
        if kind == "rwkv":
            return {"tm_shift": c["tm"]["shift"], "tm_state": c["tm"]["state"],
                    "cm_shift": c["cm"]["shift"]}
        return dict(c["kv"]) if "kv" in c else dict(c)
    out = [flat(k, cache["prefix"][i]) for i, k in enumerate(prefix)]
    for g in range(n_groups):
        for i, k in enumerate(body):
            out.append(flat(k, jax.tree.map(lambda v: v[g],
                                            cache["body"][f"b{i}"])))
    out += [flat(k, cache["suffix"][i]) for i, k in enumerate(suffix)]
    return out


def jax_steps(jcfg):
    rc = JaxRunConfig()
    prefill = jax.jit(lambda p, b, c: jax_forward(
        p, jcfg, rc, b, mode="prefill", cache=c)[:2])
    decode = jax.jit(lambda p, b, c, pos: jax_forward(
        p, jcfg, rc, b, mode="decode", cache=c, pos=pos)[:2])
    return prefill, decode


def test_prefill_decode_and_cache_match_reference(model_pair):
    jcfg, tcfg, _, params, model = model_pair
    rng = np.random.default_rng(9)
    S, cap = 21, 32
    toks = rng.integers(0, tcfg.vocab_size, (2, S + 1)).astype(np.int32)
    prefill, decode = jax_steps(jcfg)
    jl, jc = prefill(params, {"tokens": toks[:, :S]},
                     jax_init_cache(jcfg, 2, cap))
    tc = init_cache(tcfg, 2, cap, device="cpu")
    tl, _, _ = forward(model, tcfg, RunConfig(),
                       {"tokens": torch.as_tensor(toks[:, :S]).long()},
                       mode="prefill", cache=tc)
    close(tl, jl, MODEL_TOL)
    want = jax_cache_layers(jcfg, jc)
    assert len(want) == len(tc) == len(layer_kinds(tcfg))
    for i, (w, g) in enumerate(zip(want, tc)):
        assert set(w) == set(g), (i, set(w), set(g))
        for k in w:
            close(g[k], w[k], MODEL_TOL)
    # one decode step: the reference's, and the prefill of S + 1 tokens
    jl2, _ = decode(params, {"tokens": toks[:, S:]}, jc, S)
    tl2, _, _ = forward(model, tcfg, RunConfig(),
                        {"tokens": torch.as_tensor(toks[:, S:]).long()},
                        mode="decode", cache=tc, pos=S)
    close(tl2, jl2, MODEL_TOL)
    whole, _, _ = forward(model, tcfg, RunConfig(),
                          {"tokens": torch.as_tensor(toks).long()},
                          mode="prefill",
                          cache=init_cache(tcfg, 2, cap, device="cpu"))
    torch.testing.assert_close(tl2, whole, **MODEL_TOL)


def test_greedy_tokens_through_forward_match_reference(model_pair):
    jcfg, tcfg, _, params, model = model_pair
    rng = np.random.default_rng(10)
    S, n_new, cap = 13, 8, 24
    toks = rng.integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    prefill, decode = jax_steps(jcfg)
    jl, jc = prefill(params, {"tokens": toks}, jax_init_cache(jcfg, 2, cap))
    tc = init_cache(tcfg, 2, cap, device="cpu")
    tl, _, _ = forward(model, tcfg, RunConfig(),
                       {"tokens": torch.as_tensor(toks).long()},
                       mode="prefill", cache=tc)
    jt, tt = [np.asarray(jnp.argmax(jl, -1))], [tl.argmax(-1)]
    for i in range(n_new - 1):
        jl, jc = decode(params, {"tokens": jt[-1][:, None].astype(np.int32)},
                        jc, S + i)
        jt.append(np.asarray(jnp.argmax(jl, -1)))
        tl, _, _ = forward(model, tcfg, RunConfig(),
                           {"tokens": tt[-1][:, None]}, mode="decode",
                           cache=tc, pos=S + i)
        tt.append(tl.argmax(-1))
    assert np.stack(jt, 1).tolist() == torch.stack(tt, 1).tolist()


# ----------------------------------------------------------------------
# weights and structure
# ----------------------------------------------------------------------
def test_parameter_count_is_the_references_less_unread_blocks(model_pair):
    jcfg, tcfg, tree, _, model = model_pair
    ref = sum(np.size(v) for v in _flatten(tree).values())
    dead = _map_jax_tree(tcfg, tree)[1]
    if tcfg.family == "hybrid":
        assert dead and set(dead) == {
            f"body.b0.{k}" for k in _flatten(tree["body"]["b0"])}
        assert _flatten(tree["body"]["b0"])["attn.wq"].shape[0] == 2
    else:
        assert dead == []
    flat = _flatten(tree)
    assert sum(p.numel() for p in model.parameters()) \
        == ref - sum(np.size(flat[k]) for k in dead)


@pytest.mark.parametrize("arch,n_params,n_blocks", [
    ("rwkv6-1.6b", 1_584_095_232, 24), ("zamba2-7b", 7_162_186_960, 95)])
def test_full_size_parameters_and_block_caches(arch, n_params, n_blocks):
    """At full size (on the meta device: shapes only): 1.584 B and 7.162 B
    parameters; the reference's zamba2 tree holds 9.834 B, 2.672 B of them
    in the unread ``body.b0`` blocks.  One cache a block."""
    cfg = get_config(arch)
    model = LM(cfg, None, torch.bfloat16, torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == n_params
    kinds = layer_kinds(cfg)
    assert len(kinds) == len(model.layers) == n_blocks
    if arch == "zamba2-7b":
        assert kinds.count("shared_attn") == 14
        assert kinds.count("mamba") == cfg.n_layers == 81
        shape = jax.eval_shape(lambda: jax_init_params(
            jax_get_config(arch), jax.random.key(0)))
        total = sum(np.prod(v.shape) for v in jax.tree.leaves(shape))
        dead = sum(np.prod(v.shape)
                   for v in jax.tree.leaves(shape["body"]["b0"]))
        assert (total, dead) == (9_834_051_792, 2_671_864_832)
        assert total - dead == n_params
    cache = init_cache(cfg, 1, 2, dtype=torch.bfloat16, device="cpu")
    assert len(cache) == n_blocks
    for kind, c in zip(kinds, cache):
        want = {"rwkv": {"tm_shift", "tm_state", "cm_shift"},
                "mamba": {"conv", "state"}}.get(kind, {"k", "v"})
        assert set(c) == want
        for key in ("tm_state", "state"):
            if key in c:
                assert c[key].dtype == torch.float32


def test_shared_blocks_are_one_module_each_and_the_suffix_its_own():
    _, tcfg = configs("zamba2-7b")
    model = LM(tcfg, None, torch.float32, torch.device("meta"))
    kinds = layer_kinds(tcfg)
    assert kinds == (["shared_attn", "mamba", "mamba"] * 2
                     + ["shared_attn"] + ["mamba"] * 3)
    assert model.layers[0] is model.shared[0]
    assert model.layers[3] is model.shared[1]
    suffix = model.layers[6]
    assert suffix.kind == "shared_attn"
    assert all(suffix is not s for s in model.shared)
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("shared.1.") for n in names)
    assert not any(n.startswith(("layers.0.", "layers.3.")) for n in names)
    assert any(n.startswith("layers.6.attn.") for n in names)


def test_from_jax_params_checks_the_skipped_leaves(model_pair):
    _, tcfg, tree, _, _ = model_pair
    with pytest.raises(ValueError, match="no port parameter takes"):
        from_jax_params(tcfg, dict(tree, stray=np.zeros(2)), device="cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_are_the_references_field_by_field(arch):
    jred, tred = configs(arch)
    for tcfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                       (tred, jred)):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


# ----------------------------------------------------------------------
# what ROADMAP A8 once refused, and what stays refused
# ----------------------------------------------------------------------
def test_training_grids_ep_and_other_families_raise(model_pair):
    """Train mode, ``rc.ep`` and a grid once raised on these families
    (ROADMAP A8): train mode's hidden states now match the reference's,
    ``rc.ep`` (the reference reads it in MoE layers only) leaves the
    prefill bitwise as it was, and a train forward under a 1x1 grid's
    rules is bitwise the plain one.  A paged read of a recurrent block
    still raises."""
    jcfg, tcfg, _, params, model = model_pair
    toks = np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks).long()}
    want = jax.jit(lambda p, b: jax_forward(p, jcfg, JaxRunConfig(), b,
                                            mode="train")[0])(
        params, {"tokens": toks})
    with torch.no_grad():
        hidden = forward(model, tcfg, RunConfig(), batch, mode="train")[0]
        close(hidden, want, TOL)
        plain = forward(model, tcfg, RunConfig(), batch, mode="prefill",
                        cache=init_cache(tcfg, 2, 16, device="cpu"))[0]
        ep = forward(model, tcfg, RunConfig(ep=True), batch, mode="prefill",
                     cache=init_cache(tcfg, 2, 16, device="cpu"))[0]
        assert torch.equal(ep, plain)
        grid = make_grid(1, 1, verbose=False)
        with use_rules(grid, grid_rules(tcfg, grid, 2)):
            on_grid = forward(model, tcfg, RunConfig(), batch,
                              mode="train")[0]
        assert torch.equal(on_grid, hidden)
    cache = init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="no positional KV cache to page"):
        forward(model, tcfg, RunConfig(), {"tokens": batch["tokens"][:1, :1]},
                mode="decode", cache=cache, pos=torch.zeros(1),
                block_tables=torch.zeros((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "hubert-xlarge"])
def test_vlm_and_audio_families_name_roadmap_a8(arch):
    """The port builds both families (tests/test_torch_vlm_audio.py holds
    them against the reference, tests/test_torch_family_grid.py on grids
    of ranks); what ROADMAP A8 kept of them, a grid, runs: a train forward
    under a 1x1 grid's rules is bitwise the plain one."""
    cfg = get_config(arch)
    assert group_structure(cfg) == jax_group_structure(jax_get_config(arch))
    tcfg = reduced(cfg)
    model = init_params(tcfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        tcfg, 2, 8, step=0).items()}
    grid = make_grid(1, 1, verbose=False)
    with torch.no_grad():
        want = forward(model, tcfg, RunConfig(), batch, mode="train")[0]
        with use_rules(grid, grid_rules(tcfg, grid, 2)):
            got = forward(model, tcfg, RunConfig(), batch, mode="train")[0]
    assert torch.equal(got, want)


def test_hybrid_depth_under_three_raises():
    with pytest.raises(ValueError, match=">= 3"):
        group_structure(get_config("zamba2-7b").replace(n_layers=2))
    assert group_structure(get_config("zamba2-7b").replace(n_layers=3)) \
        == ([], ["shared_attn"] + ["mamba"] * 6, 0,
            ["shared_attn", "mamba", "mamba", "mamba"])
