"""The port's training path with multi-head latent attention against the
reference's, on reduced deepseek-v2-236b (3 layers: 1 dense-FFN layer and
2 MoE layers; E=8, k=2, block_m=8, two shared experts, softmax gating
without renormalisation and routed_scale 16; the reduced MLA ranks
48/32/16/8/16), in fp32 on the CPU.

Weights are carried across with ``from_jax_params`` and gradient or
parameter trees compared through ``from_jax_tree``, as in
``test_torch_train.py``: the loss within 1e-5 and every gradient within
1e-4 of the reference's ``loss_fn`` under ``fixed`` and ``dynamic``; two
``make_train_step`` steps at accum 1 and 2 (eps 1e-3) with loss,
``grad_norm`` and ``lr`` within 1e-5, every parameter within 1e-6 and
both AdamW moments within 1e-4;
gradients with remat bitwise those without.  MLA's prefill and train
attention is the chunked ``flash_attention`` at ``RunConfig.q_chunk`` /
``kv_chunk``: with chunks of 8 over 20 positions (ragged on the port's
side; the reference cuts each axis into 5s) the prefill logits and the
train loss hold the reference's within 1e-4, and neither path calls the
whole-score ``attention``.  A run resumed from its checkpoint ends bitwise
where an uninterrupted one does.  Last, the launcher trains reduced
deepseek on the CPU."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro.models.lm import loss_fn as jax_loss_fn
from repro.optim import adamw as jax_adamw
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import device_batch, make_batch
from repro_torch.launch import train as train_launcher
from repro_torch.models import mla as port_mla
from repro_torch.models.lm import RunConfig, forward, init_cache, loss_fn
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step, train_state
from repro_torch.weights import from_jax_params, from_jax_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "deepseek-v2-236b"
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)   # m and v of gradients held at 1e-4
B, S, LOSS_CHUNK = 2, 16, 8          # 15 loss positions: 3 strided chunks
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-3)
RAGGED_S, RAGGED_CHUNK = 20, 8       # 8 + 8 + 4 here; 5s in the reference


def configs():
    return (jax_reduced(jax_get_config(ARCH), layers=3),
            reduced(get_config(ARCH), layers=3))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, tcfg = configs()
    assert tcfg.mla is not None and tcfg.moe.first_dense_layers == 1
    assert tcfg.moe.n_shared_experts == 2 and tcfg.moe.gating == "softmax"
    assert not tcfg.moe.norm_topk and tcfg.moe.routed_scale == 16.0
    return jax_init_params(jcfg, jax.random.key(0))


def port_model(params):
    _, tcfg = configs()
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return model.requires_grad_(True)


def tokens(seed, shape=(B, S)):
    _, tcfg = configs()
    return np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, shape).astype(np.int32)


def jax_value_and_grad(params, jrc, toks):
    jcfg, _ = configs()
    fn = jax.jit(jax.value_and_grad(
        lambda p, t: jax_loss_fn(p, jcfg, jrc, {"tokens": t}), has_aux=True))
    return fn(params, jnp.asarray(toks))


def port_grads(model, rc, toks):
    _, tcfg = configs()
    loss, metrics = loss_fn(model, tcfg, rc,
                            {"tokens": torch.from_numpy(toks)})
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, dict(zip(params, grads))


@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
def test_loss_and_every_gradient_match_jax(jax_params, policy):
    _, tcfg = configs()
    toks = tokens(1)
    (loss_j, m_j), g_j = jax_value_and_grad(
        jax_params, JaxRunConfig(schedule_policy=policy,
                                 loss_chunk=LOSS_CHUNK), toks)
    loss_t, m_t, grads = port_grads(
        port_model(jax_params),
        RunConfig(schedule_policy=policy, loss_chunk=LOSS_CHUNK), toks)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **LOSS_TOL)
    for key in ("ce", "lb_loss", "router_z", "tokens"):
        np.testing.assert_allclose(float(m_t[key].detach()), float(m_j[key]),
                                   **LOSS_TOL)
    want = from_jax_tree(tcfg, jax.tree.map(np.asarray, g_j))
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)
    # the latent projections and the routed experts all learn
    for name in ("layers.0.attn.wkv_b", "layers.1.attn.wq_a",
                 "layers.2.moe.w_down", "layers.0.ffn.w_up"):
        assert np.abs(want[name]).max() > 0, name


def jax_batches(jcfg, accum, n):
    return [{k: jnp.asarray(v) for k, v in jax_make_batch(
        jcfg, B, S, step=i, accum=accum, seed=1).items()} for i in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
def test_two_train_steps_match_jax(jax_params, accum):
    jcfg, tcfg = configs()
    jrc = JaxRunConfig(loss_chunk=LOSS_CHUNK)
    jstep = jax.jit(jax_make_train_step(jcfg, jrc,
                                        jax_adamw.OptConfig(**OPT),
                                        accum_steps=accum))
    jstate = {"params": jax_params,
              "opt": jax_adamw.init_opt_state(jax_params)}
    state = train_state(port_model(jax_params))
    step = make_train_step(tcfg, RunConfig(loss_chunk=LOSS_CHUNK),
                           adamw.OptConfig(**OPT), accum_steps=accum)
    for i, jb in enumerate(jax_batches(jcfg, accum, 2)):
        jstate, jm = jstep(jstate, jb)
        tb = device_batch(make_batch(tcfg, B, S, step=i, accum=accum,
                                     seed=1), "cpu")
        state, tm = step(state, tb)
        for key in ("loss", "grad_norm", "lr", "ce"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **LOSS_TOL)
        want = from_jax_tree(tcfg, jax.tree.map(np.asarray,
                                                jstate["params"]))
        for name, p in state["params"].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       err_msg=f"step {i} {name}",
                                       **PARAM_TOL)
    # the optimizer trees carried across by name: both moments of every
    # leaf, MLA's included
    for key in ("m", "v"):
        want = from_jax_tree(tcfg, jax.tree.map(np.asarray,
                                                jstate["opt"][key]))
        assert set(want) == set(state["opt"][key])
        for name, t in state["opt"][key].items():
            np.testing.assert_allclose(t.numpy(), want[name],
                                       err_msg=f"{key} {name}", **MOMENT_TOL)
    assert int(state["opt"]["step"]) == 2


@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
def test_remat_gradients_are_bitwise_those_without(jax_params, policy):
    toks = tokens(2)
    rc = RunConfig(schedule_policy=policy, loss_chunk=LOSS_CHUNK, q_chunk=8,
                   kv_chunk=8)
    loss, _, grads = port_grads(port_model(jax_params), rc, toks)
    loss_r, _, grads_r = port_grads(port_model(jax_params),
                                    rc._replace(remat=True), toks)
    assert torch.equal(loss, loss_r)
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


@pytest.fixture(scope="module")
def ragged_prompt():
    _, tcfg = configs()
    return tokens(3, (B, RAGGED_S))


def test_ragged_chunk_prefill_logits_match_jax(jax_params, ragged_prompt):
    jcfg, tcfg = configs()
    kw = dict(q_chunk=RAGGED_CHUNK, kv_chunk=RAGGED_CHUNK,
              schedule_policy="fixed")
    cap = RAGGED_S + 4
    j_logits, _, _ = jax_forward(
        jax_params, jcfg, JaxRunConfig(executor="xla", **kw),
        {"tokens": jnp.asarray(ragged_prompt)}, mode="prefill",
        cache=jax_init_cache(jcfg, B, cap))
    t_logits, _, _ = forward(
        port_model(jax_params), tcfg, RunConfig(**kw),
        {"tokens": torch.from_numpy(ragged_prompt).long()}, mode="prefill",
        cache=init_cache(tcfg, B, cap, device="cpu"))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               **GRAD_TOL)


def test_ragged_chunk_train_loss_matches_jax(jax_params, ragged_prompt):
    jrc = JaxRunConfig(q_chunk=RAGGED_CHUNK, kv_chunk=RAGGED_CHUNK,
                       loss_chunk=LOSS_CHUNK)
    (loss_j, _), _ = jax_value_and_grad(jax_params, jrc, ragged_prompt)
    loss_t, _, _ = port_grads(
        port_model(jax_params),
        RunConfig(q_chunk=RAGGED_CHUNK, kv_chunk=RAGGED_CHUNK,
                  loss_chunk=LOSS_CHUNK), ragged_prompt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **LOSS_TOL)


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_mla_prefill_and_train_run_the_chunked_attention(jax_params,
                                                        ragged_prompt,
                                                        monkeypatch, mode):
    """The whole-score ``attention`` would hold B x H x S x S fp32 scores
    (34.4 GB a batch row at deepseek-v2's 128 heads and 8,192 tokens):
    prefill and train must not reach it, and ``flash_attention`` must get
    ``RunConfig``'s chunks, one chunk where they are 0."""
    _, tcfg = configs()

    def refuse(*args, **kwargs):
        raise AssertionError("MLA prefill/train reached the whole-score "
                             "attention")
    chunks = []
    flash = port_mla.flash_attention

    def record(*args, **kwargs):
        chunks.append((kwargs["q_chunk"], kwargs["kv_chunk"]))
        return flash(*args, **kwargs)
    monkeypatch.setattr(port_mla, "attention", refuse)
    monkeypatch.setattr(port_mla, "flash_attention", record)
    model = port_model(jax_params)
    toks = torch.from_numpy(ragged_prompt).long()
    for rc, want in ((RunConfig(q_chunk=8, kv_chunk=4), (8, 4)),
                     (RunConfig(q_chunk=0, kv_chunk=0), (10 ** 9, 10 ** 9))):
        chunks.clear()
        if mode == "prefill":
            logits, _, _ = forward(model, tcfg, rc, {"tokens": toks},
                                   mode="prefill",
                                   cache=init_cache(tcfg, B, RAGGED_S,
                                                    device="cpu"))
            assert torch.isfinite(logits).all()
        else:
            loss, _ = loss_fn(model, tcfg, rc._replace(loss_chunk=LOSS_CHUNK),
                              {"tokens": toks})
            loss.backward()
        assert chunks == [want] * tcfg.n_layers


def test_checkpoint_resume_is_bitwise_on_mla(tmp_path):
    """A run stopped after 2 steps and resumed from its checkpoint ends
    bitwise where an uninterrupted 4-step run ends; the checkpoint holds
    every MLA leaf and its two moments."""
    import json
    from repro_torch.train.loop import train
    _, tcfg = configs()
    rc = RunConfig(loss_chunk=LOSS_CHUNK)
    opt = adamw.OptConfig(**OPT)
    kw = dict(batch=2, seq=16, save_every=100, log=lambda *_: None,
              device="cpu")
    train(tcfg, rc, opt, steps=2, ckpt_dir=str(tmp_path / "split"), **kw)
    out = train(tcfg, rc, opt, steps=4, ckpt_dir=str(tmp_path / "split"),
                **kw)
    assert out["resumed_from"] == 1
    whole = train(tcfg, rc, opt, steps=4, **kw)
    for (name, p), q in zip(out["state"]["params"].named_parameters(),
                            whole["state"]["params"].parameters()):
        assert torch.equal(p, q), name
    leaves = {leaf["name"] for leaf in json.loads(
        (tmp_path / "split" / "ckpt_00000003" / "manifest.json").read_text()
    )["leaves"]}
    for leaf in ("wq_a", "q_norm.scale", "wq_b", "wkv_a", "kv_norm.scale",
                 "wkv_b", "wo"):
        for tree in ("params", "opt/m", "opt/v"):
            assert f"{tree}/layers.1.attn.{leaf}" in leaves, (tree, leaf)


def test_launcher_trains_reduced_deepseek_on_the_cpu(capsys):
    out = train_launcher.main(["--arch", ARCH, "--reduce", "--steps", "2",
                               "--batch", "2", "--seq", "24", "--dtype",
                               "fp32", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "deepseek-v2-236b: 2 layers" in text and "done: ce " in text
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
