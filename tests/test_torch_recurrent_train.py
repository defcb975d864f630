"""The recurrent families' training on one device against ``repro`` on the
CPU, in fp32: rwkv6-1.6b (``ssm``) reduced, and zamba2-7b (``hybrid``)
reduced with ``layers=7`` (2 groups: both shared blocks, then the
suffix's own).

Weights: the reference's tree with numpy draws (``reference_init``), every
leaf it inits to a constant drawn away from it, carried across with
``from_jax_params``.  Batch 2 x 32 tokens (``make_batch``): a multiple of
the reduced SSD chunk (16), so that the reference's divisor rule and the
port's fixed chunks cut alike.

* train mode's final hidden states within 1e-5 (rwkv6's ``ln0`` after the
  embedding, which train mode once left out: ROADMAP C16);
* ``loss_fn`` within 1e-5 and every gradient within 1e-4 of ``jax.grad``
  (``mu``, ``w0``, ``u``, ``a_log``, ``dt_bias``, ``d_skip``, the norms
  and both shared blocks included, each one's gradient the sum over the
  groups that apply it, as the reference's ``shared[j]``'s);
* one ``make_train_step`` AdamW step (eps 1e-3, as tests/test_torch_train.py):
  loss, ``grad_norm`` and ``lr`` within 1e-5, every parameter within 1e-6;
* remat's gradients bitwise those without; ``rc.ep`` (which reaches only
  MoE layers) bitwise the plain forward in train and prefill;
* ``ssm_block``'s output and gradients against ``jax.grad`` of the
  reference's at S = 24 (the port's chunks 16 and a ragged 8, padded with
  dt = 0; the reference's two of 12) and S = 32;
* the train launcher on both reduced configs."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import make_batch as jax_make_batch  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.lm import RunConfig as JaxRunConfig  # noqa: E402
from repro.models.lm import forward as jax_forward  # noqa: E402
from repro.models.lm import loss_fn as jax_loss_fn  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import main as train_main
from repro_torch.models import ssm
from repro_torch.models.lm import RunConfig, forward, loss_fn
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import make_train_step, train_state
from repro_torch.weights import _flatten, from_jax_params, from_jax_tree
from reference_init import numpy_init
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

HIDDEN_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHS = {"rwkv6-1.6b": {}, "zamba2-7b": {"layers": 7}}
B, S = 2, 32
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-3)
JAX_RC = JaxRunConfig(loss_chunk=16)
PORT_RC = RunConfig(loss_chunk=16)
# the leaves that frozen() builds without requires_grad: each must train
FROZEN = {"rwkv6-1.6b": ("ln0.scale", "layers.0.tm.mu", "layers.0.tm.w0",
                         "layers.0.tm.u", "layers.1.cm.mu",
                         "layers.0.tm.ln_x.bias"),
          "zamba2-7b": ("layers.1.ssm.a_log", "layers.1.ssm.dt_bias",
                        "layers.1.ssm.d_skip", "layers.1.ssm.conv_b",
                        "shared.0.norm1.scale", "shared.1.norm1.scale",
                        "layers.8.ssm.out_norm.scale")}


def configs(arch):
    kw = ARCHS[arch]
    return (jax_reduced(jax_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """The reference's hidden states, loss, gradients and one step (one
    jit), and the port's model on the same weights and batch."""
    arch = request.param
    jcfg, tcfg = configs(arch)
    tree = numpy_init(jcfg, 3)
    params = jax.tree.map(jnp.asarray, tree)
    batch = jax_make_batch(jcfg, B, S, step=0)
    step = jax_make_step(jcfg, JAX_RC, jax_adamw.OptConfig(**OPT), 1)

    def everything(params, batch):
        hidden = jax_forward(params, jcfg, JAX_RC, batch, mode="train")[0]
        (loss, _), grads = jax.value_and_grad(
            lambda p: jax_loss_fn(p, jcfg, JAX_RC, batch),
            has_aux=True)(params)
        state = {"params": params, "opt": jax_adamw.init_opt_state(params)}
        new, metrics = step(state, batch)
        return hidden, loss, grads, new["params"], metrics
    hidden, loss, grads, new, metrics = jax.jit(everything)(params, batch)
    np_tree = jax.tree.map(np.asarray, tree)
    ref = dict(hidden=np.asarray(hidden), loss=float(loss),
               grads=from_jax_tree(tcfg, jax.tree.map(np.asarray, grads)),
               params=from_jax_tree(tcfg, jax.tree.map(np.asarray, new)),
               metrics={k: float(v) for k, v in metrics.items()})
    tokens = torch.from_numpy(np.asarray(batch["tokens"])).long()
    return arch, tcfg, np_tree, ref, {"tokens": tokens}


def port_model(tcfg, tree):
    return train_state(from_jax_params(tcfg, tree, device="cpu"))


def port_grads(model, tcfg, batch, rc=PORT_RC):
    loss, _ = loss_fn(model, tcfg, rc, batch)
    params = dict(model.named_parameters())
    return loss.detach(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def test_train_hidden_states_match_reference(pair):
    """ROADMAP C16: without ``ln0`` rwkv6's hidden states differ by
    about 5 here."""
    arch, tcfg, tree, ref, batch = pair
    model = port_model(tcfg, tree)["params"]
    with torch.no_grad():
        h, cache, _ = forward(model, tcfg, PORT_RC, batch, mode="train")
    assert cache is None
    torch.testing.assert_close(h, torch.from_numpy(ref["hidden"]),
                               **HIDDEN_TOL)


def test_loss_and_every_gradient_match_reference(pair):
    arch, tcfg, tree, ref, batch = pair
    model = port_model(tcfg, tree)["params"]
    loss, grads = port_grads(model, tcfg, batch)
    torch.testing.assert_close(loss, torch.tensor(ref["loss"]), **LOSS_TOL)
    assert set(grads) == set(ref["grads"])
    for name, g in grads.items():
        torch.testing.assert_close(g, torch.from_numpy(ref["grads"][name]),
                                   **GRAD_TOL, msg=lambda m, n=name: f"{n}: "
                                   f"{m}")
    for name in FROZEN[arch]:             # trained, and not by accident 0
        assert grads[name].abs().max() > 1e-6, name
    if arch == "zamba2-7b":
        # group g applies shared[g % 2] (layers 0 and 3), registered and
        # trained once each as shared.<j>, its gradient the reference's
        # shared[j]'s; the suffix's block (layer 6) is a third one
        assert model.layers[0] is model.shared[0]
        assert model.layers[3] is model.shared[1]
        assert not any(n.startswith(("layers.0.", "layers.3."))
                       for n in grads)
        assert {"shared.0.attn.wq", "shared.1.ffn.w_down",
                "layers.6.attn.wo"} <= set(grads)


def test_one_adamw_step_matches_reference(pair):
    arch, tcfg, tree, ref, batch = pair
    state = port_model(tcfg, tree)
    state, metrics = make_train_step(tcfg, PORT_RC, OptConfig(**OPT))(
        state, batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]), ref["metrics"][key],
                                   **LOSS_TOL, err_msg=key)
    for name, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref["params"][name],
                                   **PARAM_TOL, err_msg=name)


def test_remat_gradients_are_bitwise_those_without(pair):
    arch, tcfg, tree, ref, batch = pair
    model = port_model(tcfg, tree)["params"]
    loss, grads = port_grads(model, tcfg, batch)
    loss_r, grads_r = port_grads(model, tcfg, batch,
                                 PORT_RC._replace(remat=True))
    assert torch.equal(loss, loss_r)
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def test_ep_forward_is_bitwise_the_plain_one(pair):
    """``rc.ep`` reaches the MoE layers only, as in the reference: these
    models have none, so it changes nothing."""
    arch, tcfg, tree, ref, batch = pair
    model = port_model(tcfg, tree)["params"]
    ep = PORT_RC._replace(ep=True)
    with torch.no_grad():
        for mode in ("train", "prefill"):
            want = forward(model, tcfg, PORT_RC, batch, mode=mode)[0]
            got = forward(model, tcfg, ep, batch, mode=mode)[0]
            assert torch.equal(got, want), mode


@pytest.mark.parametrize("S_", [24, 32])
def test_ssm_block_gradients_match_reference(S_):
    """S = 24: the port's chunks 16 and a ragged 8 (padded with dt = 0),
    the reference's two of 12; the output and the gradients of the input
    and every leaf within 1e-4."""
    jcfg, tcfg = configs("zamba2-7b")
    d = tcfg.d_model
    tree = jax.tree.map(lambda v: v[0],
                        numpy_init(jcfg, 4)["body"]["b1"]["ssm"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, S_, d)).astype(np.float32)
    dy = rng.standard_normal((2, S_, d)).astype(np.float32)

    def ref_fn(p, x):
        y, _ = jax_ssm.ssm_block(p, x, jcfg.ssm)
        return jnp.sum(y * dy), y
    (_, y_ref), (gp, gx) = jax.jit(jax.value_and_grad(
        ref_fn, argnums=(0, 1), has_aux=True))(tree, x)
    mod = ssm.Mamba2(d, tcfg.ssm, None, torch.float32, "cpu")
    flat = _flatten(tree)
    with torch.no_grad():
        for n, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(flat[n])))
    mod.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = ssm.ssm_block(mod, xt, tcfg.ssm)
    (y * torch.from_numpy(dy)).sum().backward()
    torch.testing.assert_close(y.detach(), torch.from_numpy(np.asarray(
        y_ref)), **GRAD_TOL)
    torch.testing.assert_close(xt.grad, torch.from_numpy(np.asarray(gx)),
                               **GRAD_TOL)
    gflat = _flatten(jax.tree.map(np.asarray, gp))
    for n, p in mod.named_parameters():
        torch.testing.assert_close(p.grad, torch.from_numpy(gflat[n]),
                                   **GRAD_TOL, msg=lambda m, n=n: f"{n}: {m}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_launcher_runs_reduced(arch, capsys):
    out = train_main(["--arch", arch, "--reduce", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "done: ce" in capsys.readouterr().out
