"""The port's training path against the reference's on reduced
moonshot-v1-16b-a3b (3 layers: 1 dense + 2 MoE; E=8, k=2, block_m=8, two
shared experts, sigmoid gating with renormalisation and routed_scale), in
fp32 on the CPU.

The reference trains on its differentiable ``xla`` executor; the port on
the ``cuda`` executor, whose autograd Functions run the kernels' plain
versions here.  Weights are carried across with ``from_jax_params``, and
gradient or parameter trees compared through ``from_jax_tree``.  The loss
within 1e-5, every gradient within 1e-4 (rtol and atol: sums run in other
orders), for the ``fixed`` and ``dynamic`` policies, with strided loss
chunks.  One and two ``make_train_step`` steps with accum 1 and 2: loss,
``grad_norm`` and ``lr`` within 1e-5 and every updated parameter within
1e-6.  Adam's first steps divide each moment by ``|g| + eps``, so with the
default eps a gradient within rounding of zero can flip the sign of its
whole update (one element of the reduced model did, by 1.2e-5 against
updates of 3e-4); the step test takes eps = 1e-3, under which each update
is a smooth function of its gradient (slope at most 1/eps) and the
gradients' 1e-4 agreement bounds the parameters'.  One step at the
default eps is held too: within 1e-6 where the reference's gradient
exceeds GRAD_FLOOR in magnitude, and within 2 lr (the most a flipped
update can move, plus 1e-6 of rounding) elsewhere.  Also ``make_batch`` bitwise,
``apply_updates`` against the reference's, the learning-rate schedule, the
loop and the launcher end to end."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models.lm import RunConfig as JaxRunConfig
from repro.models.lm import init_params as jax_init_params
from repro.models.lm import loss_fn as jax_loss_fn
from repro.optim import adamw as jax_adamw
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import device_batch, make_batch
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import RunConfig, loss_fn
from repro_torch.optim import adamw
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_step, train_state
from repro_torch.weights import from_jax_params, from_jax_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
B, S, LOSS_CHUNK = 2, 16, 8          # 15 loss positions: 3 strided chunks
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-3)
# Adam's first update is lr g' / (|g'| + eps), g' the clipped gradient: an
# error d in g' moves it by at most lr eps d / g'^2.  Above GRAD_FLOOR (and
# the reduced model's clip of about 1/23, g' > 4e-6) an error within
# GRAD_TOL moves it by under 1e-6.
GRAD_FLOOR = 1e-4


def configs():
    return (jax_reduced(jax_get_config("moonshot-v1-16b-a3b"), layers=3),
            reduced(get_config("moonshot-v1-16b-a3b"), layers=3))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = configs()
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


@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
def test_loss_and_every_gradient_match_jax(jax_params, policy):
    jcfg, tcfg = configs()
    toks = tokens(1)
    jrc = JaxRunConfig(schedule_policy=policy, loss_chunk=LOSS_CHUNK)
    (loss_j, m_j), g_j = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jrc, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jax_params)
    model = port_model(jax_params)
    rc = RunConfig(schedule_policy=policy, loss_chunk=LOSS_CHUNK)
    loss_t, m_t = loss_fn(model, tcfg, rc, {"tokens": torch.from_numpy(toks)})
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss_t, list(params.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               **LOSS_TOL)
    for key in ("ce", "lb_loss", "router_z", "tokens"):
        np.testing.assert_allclose(float(m_t[key].detach()), float(m_j[key]),
                                   **LOSS_TOL)
    want = from_jax_tree(tcfg, jax.tree.map(np.asarray, g_j))
    assert set(want) == set(params)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)
    assert np.abs(want["layers.1.moe.w_down"]).max() > 0


def jax_batches(jcfg, accum, n):
    return [{k: jnp.asarray(v) for k, v in jax_make_batch(
        jcfg, B, S, step=i, accum=accum, seed=1).items()} for i in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
def test_two_train_steps_match_jax(jax_params, accum):
    jcfg, tcfg = configs()
    jrc = JaxRunConfig(loss_chunk=LOSS_CHUNK)
    jopt = jax_adamw.OptConfig(**OPT)
    jstep = jax.jit(jax_make_train_step(jcfg, jrc, jopt, accum_steps=accum))
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
    assert int(state["opt"]["step"]) == 2


def test_one_train_step_at_the_default_eps_matches_jax(jax_params):
    jcfg, tcfg = configs()
    opt = {k: v for k, v in OPT.items() if k != "eps"}
    assert adamw.OptConfig(**opt).eps == jax_adamw.OptConfig(**opt).eps \
        == 1e-8
    jrc = JaxRunConfig(loss_chunk=LOSS_CHUNK)
    jb = jax_batches(jcfg, 1, 1)[0]
    g_j = jax.grad(lambda p: jax_loss_fn(p, jcfg, jrc, jb)[0])(jax_params)
    jstep = jax.jit(jax_make_train_step(jcfg, jrc, jax_adamw.OptConfig(**opt)))
    jstate, jm = jstep({"params": jax_params,
                        "opt": jax_adamw.init_opt_state(jax_params)}, jb)
    state = train_state(port_model(jax_params))
    step = make_train_step(tcfg, RunConfig(loss_chunk=LOSS_CHUNK),
                           adamw.OptConfig(**opt))
    state, tm = step(state, device_batch(
        make_batch(tcfg, B, S, step=0, seed=1), "cpu"))
    for key in ("loss", "grad_norm", "lr", "ce"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   err_msg=key, **LOSS_TOL)
    lr = float(jm["lr"])
    grads = from_jax_tree(tcfg, jax.tree.map(np.asarray, g_j))
    want = from_jax_tree(tcfg, jax.tree.map(np.asarray, jstate["params"]))
    n_steep = n_flat = 0
    for name, p in state["params"].named_parameters():
        got, steep = p.detach().numpy(), np.abs(grads[name]) > GRAD_FLOOR
        np.testing.assert_allclose(got[steep], want[name][steep],
                                   err_msg=name, **PARAM_TOL)
        flat = np.abs(got[~steep] - want[name][~steep])
        assert flat.size == 0 or flat.max() <= 2 * lr + 1e-6, name
        n_steep, n_flat = n_steep + steep.sum(), n_flat + flat.size
    assert n_steep > n_flat        # most elements are held at 1e-6


@pytest.mark.parametrize("accum", [1, 3])
def test_make_batch_is_bitwise_the_reference(accum):
    jcfg, tcfg = configs()
    for step in (0, 5):
        want = jax_make_batch(jcfg, 4, 33, step=step, accum=accum, seed=7)
        got = make_batch(tcfg, 4, 33, step=step, accum=accum, seed=7)
        assert set(got) == set(want) == {"tokens"}
        assert got["tokens"].dtype == want["tokens"].dtype
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    tb = device_batch(got, "cpu")["tokens"]
    assert tb.device.type == "cpu" and torch.equal(
        tb, torch.from_numpy(want["tokens"]))


@pytest.mark.parametrize("step", [1, 3])
def test_apply_updates_matches_reference(step):
    """Random parameters, gradients large enough to clip, and moments
    after ``step - 1`` updates: the in-place update against the
    reference's pure one."""
    rng = np.random.default_rng(step)
    shapes = {"a": (4, 6), "b": (5,), "c": (2, 3, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: np.abs(0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8)
    jstate = {"m": {k: jnp.asarray(x) for k, x in m.items()},
              "v": {k: jnp.asarray(x) for k, x in v.items()},
              "step": jnp.asarray(step - 1, jnp.int32)}
    jp, js, jm = jax_adamw.apply_updates(
        {k: jnp.asarray(x) for k, x in p.items()},
        {k: jnp.asarray(x) for k, x in g.items()}, jstate,
        jax_adamw.OptConfig(**cfg))
    tp = {k: torch.from_numpy(x.copy()) for k, x in p.items()}
    tstate = {"m": {k: torch.from_numpy(x.copy()) for k, x in m.items()},
              "v": {k: torch.from_numpy(x.copy()) for k, x in v.items()},
              "step": torch.tensor(step - 1, dtype=torch.int32)}
    tp, ts, tm = adamw.apply_updates(
        tp, {k: torch.from_numpy(x) for k, x in g.items()}, tstate,
        adamw.OptConfig(**cfg))
    assert float(jm["grad_norm"]) > 1.0          # the clip is active
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-6, atol=0)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]),
                                   rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == step


def test_apply_updates_refuses_low_precision_parameters():
    p = {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.bfloat16)}
    g = {k: torch.ones_like(x) for k, x in p.items()}
    with pytest.raises(ValueError, match="'b' is torch.bfloat16"):
        adamw.apply_updates(p, g, adamw.init_opt_state(p), adamw.OptConfig())
    assert not p["a"].any()                 # refused before any update


def test_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=50, min_lr_ratio=0.2)
    steps = np.arange(0, 60, 3, dtype=np.float32)
    want = np.asarray(jax_adamw.schedule(jnp.asarray(steps),
                                         jax_adamw.OptConfig(**cfg)))
    got = adamw.schedule(torch.from_numpy(steps), adamw.OptConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_train_loop_logs_and_injects_failure(tmp_path):
    _, tcfg = configs()
    kw = dict(steps=3, batch=2, seq=16, seed=0, device="cpu")
    rc = RunConfig(loss_chunk=LOSS_CHUNK)
    opt = adamw.OptConfig(**OPT)
    lines = []
    out = train(tcfg, rc, opt, log_every=2, log=lines.append, **kw)
    assert [h["step"] for h in out["history"]] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert lines[0].startswith("[train] step     0 loss ")
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        train(tcfg, rc, opt, fail_at=1, log=lines.append, **kw)
    out = train(tcfg, rc, opt, ckpt_dir=str(tmp_path), save_every=1,
                log=lines.append, **kw)
    assert out["resumed_from"] is None
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["ckpt_00000001", "ckpt_00000002"]       # none at step 0


def test_launcher_trains_reduced_moonshot_on_the_cpu(capsys):
    out = train_launcher.main(["--arch", "moonshot-v1-16b-a3b", "--reduce",
                               "--steps", "3", "--batch", "2", "--seq", "24",
                               "--dtype", "fp32", "--device", "cpu"])
    text = capsys.readouterr().out
    assert len(out["history"]) == 3 and "done: ce " in text
    assert all(np.isfinite(h["loss"]) for h in out["history"])
