"""Gradients of the port's ``moe_ffn`` on the ``cuda`` executor (its
autograd Functions over the kernels' plain versions on the CPU) against
``jax.grad`` of ``repro.core.dispatch.moe_ffn`` on the differentiable
``xla`` executor, with respect to x, the router and the three expert
stacks.  The loss is a fixed random projection of the output plus the
router aux losses with the training weights (0.01, 1e-4), so the combine
weights, the gating and the aux terms all carry gradient.  fp32, 1e-4
(rtol and atol): the two sides differ only in the order of summation.
Also: the backward reaches ``ops.grouped_wgrad`` three times and the dX
product ``ops.grouped_gemm_t`` per MoE layer, quantized stacks refuse a
backward, and frozen inputs launch exactly the forward's wrappers."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.core.dispatch import MoEDispatchConfig as JaxDispatchConfig
from repro.core.dispatch import moe_ffn as jax_moe_ffn
from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
from repro_torch.kernels import ops
from repro_torch.quantization import get_scheme
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

D, F, M, T = 64, 96, 8, 24
TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("x", "router", "w_gate", "w_up", "w_down")
# (gating, norm_topk, routed_scale, E, k): softmax as mixtral/deepseek,
# sigmoid + renorm + scale as moonshot
GATINGS = {"softmax": ("softmax", False, 1.0, 8, 2),
           "sigmoid_renorm_scale": ("sigmoid", True, 2.446, 8, 3)}


def inputs(E, seed):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((T, D)).astype(np.float32),
        "router": (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32),
        "w_gate": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        "w_up": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        "w_down": (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32),
        "proj": rng.standard_normal((T, D)).astype(np.float32),
    }


def jax_grads(inp, kw):
    cfg = JaxDispatchConfig(executor="xla", **kw)

    def loss(x, router, wg, wu, wd):
        y, aux = jax_moe_ffn(x, router, wg, wu, wd, cfg)
        return (jnp.sum(y * inp["proj"]) + 0.01 * aux["lb_loss"]
                + 1e-4 * aux["router_z"])
    args = [jnp.asarray(inp[n]) for n in NAMES]
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return float(val), [np.asarray(g) for g in grads]


def torch_grads(inp, kw):
    cfg = MoEDispatchConfig(executor="cuda", **kw)
    args = [torch.from_numpy(inp[n]).requires_grad_(True) for n in NAMES]
    y, aux = moe_ffn(*args, cfg)
    loss = ((y * torch.from_numpy(inp["proj"])).sum()
            + 0.01 * aux["lb_loss"] + 1e-4 * aux["router_z"])
    loss.backward()
    return float(loss.detach()), [a.grad.numpy() for a in args]


@pytest.mark.parametrize("gating", sorted(GATINGS))
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
def test_moe_ffn_grads_match_jax(policy, fuse, gating):
    g, norm, scale, E, k = GATINGS[gating]
    inp = inputs(E, seed=len(gating) + 3 * fuse)
    kw = dict(n_experts=E, top_k=k, block_m=M, fuse_gate_up=fuse, gating=g,
              norm_topk=norm, routed_scale=scale, schedule_policy=policy)
    loss_j, grads_j = jax_grads(inp, kw)
    loss_t, grads_t = torch_grads(inp, kw)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
    for name, gt, gj in zip(NAMES, grads_t, grads_j):
        assert np.abs(gj).max() > 0, name          # every input is reached
        np.testing.assert_allclose(gt, gj, err_msg=name, **TOL)


def test_unfolded_combine_grads_match_jax():
    """``fold_combine=False``: the combine weights' gradient comes through
    the weighted unpermute instead of the down projection's row scale."""
    g, norm, scale, E, k = GATINGS["sigmoid_renorm_scale"]
    inp = inputs(E, seed=11)
    kw = dict(n_experts=E, top_k=k, block_m=M, gating=g, norm_topk=norm,
              routed_scale=scale, fold_combine=False)
    loss_j, grads_j = jax_grads(inp, kw)
    loss_t, grads_t = torch_grads(inp, kw)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
    for name, gt, gj in zip(NAMES, grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, err_msg=name, **TOL)


@pytest.mark.parametrize("fuse", [True, False])
def test_backward_runs_b7_three_times_per_layer(monkeypatch, fuse):
    calls = {"grouped_wgrad": 0, "grouped_gemm_t": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    g, norm, scale, E, k = GATINGS["sigmoid_renorm_scale"]
    inp = inputs(E, seed=5)
    kw = dict(n_experts=E, top_k=k, block_m=M, fuse_gate_up=fuse, gating=g,
              norm_topk=norm, routed_scale=scale)
    torch_grads(inp, kw)
    # dWg, dWu, dWd; dX of the down projection and of gate and up
    assert calls == {"grouped_wgrad": 3, "grouped_gemm_t": 3}


def test_frozen_inputs_run_the_forward_wrappers_only(monkeypatch):
    """With no input that needs a gradient the executor calls the ``ops``
    wrappers directly, as the served path always has."""
    seen = []
    import repro_torch.kernels.autograd as ag
    for fn in ("_RouterTopK", "_Permute", "_Unpermute", "_GroupedGemm",
               "_FusedGateUp"):
        monkeypatch.setattr(getattr(ag, fn), "apply",
                            lambda *a, _fn=fn: seen.append(_fn))
    inp = inputs(8, seed=1)
    cfg = MoEDispatchConfig(n_experts=8, top_k=2, block_m=M, executor="cuda")
    args = [torch.from_numpy(inp[n]).requires_grad_(True) for n in NAMES]
    with torch.no_grad():
        y, _ = moe_ffn(*args, cfg)
    y2, _ = moe_ffn(*[a.detach() for a in args], cfg)
    assert seen == [] and torch.equal(y, y2)


def test_quantized_stacks_refuse_a_backward():
    inp = inputs(8, seed=2)
    cfg = MoEDispatchConfig(n_experts=8, top_k=2, block_m=M, executor="cuda")
    sch = get_scheme("int8_expert")
    ws = [sch.quantize(torch.from_numpy(inp[n]))
          for n in ("w_gate", "w_up", "w_down")]
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="quantized"):
        moe_ffn(x, torch.from_numpy(inp["router"]), *ws, cfg)
