"""The port's ``moe_ffn`` on the ``cuda`` executor (its plain versions on the
CPU) against ``repro.core.dispatch.moe_ffn`` on the ``pallas`` executor
(interpret mode), over the four paper configurations' E, k and gating at
reduced width (d=64, f=96, block_m=8), fused and unfused, fp32 and bf16,
with the kernel tolerances (fp32 2e-5, bf16 2e-2).  Also ``apply_moe`` with
shared experts."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.core.dispatch import MoEDispatchConfig as JaxDispatchConfig
from repro.core.dispatch import moe_ffn as jax_moe_ffn
from repro.core.moe_layer import apply_moe as jax_apply_moe
from repro_torch.configs import PAPER_CONFIGS
from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
from repro_torch.core.moe_layer import apply_moe
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

D, F, M, T = 64, 96, 8, 16
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def layer_inputs(E, seed=0, d=D, f=F, t=T):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((t, d)).astype(np.float32),
        "router": (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32),
        "w_gate": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w_up": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w_down": (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", sorted(PAPER_CONFIGS))
def test_moe_ffn_matches_pallas_reference(name, fuse, dtype):
    pc = PAPER_CONFIGS[name]
    inp = layer_inputs(pc.n_experts)
    kw = dict(n_experts=pc.n_experts, top_k=pc.top_k, block_m=M,
              fuse_gate_up=fuse, gating=pc.gating)
    jcfg = JaxDispatchConfig(executor="pallas", **kw)
    tcfg = MoEDispatchConfig(executor="cuda", **kw)
    jx = {k: jnp.asarray(v, jnp.float32 if k == "router" else JDT[dtype])
          for k, v in inp.items()}
    tx = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                    else TDT[dtype])
          for k, v in inp.items()}
    y_j, aux_j = jax_moe_ffn(jx["x"], jx["router"], jx["w_gate"],
                             jx["w_up"], jx["w_down"], jcfg)
    y_t, aux_t = moe_ffn(tx["x"], tx["router"], tx["w_gate"], tx["w_up"],
                         tx["w_down"], tcfg)
    assert y_t.dtype == TDT[dtype] and y_t.shape == (T, D)
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), **tol(dtype))
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_unfolded_combine_matches_pallas_reference(dtype):
    """``fold_combine=False``: the combine weights are applied in
    ``unpermute`` instead of the down projection's epilogue."""
    E, k = 8, 2
    inp = layer_inputs(E, seed=2)
    kw = dict(n_experts=E, top_k=k, block_m=M, fold_combine=False)
    jx = {k_: jnp.asarray(v, jnp.float32 if k_ == "router" else JDT[dtype])
          for k_, v in inp.items()}
    tx = {k_: torch.from_numpy(v).to(torch.float32 if k_ == "router"
                                     else TDT[dtype])
          for k_, v in inp.items()}
    y_j, _ = jax_moe_ffn(jx["x"], jx["router"], jx["w_gate"], jx["w_up"],
                         jx["w_down"], JaxDispatchConfig(executor="pallas",
                                                         **kw))
    y_t, _ = moe_ffn(tx["x"], tx["router"], tx["w_gate"], tx["w_up"],
                     tx["w_down"], MoEDispatchConfig(executor="cuda", **kw))
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), **tol(dtype))


def test_apply_moe_with_shared_experts_matches_reference():
    """moonshot's routing (sigmoid, renormalised, routed_scale) with two
    shared experts, on (B, S, d) input; fp32."""
    E, k, fs = 8, 2, 2 * F
    inp = layer_inputs(E, seed=5, t=12)
    rng = np.random.default_rng(6)
    shared = {
        "w_gate": (rng.standard_normal((D, fs)) * D ** -0.5).astype(np.float32),
        "w_up": (rng.standard_normal((D, fs)) * D ** -0.5).astype(np.float32),
        "w_down": (rng.standard_normal((fs, D)) * fs ** -0.5).astype(np.float32),
    }
    x = inp.pop("x").reshape(2, 6, D)
    kw = dict(n_experts=E, top_k=k, block_m=M, gating="sigmoid",
              norm_topk=True, routed_scale=2.446)
    jp = {**{k_: jnp.asarray(v) for k_, v in inp.items()},
          "shared": {k_: jnp.asarray(v) for k_, v in shared.items()}}
    tp = {**{k_: torch.from_numpy(v) for k_, v in inp.items()},
          "shared": {k_: torch.from_numpy(v) for k_, v in shared.items()}}
    y_j, _ = jax_apply_moe(jp, jnp.asarray(x),
                           JaxDispatchConfig(executor="pallas", **kw))
    y_t, _ = apply_moe(tp, torch.from_numpy(x),
                       MoEDispatchConfig(executor="cuda", **kw))
    assert y_t.shape == x.shape
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               rtol=2e-5, atol=2e-5)
