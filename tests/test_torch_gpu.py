"""On the card: the port's CUDA kernels against their plain PyTorch versions,
the MoE layer without a host sync, and the engine's launch counts.

Every test here carries the ``gpu`` marker and skips where no CUDA device
is present; the fixture decides, never the module's import.  Run on the
card with ``python -m pytest -q -m gpu tests/test_torch_*.py``.  This file
imports no JAX: the machine with the card has none."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
from repro_torch.execution import combine_scale_rows
from repro_torch.kernels import ops, ref
from repro_torch.scheduling import build_fixed_schedule

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def layer(dev, T, E, k, d, f, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dtype)
    return (torch.randn((T, E), generator=g, device=dev), randn(T, d),
            randn(E, d, f, scale=d ** -0.5), randn(E, d, f, scale=d ** -0.5),
            randn(E, f, d, scale=f ** -0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,E,k,d,f,M", [(128, 16, 4, 64, 64, 16),
                                         (256, 8, 2, 128, 256, 128),
                                         (4, 64, 6, 256, 192, 128)])
def test_cuda_kernels_match_plain(cuda, T, E, k, d, f, M, dtype):
    logits, x, wg, wu, wd = layer(cuda, T, E, k, d, f, DTYPES[dtype])
    kw = dict(gating="sigmoid", norm_topk=True, routed_scale=2.446)
    w, idx = ops.router_topk(logits, top_k=k, **kw)
    w_p, idx_p = ref.router_ref(logits, k, **kw)
    assert torch.equal(idx, idx_p)
    torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-6)
    sched = build_fixed_schedule(idx, E, M)
    xp = ops.permute(x, sched)
    assert torch.equal(xp, ref.permute_ref(x, sched))
    h = ops.fused_gate_up(xp, wg, wu, sched)
    torch.testing.assert_close(
        h.float(), ref.fused_gate_up_ref(xp, wg, wu, sched).float(),
        **TOL[dtype])
    scale = combine_scale_rows(sched, w)
    y = ops.grouped_gemm(h, wd, sched, row_scale=scale)
    torch.testing.assert_close(
        y.float(), ref.grouped_gemm_ref(h, wd, sched, scale).float(),
        **TOL[dtype])
    inactive = (sched.block_active == 0).repeat_interleave(M)
    assert torch.equal(y[inactive], torch.zeros_like(y[inactive]))
    out = ops.unpermute(y, sched, None)
    torch.testing.assert_close(out.float(),
                               ref.unpermute_ref(y, sched, None).float(),
                               **TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrapper_refuses_shapes_the_kernel_does_not_take(cuda):
    x = torch.zeros((16, 24), dtype=torch.bfloat16, device=cuda)   # K=24
    w = torch.zeros((2, 24, 32), dtype=torch.bfloat16, device=cuda)
    be = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops._gg.grouped_gemm(x, w, be, be, block_m=16)


@pytest.mark.gpu
def test_moe_ffn_makes_no_host_sync(cuda):
    T, E, k, d, f = 8, 64, 6, 256, 192
    logits, x, wg, wu, wd = layer(cuda, T, E, k, d, f, torch.bfloat16)
    router = torch.randn((d, E), device=cuda)
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                            executor="cuda", gating="sigmoid",
                            norm_topk=True, routed_scale=2.446)
    moe_ffn(x, router, wg, wu, wd, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe_ffn(x, router, wg, wu, wd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert y.shape == (T, d) and not torch.isnan(y).any()


@pytest.mark.gpu
def test_engine_launches_each_kernel_once_per_moe_layer_forward(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params, n_moe_layers
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, block_m=16))
    model = init_params(cfg, 0, param_dtype=torch.bfloat16)
    eng = ServeEngine(cfg, model, slots=2, capacity=40,
                      rc=RunConfig(compute_dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=4)
            for i, n in enumerate((5, 17, 3))]
    ops.reset_launches()
    done = eng.run(reqs)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    expect = n_moe_layers(cfg) * eng.n_forwards
    assert all(n == expect for n in ops.LAUNCHES.values()), ops.LAUNCHES
