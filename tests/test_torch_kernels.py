"""The port's kernel plain versions against the JAX reference: each of the
five against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode (``repro.kernels.ops``), over the shape and dtype grid of
tests/test_kernels.py, with its tolerances (fp32 2e-5, bf16 2e-2).  Router
indices must be equal exactly.  The GEMMs are also held on the ``dynamic``
policy's 8-row schedules.  (The CUDA kernels themselves are held
against these plain versions on the card: test_torch_gpu.py.)"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.core.schedule import build_schedule as jax_build_schedule  # noqa: E402
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.execution import combine_scale_rows
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro.scheduling.dynamic import build_dynamic_schedule as jax_dynamic  # noqa: E402
from repro_torch.scheduling import build_dynamic_schedule, build_fixed_schedule
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = [
    # (T, E, k, d, f, block_m), as tests/test_kernels.py
    (32, 4, 1, 16, 32, 8),
    (64, 8, 2, 32, 48, 8),
    (128, 16, 4, 64, 64, 16),
    (256, 8, 2, 128, 256, 128),
]
DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def make_inputs(T, E, k, d, f, seed=0):
    """fp32 numpy inputs; each side casts to the test dtype itself."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    x = (rng.standard_normal((T, d)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)
    return logits, x, wg, wu, wd


def both(a, dtype):
    """The same numpy array as a JAX and a torch tensor of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(a, np.float32)


def schedules(logits, E, k, M):
    """The reference schedule (from the JAX router's indices) and the
    port's, built from the same indices."""
    w, idx = jref.router_ref(jnp.asarray(logits), k)
    js = jax_build_schedule(idx, E, M)
    ts = build_fixed_schedule(torch.from_numpy(np.array(idx)), E, M)
    return np.array(w), js, ts


@pytest.mark.parametrize("gating,norm_topk", [("softmax", False),
                                              ("sigmoid", True),
                                              ("sigmoid", False)])
@pytest.mark.parametrize("T,E,k", [(32, 4, 1), (64, 8, 2), (128, 64, 6),
                                   (64, 256, 8)])
def test_router_plain_matches_reference(T, E, k, gating, norm_topk):
    logits = np.random.default_rng(1).standard_normal((T, E)).astype(
        np.float32)
    kw = dict(gating=gating, norm_topk=norm_topk, routed_scale=2.0)
    w_r, i_r = jref.router_ref(jnp.asarray(logits), k, **kw)
    w_k, i_k = jops.router_topk(jnp.asarray(logits), top_k=k, **kw)
    w_t, i_t = tops.router_topk(torch.from_numpy(logits), top_k=k, **kw)
    assert i_t.dtype == torch.int32 and w_t.dtype == torch.float32
    for w_j, i_j in ((w_r, i_r), (w_k, i_k)):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                                   rtol=1e-5, atol=1e-6)


def test_router_masking_many_experts():
    """All-equal logits at E=256: no expert is picked twice, and the picks
    equal the reference's (lowest index first)."""
    T, E, k = 16, 256, 8
    logits = np.full((T, E), -10.0, np.float32)
    _, i_j = jops.router_topk(jnp.asarray(logits), top_k=k, gating="softmax")
    _, i_t = tops.router_topk(torch.from_numpy(logits), top_k=k,
                              gating="softmax")
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    for t in range(T):
        assert len(set(i_t[t].tolist())) == k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,E,k,d,f,M", CASES)
def test_permute_plain_matches_reference(T, E, k, d, f, M, dtype):
    logits, x, *_ = make_inputs(T, E, k, d, f)
    _, js, ts = schedules(logits, E, k, M)
    xj, xt = both(x, dtype)
    out_t = np32(tops.permute(xt, ts))
    np.testing.assert_array_equal(out_t, np32(jref.permute_ref(xj, js)))
    np.testing.assert_array_equal(
        out_t, np32(jops.permute(xj, js, block_d=min(d, 512))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,E,k,d,f,M", CASES)
def test_fused_gate_up_plain_matches_reference(T, E, k, d, f, M, dtype):
    logits, x, wg, wu, _ = make_inputs(T, E, k, d, f)
    _, js, ts = schedules(logits, E, k, M)
    xj, xt = both(x, dtype)
    (wgj, wgt), (wuj, wut) = both(wg, dtype), both(wu, dtype)
    xpj, xpt = jref.permute_ref(xj, js), tref.permute_ref(xt, ts)
    out_t = np32(tops.fused_gate_up(xpt, wgt, wut, ts))
    np.testing.assert_allclose(
        out_t, np32(jref.fused_gate_up_ref(xpj, wgj, wuj, js)), **tol(dtype))
    np.testing.assert_allclose(
        out_t, np32(jops.fused_gate_up(xpj, wgj, wuj, js,
                                       block_n=min(f, 128),
                                       block_k=min(d, 128))), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("T,E,k,d,f,M", CASES[:3])
def test_grouped_gemm_plain_matches_reference(T, E, k, d, f, M, with_scale,
                                              dtype):
    from repro.core.dispatch import combine_scale_rows as jax_combine_rows
    logits, x, wg, _, wd = make_inputs(T, E, k, d, f)
    w, js, ts = schedules(logits, E, k, M)
    xj, xt = both(x, dtype)
    (wgj, wgt), (wdj, wdt) = both(wg, dtype), both(wd, dtype)
    hj = jref.fused_gate_up_ref(jref.permute_ref(xj, js), wgj, wgj, js)
    ht = torch.from_numpy(np32(hj)).to(TDT[dtype])
    sj = st = None
    if with_scale:
        sj = jax_combine_rows(js, jnp.asarray(w))
        st = combine_scale_rows(ts, torch.from_numpy(w))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    out_t = np32(tops.grouped_gemm(ht, wdt, ts, row_scale=st))
    np.testing.assert_allclose(
        out_t, np32(jref.grouped_gemm_ref(hj, wdj, js, row_scale=sj)),
        **tol(dtype))
    np.testing.assert_allclose(
        out_t, np32(jops.grouped_gemm(hj, wdj, js, row_scale=sj,
                                      block_n=min(d, 128),
                                      block_k=min(f, 128))), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("T,E,k,d,f,M", CASES[:3])
def test_unpermute_plain_matches_reference(T, E, k, d, f, M, folded, dtype):
    logits, x, *_ = make_inputs(T, E, k, d, f)
    w, js, ts = schedules(logits, E, k, M)
    xj, xt = both(x, dtype)
    yj, yt = jref.permute_ref(xj, js), tref.permute_ref(xt, ts)
    wj, wt = (None, None) if folded else (jnp.asarray(w), torch.from_numpy(w))
    out_t = np32(tops.unpermute(yt, ts, wt))
    np.testing.assert_allclose(out_t, np32(jref.unpermute_ref(yj, js, wj)),
                               **tol(dtype))
    np.testing.assert_allclose(
        out_t, np32(jops.unpermute(yj, js, wj, block_d=min(d, 512))),
        **tol(dtype))


def test_wrappers_refuse_devices_they_do_not_serve():
    """A CPU tensor runs the plain version and a CUDA tensor the kernel;
    fake or meta tensors take the shape-only path (the dry run's); a mix
    raises instead of running elsewhere."""
    x = torch.zeros((4, 16), device="meta")
    src = torch.zeros((8,), dtype=torch.int32, device="meta")
    sched = build_fixed_schedule(torch.zeros((4, 1), dtype=torch.int32), 2,
                                 8)
    with pytest.raises(ValueError):
        tops.permute(x, sched._replace(src_tok=src.new_zeros(
            (8,), device="cpu")))
    out = tops.permute(x, sched._replace(src_tok=src))
    assert out.is_meta and tuple(out.shape) == (8, 16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,E,k,d,f,M", [(2, 64, 6, 32, 48, 128),
                                         (64, 16, 4, 64, 64, 32),
                                         (128, 8, 2, 32, 48, 128)])
def test_gemms_plain_on_dynamic_8_row_blocks(T, E, k, d, f, M, dtype):
    """fused_gate_up and grouped_gemm (with the folded combine rows) on the
    dynamic policy's 8-row sub-blocks, against the reference oracles and
    the Pallas kernels; inactive blocks' rows are exactly zero."""
    from repro.core.dispatch import combine_scale_rows as jax_combine_rows
    logits, x, wg, wu, wd = make_inputs(T, E, k, d, f, seed=T)
    w, idx = jref.router_ref(jnp.asarray(logits), k)
    js = jax_dynamic(idx, E, M, block_m_min=8)
    ts = build_dynamic_schedule(torch.from_numpy(np.array(idx)), E, M)
    assert js.block_m == ts.block_m == 8
    xj, xt = both(x, dtype)
    (wgj, wgt), (wuj, wut), (wdj, wdt) = (both(wg, dtype), both(wu, dtype),
                                          both(wd, dtype))
    xpj, xpt = jref.permute_ref(xj, js), tops.permute(xt, ts)
    np.testing.assert_array_equal(np32(xpt), np32(xpj))
    h_t = tops.fused_gate_up(xpt, wgt, wut, ts)
    np.testing.assert_allclose(
        np32(h_t), np32(jref.fused_gate_up_ref(xpj, wgj, wuj, js)),
        **tol(dtype))
    hj = jops.fused_gate_up(xpj, wgj, wuj, js, block_n=min(f, 128),
                            block_k=min(d, 128))
    np.testing.assert_allclose(np32(h_t), np32(hj), **tol(dtype))
    ht = torch.from_numpy(np32(hj)).to(TDT[dtype])
    sj = jax_combine_rows(js, w)
    st = combine_scale_rows(ts, torch.from_numpy(np.array(w)))
    y_t = tops.grouped_gemm(ht, wdt, ts, row_scale=st)
    np.testing.assert_allclose(
        np32(y_t), np32(jref.grouped_gemm_ref(hj, wdj, js, row_scale=sj)),
        **tol(dtype))
    np.testing.assert_allclose(
        np32(y_t), np32(jops.grouped_gemm(hj, wdj, js, row_scale=sj,
                                          block_n=min(d, 128),
                                          block_k=min(f, 128))),
        **tol(dtype))
    dead = (ts.block_active == 0).repeat_interleave(8)
    assert not np32(h_t)[dead.numpy()].any()
    assert not np32(y_t)[dead.numpy()].any()
