"""The backward's two kernels' plain versions against the JAX reference.

* B7, ``grouped_wgrad_plain`` and ``ops.grouped_wgrad`` (which runs it on
  CPU tensors) against ``repro.kernels.ref.grouped_wgrad_ref`` and the
  Pallas kernel in interpret mode (``repro.kernels.ops.grouped_wgrad``, as
  tests/test_kernels.py runs it), on the ``fixed`` schedule and on the
  ``dynamic`` policy's 8-row blocks, fp32 and bf16 inputs (both sides sum
  exact products in fp32, so 1e-4 holds for both), and exact zeros for
  experts that received no tokens.
* B1 with its weight read transposed, ``grouped_gemm_t_plain`` and
  ``ops.grouped_gemm_t``, against numpy's ``dy @ W[e].T`` per active block
  and zeros elsewhere (fp32 1e-5; bf16 inputs 2e-2, the output rounded to
  bf16 once).
(The CUDA kernels are held against these plain versions on the card:
test_torch_gpu.py and chip_smoke.py.)"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.core.schedule import build_schedule as jax_fixed  # noqa: E402
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.scheduling.dynamic import build_dynamic_schedule as jax_dynamic  # noqa: E402
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.grouped_gemm import grouped_gemm_t_plain
from repro_torch.kernels.grouped_wgrad import grouped_wgrad_plain
from repro_torch.scheduling import build_dynamic_schedule, build_fixed_schedule
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = [
    # (T, E, k, d, f, block_m), as tests/test_kernels.py's grouped_wgrad
    (32, 4, 1, 16, 32, 8),
    (64, 8, 2, 32, 48, 8),
    (128, 16, 4, 64, 64, 16),
]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
WGRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def schedules(idx, E, M, policy):
    """The port's and the reference's schedule of the same routing."""
    if policy == "fixed":
        return (build_fixed_schedule(torch.from_numpy(idx), E, M),
                jax_fixed(jnp.asarray(idx), E, M))
    return (build_dynamic_schedule(torch.from_numpy(idx), E, M,
                                   block_m_min=8),
            jax_dynamic(jnp.asarray(idx), E, M, block_m_min=8))


def routed(T, E, k, seed):
    """(T, k) distinct experts per token, from a seeded permutation."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)


def padded_pair(T, d, f, sched_t, sched_j, dtype, seed):
    """x and dy in the padded layout (padding rows zero), on both sides."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((T, f)).astype(np.float32)
    xt = tref.permute_ref(torch.from_numpy(x).to(TDT[dtype]), sched_t)
    dyt = tref.permute_ref(torch.from_numpy(dy).to(TDT[dtype]), sched_t)
    xj = jref.permute_ref(jnp.asarray(x, JDT[dtype]), sched_j)
    dyj = jref.permute_ref(jnp.asarray(dy, JDT[dtype]), sched_j)
    return xt, dyt, xj, dyj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("T,E,k,d,f,M", CASES)
def test_grouped_wgrad_matches_reference_and_pallas(T, E, k, d, f, M, policy,
                                                    dtype):
    idx = routed(T, E, k, seed=T + E)
    sched_t, sched_j = schedules(idx, E, M, policy)
    xt, dyt, xj, dyj = padded_pair(T, d, f, sched_t, sched_j, dtype, seed=k)
    want_ref = np.asarray(jref.grouped_wgrad_ref(xj, dyj, sched_j, E))
    want_pallas = np.asarray(jops.grouped_wgrad(
        xj, dyj, sched_j, E, block_k=min(d, 128), block_n=min(f, 128)))
    got = tops.grouped_wgrad(xt, dyt, sched_t, E)
    plain = grouped_wgrad_plain(xt, dyt, sched_t.block_expert,
                                sched_t.block_active,
                                block_m=sched_t.block_m, n_experts=E)
    assert got.dtype == torch.float32 and got.shape == (E, d, f)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), want_ref, **WGRAD_TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, **WGRAD_TOL)


@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
def test_grouped_wgrad_zeroes_experts_with_no_tokens(policy):
    """Everything routed to experts {0, 3}: the others get exact zeros, as
    the reference's ops wrapper makes them."""
    T, E, k, d, f, M = 32, 8, 1, 16, 16, 8
    idx = np.random.default_rng(0).choice([0, 3], (T, k)).astype(np.int32)
    sched_t, sched_j = schedules(idx, E, M, policy)
    xt, dyt, xj, dyj = padded_pair(T, d, f, sched_t, sched_j, "float32", 1)
    got = tops.grouped_wgrad(xt, dyt, sched_t, E).numpy()
    want = np.asarray(jops.grouped_wgrad(xj, dyj, sched_j, E, block_k=16,
                                         block_n=16))
    np.testing.assert_allclose(got, want, **WGRAD_TOL)
    for e in (1, 2, 4, 5, 6, 7):
        assert np.all(got[e] == 0.0)
    assert np.abs(got[0]).sum() > 0 and np.abs(got[3]).sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("T,E,k,d,f,M", CASES)
def test_grouped_gemm_t_matches_numpy(T, E, k, d, f, M, policy, dtype):
    """dX of the grouped GEMM: ``dy[block] @ W[e].T`` with W the forward's
    (E, d, f) stack read in place; zeros for inactive blocks."""
    idx = routed(T, E, k, seed=7 * T + E)
    sched_t, _ = schedules(idx, E, M, policy)
    rng = np.random.default_rng(E)
    w = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    dy = rng.standard_normal((sched_t.capacity, f)).astype(np.float32)
    wt, dyt = torch.from_numpy(w).to(TDT[dtype]), \
        torch.from_numpy(dy).to(TDT[dtype])
    q = sched_t.block_m
    be, ba = sched_t.block_expert.numpy(), sched_t.block_active.numpy()
    w32, dy32 = wt.float().numpy(), dyt.float().numpy()
    want = np.zeros((sched_t.capacity, d), np.float32)
    for b in range(sched_t.capacity // q):
        if ba[b]:
            want[b * q:(b + 1) * q] = dy32[b * q:(b + 1) * q] @ w32[be[b]].T
    got = tops.grouped_gemm_t(dyt, wt, sched_t)
    plain = grouped_gemm_t_plain(dyt, wt, sched_t.block_expert,
                                 sched_t.block_active, block_m=q)
    assert got.dtype == TDT[dtype] and got.shape == (sched_t.capacity, d)
    assert torch.equal(got, plain)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
