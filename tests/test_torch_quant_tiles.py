"""The forward's Hopper GEMMs on int8 and int4 weights, walked on the CPU.

``quant_walk`` is a plain model of csrc/grouped_gemm_hopper_quant.cuh: per
work item of ``expert_tiles_plain`` (an expert's tile of rows; zero tiles
stay zero), per pass of at most 128 rows, per 64-deep K stage, it expands
the stage's payload as the consumer threads do (int8 bytes, or int4
nibbles: payload row r holds K rows 2r in its low and 2r + 1 in its high
nibble, sign-extended; scales read through their (E, N) view, stride 0
over N for per-expert scales), rounds ``float(q) * scale`` once to the
compute dtype, and adds the stage's fp32 product; then B1's ``row_scale``
or B2's ``silu(g) * u`` epilogue.  It is held against:

* ``QuantTensor.materialize`` bitwise (the stages' expansion, every scheme,
  fp32 and bf16, K = 176: a partial last stage);
* ``grouped_gemm_plain`` and ``fused_gate_up_plain`` (which dequantize the
  schedule's blocks) on the port's and the reference's ``fixed`` and
  ``dynamic`` schedules of the same routing: E=64 and E=160 at small widths,
  T=2, 4 and 64 (experts with 0 and 1 tokens), and a top-1 routing with
  experts of 0, 1 and 300 tokens (passes of 128 rows), within fp32's 1e-5
  and one bf16 rounding;
* the reference's quantized Pallas kernels in interpret mode, one small
  case of each scheme, with tests/test_kernels.py's tolerances.
(The kernel is held against the plain versions on the card:
test_torch_gpu.py and chip_smoke.py.)"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

import repro.quantization as jq  # noqa: E402
from repro.core.dispatch import combine_scale_rows as jax_combine_rows  # noqa: E402
from repro.core.schedule import build_schedule as jax_fixed  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.scheduling.dynamic import build_dynamic_schedule as jax_dynamic  # noqa: E402
import repro_torch.quantization as tq
from repro_torch.execution import combine_scale_rows
from repro_torch.kernels import expert_tiles as et
from repro_torch.kernels import fused_gate_up as fgu
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import _weight_operands
from repro_torch.scheduling import build_dynamic_schedule, build_fixed_schedule
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SCHEMES = ["int8_expert", "int8_channel", "int4_packed"]
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BK, PASS_ROWS = 64, 128                  # a stage's K depth; a pass's rows


def expand_stage(q, s, e, kt, K, fmt, dtype):
    """Stage kt of expert e's weight, (BK, N) in ``dtype``: the payload's
    rows of logical K rows [kt BK, kt BK + BK) (zeros past K) times the
    column scales, the fp32 product rounded once."""
    b = q[e].to(torch.int32) & 0xFF                    # payload bytes
    if fmt == "int4":
        r0, r1 = kt * BK // 2, min((kt + 1) * BK // 2, b.shape[0])
        lo = ((b[r0:r1] & 0xF) ^ 8) - 8
        hi = (((b[r0:r1] >> 4) & 0xF) ^ 8) - 8
        vals = torch.stack([lo, hi], 1).reshape(2 * (r1 - r0), -1)
    else:
        r0, r1 = kt * BK, min((kt + 1) * BK, K)
        vals = (b[r0:r1] ^ 0x80) - 0x80
    w = torch.zeros((BK, q.shape[-1]), dtype=torch.float32)
    w[:vals.shape[0]] = vals.float() * s[e][None, :]
    return w.to(dtype)


def quant_walk(x, stacks, tiles, fmt, row_scale=None):
    """B1 (one (payload, scales) stack, ``row_scale`` on the stored rows) or
    B2 (two: silu(g) * u) as the kernel walks its work list.  x (capacity,
    K) -> fp32 (capacity, N), zeros wherever no expert's tile reaches."""
    cap, K = x.shape
    out = torch.zeros((cap, stacks[0][0].shape[-1]), dtype=torch.float32)
    n_k = -(-K // BK)
    xs = torch.zeros((cap, n_k * BK), dtype=torch.float32)
    xs[:, :K] = x.float()
    for e, r0, n in tiles.tolist():
        if e < 0:
            continue
        for p in range(r0, r0 + n, PASS_ROWS):
            rows = slice(p, min(p + PASS_ROWS, r0 + n))
            accs = [torch.zeros((rows.stop - p, q.shape[-1])) for q, _ in
                    stacks]
            for kt in range(n_k):
                a = xs[rows, kt * BK:(kt + 1) * BK]
                for acc, (q, s) in zip(accs, stacks):
                    acc += a @ expand_stage(q, s, e, kt, K, fmt,
                                            x.dtype).float()
            if len(accs) == 2:
                g, u = accs
                out[rows] = g * torch.sigmoid(g) * u
            else:
                out[rows] = accs[0] if row_scale is None \
                    else accs[0] * row_scale[rows, None]
    return out


def operands(qt):
    """(payload, (E, N) scales view, kernel format) as ops passes them."""
    q, s, fmt = _weight_operands(qt)
    assert s is not None
    return q, s, fmt


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_stage_expansion_is_the_dequantized_stack_bitwise(scheme, dtype):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 176, 48)) * np.logspace(-3, 2, 48)
    qt = tq.get_scheme(scheme).quantize(torch.from_numpy(w).to(DT[dtype]))
    q, s, fmt = operands(qt)
    if scheme == "int8_channel":
        assert s.stride(1) == 1
    else:
        assert s.stride(1) == 0                       # per-expert scales
    want = qt.materialize()
    for e in range(3):
        got = torch.cat([expand_stage(q, s, e, kt, 176, fmt, DT[dtype])
                         for kt in range(3)])
        assert torch.equal(got[:176], want[e])
        assert not got[176:].any()                    # past K: zeros


def routed(T, E, k, seed):
    """(T, k) distinct experts per token from a seeded permutation, with
    expert E-1 given no token and expert E-2 exactly one."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E - 2)[:k] for _ in range(T)])
    idx[0, 0] = E - 2
    return idx.astype(np.int32)


def schedule(idx, E, M, policy, side):
    """(seg_start, block_expert, block_active, block_m, capacity) of the
    port's or the reference's schedule, as int32 torch arrays."""
    if side == "port":
        build = build_fixed_schedule if policy == "fixed" else \
            build_dynamic_schedule
        st = build(torch.from_numpy(idx), E, M)
        return (st.seg_start, st.block_expert, st.block_active, st.block_m,
                st.capacity)
    sj = jax_fixed(jnp.asarray(idx), E, M) if policy == "fixed" else \
        jax_dynamic(jnp.asarray(idx), E, M, block_m_min=8)
    seg = sj.seg_start if sj.seg_start is not None else sj.group_offsets[:-1]

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32))
    return t(seg), t(sj.block_expert), t(sj.block_active), sj.block_m, \
        sj.capacity


def check_walk(idx, E, M, policy, side, scheme, dtype, seed):
    """Both GEMMs through the walk against the plain versions (K = 176;
    B2 48 output columns, B1 80, a distinct row_scale per row)."""
    K = 176
    seg, be, ba, bm, cap = schedule(idx, E, M, policy, side)
    _, tiles = et.expert_tiles_plain(seg, be, ba, block_m=bm, capacity=cap)
    rng = np.random.default_rng(seed)
    dt = DT[dtype]
    x = torch.from_numpy(rng.standard_normal((cap, K)).astype(np.float32)
                         ).to(dt)
    sch = tq.get_scheme(scheme)
    qg, qu, qd = (sch.quantize(torch.from_numpy(
        (rng.standard_normal((E, K, n)) * K ** -0.5).astype(np.float32)
    ).to(dt)) for n in (48, 48, 80))
    rs = torch.from_numpy(rng.permutation(np.linspace(0.25, 2.0, cap))
                          .astype(np.float32))
    (g, sg, fmt), (u, su, _), (d, sd, _) = map(operands, (qg, qu, qd))
    want_b2 = fgu.fused_gate_up_plain(x, g, u, be, ba, block_m=bm,
                                      wg_scale=sg, wu_scale=su, w_format=fmt)
    want_b1 = gg.grouped_gemm_plain(x, d, be, ba, block_m=bm, row_scale=rs,
                                    w_scale=sd, w_format=fmt)
    got_b2 = quant_walk(x, [(g, sg), (u, su)], tiles, fmt)
    got_b1 = quant_walk(x, [(d, sd)], tiles, fmt, rs)
    if dtype == "float32":
        tol = dict(rtol=1e-5, atol=1e-5)
    else:                                  # one bf16 rounding apart
        tol = dict(rtol=2 ** -7, atol=1e-6)
        got_b2, got_b1 = got_b2.to(dt), got_b1.to(dt)
    torch.testing.assert_close(got_b2.float(), want_b2.float(), **tol)
    torch.testing.assert_close(got_b1.float(), want_b1.float(), **tol)
    dead = np.repeat(ba.numpy() == 0, bm)
    assert not got_b1[dead].any() and not got_b2[dead].any()


# (T, E, k): moonshot's (E=64) and deepseek-v2's (E=160) decode and
# prefill-chunk routings at small widths
SERVING = [(2, 64, 6), (4, 64, 6), (64, 64, 6), (2, 160, 6), (4, 160, 6),
           (64, 160, 6)]


@pytest.mark.parametrize("side", ["port", "reference"])
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("T,E,k", SERVING)
def test_quant_walk_matches_plain_on_serving_schedules(T, E, k, scheme,
                                                       policy, side):
    idx = routed(T, E, k, seed=T + E)
    dtype = "bfloat16" if T == 4 else "float32"
    check_walk(idx, E, 128, policy, side, scheme, dtype, seed=T)
    used = np.bincount(idx.reshape(-1), minlength=E)
    assert used[E - 1] == 0 and used[E - 2] == 1


# tokens per expert (E = 8): experts with 0 and 1 tokens, runs longer than
# a 128-row pass and than a 256-row tile
COUNTS = (1, 0, 37, 130, 0, 9, 300, 64)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("policy,M", [("fixed", 8), ("fixed", 128),
                                      ("dynamic", 128)])
def test_quant_walk_matches_plain_on_long_runs(policy, M, scheme, dtype):
    rng = np.random.default_rng(M)
    idx = rng.permutation(np.repeat(np.arange(len(COUNTS)), COUNTS))
    check_walk(idx[:, None].astype(np.int32), len(COUNTS), M, policy,
               "port", scheme, dtype, seed=M)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_quant_walk_matches_pallas(scheme, dtype):
    """One small case of each scheme against the reference's quantized
    Pallas kernels in interpret mode (fixed, 8-row blocks), on payloads
    quantized by both sides from the same weights."""
    T, E, k, d, f, M = 64, 8, 2, 32, 48, 8
    rng = np.random.default_rng(T + E)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    x = (rng.standard_normal((T, d)) * 0.5).astype(np.float32)
    wg, wu = ((rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    w, idx = jref.router_ref(jnp.asarray(logits), k)
    js = jax_fixed(idx, E, M)
    ts = build_fixed_schedule(torch.from_numpy(np.array(idx)), E, M)
    jsch, tsch = jq.get_scheme(scheme), tq.get_scheme(scheme)
    qj = [jsch.quantize(jnp.asarray(a, jdt)) for a in (wg, wu, wd)]
    qt = [tsch.quantize(torch.from_numpy(a).to(DT[dtype]))
          for a in (wg, wu, wd)]
    xpj = jref.permute_ref(jnp.asarray(x, jdt), js)
    xpt = tref.permute_ref(torch.from_numpy(x).to(DT[dtype]), ts)
    _, tiles = et.expert_tiles_plain(ts.seg_start, ts.block_expert,
                                     ts.block_active, block_m=M,
                                     capacity=ts.capacity)
    (g, sg, fmt), (u, su, _), (dn, sd, _) = map(operands, qt)
    hj = jops.fused_gate_up(xpj, qj[0], qj[1], js, block_n=min(f, 128),
                            block_k=min(d, 128))
    h = quant_walk(xpt, [(g, sg), (u, su)], tiles, fmt).to(DT[dtype])
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(hj, np.float32), **tol)
    sj = jax_combine_rows(js, w)
    st = combine_scale_rows(ts, torch.from_numpy(np.array(w)))
    yj = jops.grouped_gemm(hj, qj[2], js, row_scale=sj, block_n=min(d, 128),
                           block_k=min(f, 128))
    ht = torch.from_numpy(np.asarray(hj, np.float32)).to(DT[dtype])
    y = quant_walk(ht, [(dn, sd)], tiles, fmt, st).to(DT[dtype])
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yj, np.float32), **tol)
