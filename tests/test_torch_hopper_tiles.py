"""The Hopper GEMMs on the CPU: their work lists, the forward's walk over
them, and B7's ``out_dtype``.

* ``expert_tiles_plain`` (the plain version of csrc/expert_tiles.cu's work
  lists) on the port's and the reference's ``fixed``, ``dynamic`` and
  ``capacity_factor`` schedules of the same routing, at small
  training-like shapes and at the serving shapes the forward walks (E=64
  and 160, T=2, 4 and 64: nearly every block inactive): every row of the
  schedule lies in exactly one tile; an expert's tiles hold only its
  active rows, the zero tiles only inactive rows (under
  ``capacity_factor`` these are also the bucket tails, the empty buckets
  and the sentinel block); no tile is longer than ``TILE_ROWS``; the count
  is within ``max_tiles``, the kernel's scratch and grid bound; each
  expert's run is its active rows from ``seg_start``; both schedules give
  the same lists.  Under ``fixed`` and ``dynamic`` the lists are tile for
  tile those of the rule they were built by before ``capacity_factor``
  (zero tiles past the last active block only).
* A tile-walk oracle (``tile_walk``): the forward's B1 and B2 computed from
  those lists the way grouped_gemm_hopper.cuh walks them (per tile, x's
  rows against the tile's expert in fp32, row_scale on the stored rows or
  the SiLU product, zeros on zero tiles), held against
  ``grouped_gemm_plain`` and ``fused_gate_up_plain`` (which walk the
  schedule's blocks) at fp32 tolerance, on both sides' schedules, with a
  distinct row_scale per row and experts with 0 and 1 tokens.
* ``grouped_wgrad(..., out_dtype=torch.bfloat16)`` against the reference's
  Pallas ``grouped_wgrad(..., out_dtype=jnp.bfloat16, interpret=True)``
  with experts that received no tokens zeroed as
  ``repro.kernels.ops.grouped_wgrad`` zeroes them: both round an fp32 sum
  once, in another order, so within one bf16 ulp (rtol 2**-7) of each
  other; and bitwise ``.to(bfloat16)`` of the fp32 result.
(The device lists and the bf16-output kernel are held against these on the
card: test_torch_gpu.py and chip_smoke.py.)"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.core.schedule import build_schedule as jax_fixed  # noqa: E402
from repro.kernels import grouped_wgrad as jwg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.scheduling.capacity import build_capacity_schedule as jax_capacity  # noqa: E402
from repro.scheduling.dynamic import build_dynamic_schedule as jax_dynamic  # noqa: E402
from repro_torch.kernels import expert_tiles as et
from repro_torch.kernels import fused_gate_up as fgu
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.scheduling import (build_capacity_schedule,
                                    build_dynamic_schedule,
                                    build_fixed_schedule)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

# (T, E, k, block_m): tests/test_torch_grouped_wgrad.py's sizes, runs long
# enough for several tiles an expert, and the serving schedules the
# forward walks: moonshot's (E=64) and deepseek-v2's (E=160) decode T=2
# and 4 and prefill T=64, k=6 (dynamic: 8-row blocks)
CASES = [(32, 4, 1, 8), (64, 8, 2, 8), (128, 16, 4, 16), (512, 4, 2, 128),
         (2, 64, 6, 128), (4, 64, 6, 128), (64, 64, 6, 128),
         (2, 160, 6, 128), (4, 160, 6, 128), (64, 160, 6, 128)]


# the capacity_factor policy's headroom here: the reference's sweep value,
# under which the buckets of these routings have inactive tails, empty
# buckets and (skewed) drops
CAPACITY_FACTOR = 1.25


def routed(T, E, k, seed, skew=False):
    """(T, k) distinct experts per token from a seeded permutation; with
    ``skew`` half the tokens go to expert 0 first."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    if skew:
        for t in np.flatnonzero(rng.random(T) < 0.5):
            idx[t] = np.concatenate([[0], rng.permutation(np.arange(1, E))
                                     [:k - 1]])
    return idx.astype(np.int32)


def both_schedules(idx, E, M, policy):
    """The port's schedule and the reference's, as int32 torch arrays:
    (seg_start, block_expert, block_active, block_m, capacity)."""
    if policy == "fixed":
        st = build_fixed_schedule(torch.from_numpy(idx), E, M)
        sj = jax_fixed(jnp.asarray(idx), E, M)
    elif policy == "capacity_factor":
        st = build_capacity_schedule(torch.from_numpy(idx), E, M,
                                     capacity_factor=CAPACITY_FACTOR)
        sj = jax_capacity(jnp.asarray(idx), E, M,
                          capacity_factor=CAPACITY_FACTOR)
    else:
        st = build_dynamic_schedule(torch.from_numpy(idx), E, M,
                                    block_m_min=8)
        sj = jax_dynamic(jnp.asarray(idx), E, M, block_m_min=8)
    seg_j = sj.seg_start if sj.seg_start is not None else \
        sj.group_offsets[:-1]

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32))
    return ((st.seg_start, st.block_expert, st.block_active, st.block_m,
             st.capacity),
            (t(seg_j), t(sj.block_expert), t(sj.block_active), sj.block_m,
             sj.capacity))


def check_lists(runs, tiles, be, ba, block_m, capacity):
    E = runs.shape[0]
    be, ba = be.numpy(), ba.numpy()
    row_expert = np.repeat(np.where(ba != 0, be, -1), block_m)
    assert tiles.shape[0] <= et.max_tiles(capacity, E)
    cover = np.zeros(capacity, np.int64)
    experts_seen = []
    for e, r0, n in tiles.tolist():
        assert 0 < n <= et.TILE_ROWS and r0 + n <= capacity
        cover[r0:r0 + n] += 1
        assert np.all(row_expert[r0:r0 + n] == e), (e, r0, n)
        experts_seen.append(e)
    assert np.all(cover == 1)
    live = [e for e in experts_seen if e >= 0]
    assert live == sorted(live)                   # expert order ...
    assert experts_seen == live + [-1] * (len(experts_seen) - len(live))
    for e, (s, t) in enumerate(runs.tolist()):    # ... then the zero tiles
        rows = np.flatnonzero(row_expert == e)
        if rows.size:
            assert (s, t) == (rows[0], rows[-1] + 1) and t - s == rows.size
        else:
            assert s == t


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("policy", ["fixed", "dynamic", "capacity_factor"])
@pytest.mark.parametrize("T,E,k,M", CASES)
def test_work_lists_cover_the_schedule_once(T, E, k, M, policy, skew):
    idx = routed(T, E, k, seed=T + E, skew=skew)
    lists = []
    for seg, be, ba, bm, cap in both_schedules(idx, E, M, policy):
        runs, tiles = et.expert_tiles_plain(seg, be, ba, block_m=bm,
                                            capacity=cap)
        check_lists(runs, tiles, be, ba, bm, cap)
        got = et.expert_tiles(seg, be, ba, block_m=bm, capacity=cap)
        assert torch.equal(got[0], runs) and torch.equal(got[1], tiles)
        lists.append((runs, tiles))
    (runs_t, tiles_t), (runs_j, tiles_j) = lists
    assert torch.equal(runs_t, runs_j) and torch.equal(tiles_t, tiles_j)


def prefix_lists(seg_start, block_expert, block_active, *, block_m,
                 capacity):
    """The lists as they were built while every policy's active blocks
    formed a prefix: the runs' tiles, then zero tiles from the end of the
    last active block only."""
    runs, tiles = et.expert_tiles_plain(seg_start, block_expert,
                                        block_active, block_m=block_m,
                                        capacity=capacity)
    live = [t for t in tiles.tolist() if t[0] >= 0]
    active = torch.nonzero(block_active != 0).reshape(-1)
    end = (int(active[-1]) + 1) * block_m if active.numel() else 0
    live += [[-1, r, min(et.TILE_ROWS, capacity - r)]
             for r in range(end, capacity, et.TILE_ROWS)]
    return runs, torch.tensor(live, dtype=torch.int32).reshape(-1, 3)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("T,E,k,M", CASES)
def test_fixed_and_dynamic_lists_are_unchanged(T, E, k, M, policy, skew):
    """Under fixed and dynamic the only uncovered span is the tail past the
    last active block, so the lists are tile for tile those of the prefix
    rule; capacity_factor's are not (its buckets leave gaps)."""
    idx = torch.from_numpy(routed(T, E, k, seed=T + E, skew=skew))
    builds = {"fixed": lambda: build_fixed_schedule(idx, E, M),
              "dynamic": lambda: build_dynamic_schedule(idx, E, M),
              "capacity_factor": lambda: build_capacity_schedule(
                  idx, E, M, capacity_factor=CAPACITY_FACTOR)}
    for name in (policy, "capacity_factor"):
        st = builds[name]()
        seg, be, ba = st.seg_start, st.block_expert, st.block_active
        bm, cap = st.block_m, st.capacity
        got = et.expert_tiles_plain(seg, be, ba, block_m=bm, capacity=cap)
        want = prefix_lists(seg, be, ba, block_m=bm, capacity=cap)
        if name == policy:
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    got = et.expert_tiles_plain(seg, be, ba, block_m=bm, capacity=cap)
    want = prefix_lists(seg, be, ba, block_m=bm, capacity=cap)
    a = ba.numpy() != 0
    prefix = not (a[1:] & ~a[:-1]).any()        # no active after inactive
    assert torch.equal(got[1], want[1]) == prefix


def test_experts_with_no_rows_get_empty_runs():
    """Everything routed to experts {1, 2}: the other experts' runs are
    empty and the rows past the two runs are zero tiles."""
    E, M = 6, 8
    idx = np.random.default_rng(0).choice([1, 2], (40, 1)).astype(np.int32)
    for policy in ("fixed", "dynamic"):
        (seg, be, ba, bm, cap), _ = both_schedules(idx, E, M, policy)
        runs, tiles = et.expert_tiles_plain(seg, be, ba, block_m=bm,
                                            capacity=cap)
        check_lists(runs, tiles, be, ba, bm, cap)
        lengths = (runs[:, 1] - runs[:, 0]).tolist()
        assert [e for e in range(E) if lengths[e]] == [1, 2]
        assert int((tiles[:, 0] < 0).sum()) >= 1


def tile_walk(x, ws, tiles, row_scale=None):
    """The forward from the work list, as the Hopper kernel walks it: per
    tile (e, row0, rows), ``x[row0:row0 + rows] @ W[e]`` in fp32 for each
    weight in ``ws``; with one weight (B1) times ``row_scale`` of the
    stored rows, with two (B2) ``silu(g) * u``; zeros on zero tiles and
    wherever no tile reaches.  Returns fp32 (capacity, N)."""
    out = torch.zeros((x.shape[0], ws[0].shape[-1]), dtype=torch.float32)
    for e, r0, n in tiles.tolist():
        if e < 0:
            continue
        xs = x[r0:r0 + n].float()
        prods = [xs @ w[e].float() for w in ws]
        if len(prods) == 2:
            g, u = prods
            out[r0:r0 + n] = g * torch.sigmoid(g) * u
        else:
            y = prods[0]
            out[r0:r0 + n] = y if row_scale is None \
                else y * row_scale[r0:r0 + n, None]
    return out


# tokens per expert (E = 8): experts with 0 and 1 tokens, runs shorter and
# longer than a 256-row tile
COUNTS = (1, 0, 37, 130, 0, 9, 300, 64)


@pytest.mark.parametrize("side", ["port", "reference"])
@pytest.mark.parametrize("policy,M", [("fixed", 8), ("fixed", 16),
                                      ("fixed", 128), ("dynamic", 128),
                                      ("capacity_factor", 8),
                                      ("capacity_factor", 128)])
def test_tile_walk_matches_the_plain_forward_gemms(policy, M, side):
    rng = np.random.default_rng(M)
    idx = rng.permutation(np.repeat(np.arange(len(COUNTS)), COUNTS))
    idx = idx[:, None].astype(np.int32)
    E, K, N = len(COUNTS), 48, 32
    sched = both_schedules(idx, E, M, policy)[side == "reference"]
    seg, be, ba, bm, cap = sched
    _, tiles = et.expert_tiles_plain(seg, be, ba, block_m=bm, capacity=cap)
    x = torch.from_numpy(rng.standard_normal((cap, K)).astype(np.float32))
    w, wg, wu = (torch.from_numpy((rng.standard_normal((E, K, N))
                                   * K ** -0.5).astype(np.float32))
                 for _ in range(3))
    rs = torch.from_numpy(rng.permutation(np.linspace(0.25, 2.0, cap))
                          .astype(np.float32))
    want_b1 = gg.grouped_gemm_plain(x, w, be, ba, block_m=bm, row_scale=rs)
    want_b2 = fgu.fused_gate_up_plain(x, wg, wu, be, ba, block_m=bm)
    torch.testing.assert_close(tile_walk(x, [w], tiles, rs), want_b1,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tile_walk(x, [wg, wu], tiles), want_b2,
                               rtol=1e-5, atol=1e-5)
    rows = np.repeat(np.where(ba.numpy() != 0, be.numpy(), -1), bm)
    assert (rows == 0).sum() >= 1 and not (rows == 1).any()


def padded_pair(T, d, f, sched_t, sched_j, seed):
    """bf16 x and dy in the padded layout (padding rows zero), both sides."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((T, f)).astype(np.float32)
    xt = tref.permute_ref(torch.from_numpy(x).to(torch.bfloat16), sched_t)
    dyt = tref.permute_ref(torch.from_numpy(dy).to(torch.bfloat16), sched_t)
    xj = jref.permute_ref(jnp.asarray(x, jnp.bfloat16), sched_j)
    dyj = jref.permute_ref(jnp.asarray(dy, jnp.bfloat16), sched_j)
    return xt, dyt, xj, dyj


@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("T,E,k,d,f,M", [(32, 4, 1, 16, 32, 8),
                                         (64, 8, 2, 32, 48, 8)])
def test_grouped_wgrad_bf16_out_matches_pallas(T, E, k, d, f, M, policy):
    rng = np.random.default_rng(T)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    idx[idx == E - 1] = 0                  # expert E-1 gets no tokens
    if policy == "fixed":
        sched_t = build_fixed_schedule(torch.from_numpy(idx), E, M)
        sched_j = jax_fixed(jnp.asarray(idx), E, M)
    else:
        sched_t = build_dynamic_schedule(torch.from_numpy(idx), E, M,
                                         block_m_min=8)
        sched_j = jax_dynamic(jnp.asarray(idx), E, M, block_m_min=8)
    xt, dyt, xj, dyj = padded_pair(T, d, f, sched_t, sched_j, seed=k)
    want = jwg.grouped_wgrad(xj, dyj, sched_j.block_expert,
                             sched_j.block_active, n_experts=E,
                             block_m=sched_j.block_m, block_k=min(d, 128),
                             block_n=min(f, 128), interpret=True,
                             out_dtype=jnp.bfloat16)
    want = jnp.where((sched_j.counts > 0)[:, None, None], want, 0.0)
    got = tops.grouped_wgrad(xt, dyt, sched_t, E, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (E, d, f)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-4)
    assert torch.all(got[E - 1] == 0)
    f32 = tops.grouped_wgrad(xt, dyt, sched_t, E)
    assert torch.equal(got, f32.to(torch.bfloat16))
    assert torch.equal(tref.grouped_wgrad_ref(xt, dyt, sched_t, E,
                                              out_dtype=torch.bfloat16), got)
