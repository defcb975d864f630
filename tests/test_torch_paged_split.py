"""The GQA paged-attention kernel's split-and-merge walk, modelled in plain
PyTorch, against the plain version and the JAX package.

On the card the GQA kernel cuts each row's table entries into contiguous
splits (``split_plan``, from the shapes alone), walks each (row, KV head,
split) with one warp, entry by entry, and merges the live splits in
order.  ``paged_decode_attention_walk`` repeats that walk
with the kernel's rounding (fp32 statistics, p rounded to V's dtype before
PV); here it is held against ``paged_decode_attention_plain`` and
``repro.kernels.paged_attention.paged_decode_attention`` in interpret mode
on the same numpy-seeded inputs: fp32 within 1e-5, bf16 within 2e-2 (the
port's ``TOL``).  A small ``sms`` forces the plans of a long table onto a
short one.  The plan itself is checked for covering every table entry
once."""
import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_decode_attention as jax_paged
from repro_torch.kernels.paged_attention import (
    GQA_WARPS, gqa_warps, paged_decode_attention_plain,
    paged_decode_attention_walk, split_plan)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def inputs(seed, *, B=3, nb=10, bs=4, Hkv=2, G=1, D=16, lim=None):
    rng = np.random.default_rng(seed)
    n_blocks = B * nb + 3
    k = rng.standard_normal((n_blocks, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:B * nb].reshape(B, nb).astype(np.int32)
    if lim is None:
        lim = rng.integers(0, nb * bs, B)
    return q, k, v, tables, np.asarray(lim, np.int32)


def run_three(args, dtype, sms, q_pos=None, **kw):
    """(walk, plain, Pallas in interpret mode) outputs as fp32 numpy."""
    q, k, v, tables, lim = args
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lim)
    tkw = dict(kw)
    jkw = dict(kw)
    if q_pos is not None:
        tkw["q_pos"] = torch.from_numpy(np.asarray(q_pos, np.int32))
        jkw["q_pos"] = jnp.asarray(np.asarray(q_pos, np.int32))
    walk = paged_decode_attention_walk(tq, tk, tv, tt, tl, sms=sms, **tkw)
    plain = paged_decode_attention_plain(tq, tk, tv, tt, tl, **tkw)
    assert walk.dtype == TDT[dtype] and walk.shape == plain.shape
    want = jax_paged(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                     jnp.asarray(tables), jnp.asarray(lim), interpret=True,
                     **jkw)
    return (walk.float().numpy(), plain.float().numpy(),
            np.asarray(want, np.float32))


# (name, input kwargs, call kwargs, sms): each a case of the walk.  With
# B=3, Hkv=2 the plan takes one split an entry at sms=132, 4 splits of 3
# entries at sms=6 (nb=10: the last split has 1; nb=11: 2), 2 of 5 at
# sms=4 (nb=10) and 5 of 3 at sms=8 (nb=13).
CASES = {
    "kv_limit_in_first_block": (dict(lim=[0, 2, 3]), {}, 6),
    "all_but_one_split_past_kv_limit": (dict(lim=[3, 15, 9]), {}, 6),
    "one_entry_splits": (dict(lim=[39, 1, 20]), {}, 132),
    "window_empties_whole_splits": (
        dict(lim=[39, 30, 25]),
        dict(q_pos=[39, 30, 25], causal=True, window=6), 6),
    "softcap": (dict(), dict(logit_softcap=3.0), 6),
    "nb_not_a_multiple_of_split": (dict(nb=11), {}, 6),
    "two_long_splits": (dict(nb=10), {}, 4),
    "scale_and_long_table": (dict(nb=13, lim=[51, 40, 7]), dict(scale=0.3),
                             8),
    # blocks of 32 positions (two chunks) and heads of 256 (on the card: 3
    # warps a block in bf16 and 1 in fp32)
    "wide_heads_blocks_of_32": (dict(nb=5, bs=32, D=256), {}, 6),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_matches_plain_and_pallas(name, G, dtype):
    in_kw, call_kw, sms = CASES[name]
    walk, plain, want = run_three(inputs(40 + G, G=G, **in_kw), dtype, sms,
                                  **call_kw)
    np.testing.assert_allclose(walk, plain, **TOL[dtype])
    np.testing.assert_allclose(walk, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
def test_fully_masked_row_is_exact_zeros(G, dtype):
    """Row 0 has kv_limit -1 (no live split); row 1's window lies past its
    kv_limit (live splits, every position masked); row 2 attends."""
    args = inputs(50, G=G, lim=[-1, 20, 30])
    walk, plain, want = run_three(args, dtype, 4, q_pos=[5, 40, 30],
                                  window=3)
    for out in (walk, plain, want):
        assert np.array_equal(out[:2], np.zeros_like(out[:2]))
    np.testing.assert_allclose(walk, plain, **TOL[dtype])
    np.testing.assert_allclose(walk, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_past_kv_limit_stay_out(dtype):
    """Blocks past kv_limit, in the first split's range and in later
    splits', poisoned with NaN: the walk never reads them."""
    q, k, v, tables, _ = inputs(60, nb=12, G=4)
    lim = np.asarray([5, 3, 7], np.int32)              # block 0 or 1 only
    clean, plain, want = run_three((q, k, v, tables, lim), dtype, 4)
    k2, v2 = k.copy(), v.copy()
    k2[tables[:, 2:]] = np.nan
    v2[tables[:, 2:]] = np.nan
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k2, v2))
    got = paged_decode_attention_walk(tq, tk, tv, torch.from_numpy(tables),
                                      torch.from_numpy(lim), sms=4)
    assert np.array_equal(got.float().numpy(), clean)
    np.testing.assert_allclose(clean, plain, **TOL[dtype])
    np.testing.assert_allclose(clean, want, **TOL[dtype])


@pytest.mark.parametrize("B,Hkv,nb,sms", [
    (2, 16, 8, 132),        # moonshot decode: 8 splits of 1 entry
    (64, 16, 8, 132),       # moonshot's 64-row chunk step: one split
    (2, 16, 512, 132),      # long context: 32 splits of 16 entries
    (32, 16, 128, 132),     # 32 rows of 2,048 positions: 2 splits of 64
    (2, 8, 8, 132),         # mixtral's GQA decode
    (3, 2, 10, 4), (1, 1, 1, 132), (5, 3, 97, 7), (1, 1, 1000, 132)])
def test_split_plan_covers_every_entry_once(B, Hkv, nb, sms):
    n_split, per = split_plan(B, Hkv, nb, sms)
    assert 1 <= n_split <= nb and per >= 1
    owners = [[s for s in range(n_split) if s * per <= j < (s + 1) * per]
              for j in range(nb)]
    assert all(len(o) == 1 for o in owners)            # exactly one split
    assert (n_split - 1) * per < nb                    # no empty split
    assert split_plan(B, Hkv, nb, sms) == (n_split, per)


def test_split_plan_reads_shapes_only_and_fills_the_card():
    """The plan's inputs are (B, Hkv, nb, SM count), never kv_limit.  A
    block takes GQA_WARPS KV heads.  At moonshot's decode it makes one
    split an entry; at long context and at 32 rows of 2,048 positions as
    many splits as fill the plan's 2 x 132 block slots once; at the 64-row
    chunk step, whose blocks already fill them, one."""
    assert list(inspect.signature(split_plan).parameters) == \
        ["B", "Hkv", "nb", "sms"]
    assert GQA_WARPS == 4
    assert split_plan(2, 16, 8, 132) == (8, 1)
    assert split_plan(64, 16, 8, 132) == (1, 8)
    for B, nb in ((2, 512), (32, 128)):
        n_split, per = split_plan(B, 16, nb, 132)
        blocks = B * 4 * n_split
        assert 2 * 132 * 0.8 < blocks <= 2 * 132
        assert per == -(-nb // n_split)


@pytest.mark.parametrize("bs,D,Dv,itemsize,warps", [
    (16, 128, 128, 2, 4), (16, 128, 128, 4, 4), (32, 256, 256, 2, 3),
    (32, 256, 256, 4, 1), (16, 256, 256, 4, 3), (64, 256, 256, 4, 0)])
def test_gqa_warps_fit_their_rings(bs, D, Dv, itemsize, warps):
    """Each warp keeps two (bs, D + Dv) tiles; a block has 227 KB."""
    assert gqa_warps(bs, D, Dv, itemsize) == warps
    assert warps * 2 * bs * (D + Dv) * itemsize <= 232448
