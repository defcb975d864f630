"""The bf16 MLA paged-attention kernel's split-and-merge walk, modelled in
plain PyTorch, against the plain version and the JAX package.

On the card the bf16 MLA kernel (deepseek-v2's absorbed decode: scores
``q . ckv + q2 . kr``, the latent ``ckv`` also the value) cuts each row's
table entries into contiguous splits (``mla_split_plan``, from the shapes
alone, a whole number of the kernel's tiles a split), walks each (row, KV
head, 64 query heads, split) a tile of ``mla_tile`` positions at a time,
and merges the live splits in order.  ``paged_decode_attention_mla_walk``
repeats that walk with the kernel's rounding (fp32 scores and statistics,
p rounded to the latent's dtype before PV); here it is held against
``paged_decode_attention_plain`` and
``repro.kernels.paged_attention.paged_decode_attention`` with ``q2`` and
``k2_pool`` in interpret mode on the same numpy-seeded inputs: fp32 within
1e-5, bf16 within 2e-2 (the port's ``TOL``).  The latent is 64 wide and the
rope key 8, so that a split's fp32 partial costs the plan about as many
pool blocks as at deepseek's 512 + 64: long tables then split.  The plan
itself is checked for covering every table entry once."""
import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")      # the reference side; absent on the card
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_decode_attention as jax_paged
from repro_torch.kernels.paged_attention import (
    MLA_HEADS, mla_split_plan, mla_tile, paged_decode_attention_mla_walk,
    paged_decode_attention_plain)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
D, D2 = 64, 8


def inputs(seed, *, B=3, nb=13, bs=16, G=4, lim=None):
    rng = np.random.default_rng(seed)
    n_blocks = B * nb + 3
    ckv = rng.standard_normal((n_blocks, bs, 1, D)).astype(np.float32)
    kr = rng.standard_normal((n_blocks, bs, 1, D2)).astype(np.float32)
    q = rng.standard_normal((B, 1, G, D)).astype(np.float32)
    q2 = rng.standard_normal((B, 1, G, D2)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:B * nb].reshape(B, nb).astype(np.int32)
    if lim is None:
        lim = rng.integers(0, nb * bs, B)
    return q, q2, ckv, kr, tables, np.asarray(lim, np.int32)


def walk(args, dtype, sms, q_pos=None, **kw):
    q, q2, ckv, kr, tables, lim = args
    tq, tq2, tckv, tkr = (torch.from_numpy(a).to(TDT[dtype])
                          for a in (q, q2, ckv, kr))
    if q_pos is not None:
        kw["q_pos"] = torch.from_numpy(np.asarray(q_pos, np.int32))
    return paged_decode_attention_mla_walk(
        tq, tckv, tkr, torch.from_numpy(tables), torch.from_numpy(lim),
        q2=tq2, sms=sms, **kw)


def run_three(args, dtype, sms, q_pos=None, **kw):
    """(walk, plain, Pallas in interpret mode) outputs as fp32 numpy."""
    q, q2, ckv, kr, tables, lim = args
    tq, tq2, tckv, tkr = (torch.from_numpy(a).to(TDT[dtype])
                          for a in (q, q2, ckv, kr))
    tkw, jkw = dict(kw), dict(kw)
    if q_pos is not None:
        tkw["q_pos"] = torch.from_numpy(np.asarray(q_pos, np.int32))
        jkw["q_pos"] = jnp.asarray(np.asarray(q_pos, np.int32))
    got = walk(args, dtype, sms, q_pos=q_pos, **kw)
    plain = paged_decode_attention_plain(
        tq, tckv, tckv, torch.from_numpy(tables), torch.from_numpy(lim),
        q2=tq2, k2_pool=tkr, **tkw)
    assert got.dtype == TDT[dtype] and got.shape == plain.shape
    jq, jq2, jckv, jkr = (jnp.asarray(a, JDT[dtype]) for a in (q, q2, ckv, kr))
    want = jax_paged(jq, jckv, jckv, jnp.asarray(tables), jnp.asarray(lim),
                     q2=jq2, k2_pool=jkr, interpret=True, **jkw)
    return (got.float().numpy(), plain.float().numpy(),
            np.asarray(want, np.float32))


SC = (D + D2) ** -0.5              # the model's (r + dr)^-0.5
# (name, input kwargs, call kwargs, sms): each a case of the walk.  With
# B=3 and one tile of 64 heads a row: bs=16, nb=48 takes 12 splits of one
# tile (4 entries) at sms=132 and 2 of six tiles at sms=8; nb=50 at sms=5
# one split of 13 tiles (the last of 2 entries); bs=8, nb=61 takes 8
# splits of one tile (8 entries; the last 5); bs=4, nb=40 3 splits of one
# tile of 16 entries, the last of 8; bs=64 and bs=48 a pool block a tile
# (48 leaves 16 rows of each tile unloaded).
CASES = {
    "bs16_one_tile_splits": (dict(nb=48, lim=[767, 200, 31]),
                             dict(scale=SC), 132),
    "bs16_two_long_splits": (dict(nb=48), dict(scale=SC), 8),
    "bs8_last_split_short": (dict(nb=61, bs=8), dict(scale=SC), 132),
    "bs4_partial_last_tile": (dict(nb=40, bs=4), {}, 132),
    "one_split_many_tiles": (dict(nb=50), dict(scale=SC), 5),
    "scalar_kv_limit": (dict(nb=48, lim=300), dict(scale=SC), 132),
    "causal_window_empties_splits": (
        dict(nb=48, lim=[700, 500, 90]),
        dict(q_pos=[700, 480, 90], causal=True, window=100, scale=SC), 132),
    "softcap": (dict(nb=61, bs=8), dict(logit_softcap=0.5, scale=SC), 132),
    "bs64_block_a_tile": (dict(nb=12, bs=64, lim=[767, 200, 63]),
                          dict(scale=SC), 132),
    "bs48_short_tiles": (dict(nb=13, bs=48), {}, 8),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [4, 20])
@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_matches_plain_and_pallas(name, G, dtype):
    in_kw, call_kw, sms = CASES[name]
    got, plain, want = run_three(inputs(70 + G, G=G, **in_kw), dtype, sms,
                                 **call_kw)
    np.testing.assert_allclose(got, plain, **TOL[dtype])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [4, 20])
def test_fully_masked_row_is_exact_zeros(G, dtype):
    """Row 0 has kv_limit -1 (no live split); row 1's window lies past its
    kv_limit (live splits, every position masked); row 2 attends."""
    args = inputs(80, G=G, nb=48, lim=[-1, 300, 400])
    got, plain, want = run_three(args, dtype, 132, q_pos=[5, 600, 400],
                                 window=3, scale=SC)
    assert mla_split_plan(3, 1, G, 48, 16, D, D2, 132)[0] > 1
    for out in (got, plain, want):
        assert np.array_equal(out[:2], np.zeros_like(out[:2]))
    np.testing.assert_allclose(got, plain, **TOL[dtype])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_past_kv_limit_stay_out(dtype):
    """NaN in every block past kv_limit, in the first split's range and in
    later splits': the walk never reads them, so its output is bitwise its
    clean output (the plain version and Pallas read every block, so they
    are compared on the clean pools only)."""
    q, q2, ckv, kr, tables, _ = inputs(90, nb=48, G=20)
    lim = np.asarray([5, 20, 40], np.int32)            # blocks 0-2 only
    clean, plain, want = run_three((q, q2, ckv, kr, tables, lim), dtype, 132,
                                   scale=SC)
    ckv2, kr2 = ckv.copy(), kr.copy()
    ckv2[tables[:, 3:]] = np.nan
    kr2[tables[:, 3:]] = np.nan
    got = walk((q, q2, ckv2, kr2, tables, lim), dtype, 132, scale=SC)
    assert np.array_equal(got.float().numpy(), clean)
    np.testing.assert_allclose(clean, plain, **TOL[dtype])
    np.testing.assert_allclose(clean, want, **TOL[dtype])


@pytest.mark.parametrize("B,G,nb,bs,Dl,Dr,sms", [
    (2, 128, 8, 16, 512, 64, 132),      # deepseek decode: 2 splits of 4
    (64, 128, 4, 16, 512, 64, 132),     # the 64-row chunk step: one split
    (2, 128, 512, 16, 512, 64, 132),    # long context: 32 splits of 16
    (32, 128, 128, 16, 512, 64, 132),   # 32 rows of 2,048: 2 splits of 64
    (2, 120, 8, 16, 512, 64, 132),      # 120 heads: two head tiles
    (3, 4, 48, 16, 64, 8, 132), (3, 4, 61, 8, 64, 8, 132),
    (3, 4, 40, 4, 64, 8, 132), (1, 4, 1, 1, 64, 8, 132),
    (5, 20, 97, 3, 488, 88, 7), (1, 16, 1000, 32, 512, 64, 132),
    (2, 128, 40, 64, 512, 64, 132), (3, 4, 13, 48, 64, 8, 8)])
def test_mla_split_plan_covers_every_entry_once(B, G, nb, bs, Dl, Dr, sms):
    n_split, per = mla_split_plan(B, 1, G, nb, bs, Dl, Dr, sms)
    assert 1 <= n_split <= nb and per >= 1
    nbt = max(1, mla_tile(Dl, Dr) // bs)
    assert per % nbt == 0 or n_split == 1     # whole tiles, but for one split
    owners = [[s for s in range(n_split) if s * per <= j < (s + 1) * per]
              for j in range(nb)]
    assert all(len(o) == 1 for o in owners)            # exactly one split
    assert (n_split - 1) * per < nb                    # no empty split
    assert mla_split_plan(B, 1, G, nb, bs, Dl, Dr, sms) == (n_split, per)


def test_mla_split_plan_reads_shapes_only_and_counts_partials():
    """The plan's inputs are shapes and the SM count, never kv_limit.  At
    deepseek's shape (128 heads, 512 + 64, blocks of 16): decode takes two
    splits of one tile a row, the chunk step one split; long context as
    many splits as fill the card once (16 entries, not one tile: a second
    round of blocks costs more than the partials save); 32 rows of 2,048
    two splits."""
    assert list(inspect.signature(mla_split_plan).parameters) == \
        ["B", "Hkv", "G", "nb", "bs", "D", "D2", "sms"]
    assert MLA_HEADS == 64
    assert mla_split_plan(2, 1, 128, 8, 16, 512, 64, 132) == (2, 4)
    assert mla_split_plan(64, 1, 128, 4, 16, 512, 64, 132) == (1, 4)
    assert mla_split_plan(2, 1, 128, 512, 16, 512, 64, 132) == (32, 16)
    assert mla_split_plan(32, 1, 128, 128, 16, 512, 64, 132) == (2, 64)


@pytest.mark.parametrize("Dl,Dr,tile", [(512, 64, 64), (32, 8, 64),
                                        (64, 512, 64), (488, 88, 32),
                                        (8, 568, 32)])
def test_mla_tile_fits_two_stages(Dl, Dr, tile):
    """A tile of 64 positions where the row has at most nine 64-column
    groups (the kernel unrolls nine: the q tile and two stages of them fit
    in 227 KB), 32 where it has ten."""
    ng = -(-Dl // 64) + -(-Dr // 64)
    assert mla_tile(Dl, Dr) == tile
    NG = 9 if tile == 64 else 10            # the kernel's unrolled groups
    assert ng <= NG
    # q tile, two stages, P exchange, row statistics, barriers, alignment
    smem = 1024 + NG * 8192 + 2 * NG * tile * 128 + tile * 128 + 512 + 40
    assert smem <= 232448
