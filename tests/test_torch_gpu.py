"""On the card: the port's CUDA kernels against their plain PyTorch versions
(the MoE kernels on the fixed and the dynamic policy's 8-row schedules, the
forward's and the backward's Hopper GEMMs at shapes that stress their
tiling, on dense weights and on int8 and int4 ones, the paged
decode-attention kernel over its masks, and its MLA form; the router over
ties, all-equal rows and -inf logits, and the combine bitwise, at one to
4096 tokens), the MoE layer without a host sync under
both policies and on quantized weights, the contiguous and paged
engines' launch counts (dense and int8 experts; MLA), the MLA engine's
gather read where its KV blocks are wider than the kernel takes, the GQA
kernel at the dense family's attention shapes, a reduced gemma2
engine's fused read against its gather read, and sampling and
speculation: threefry bits and sampled tokens on the card equal to the
CPU's, the speculative verify's launch counts, and a speculative round
without a host sync.

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
from repro_torch.kernels._build import BACKWARD_KERNELS, QUANT_KERNELS
from repro_torch.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain,
    paged_decode_attention_walk)
from repro_torch.scheduling import (build_capacity_schedule,
                                    build_dynamic_schedule,
                                    build_fixed_schedule)

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
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [2, 4, 64])
def test_gemms_on_dynamic_8_row_blocks_match_plain(cuda, T, dtype):
    E, k, d, f = 64, 6, 256, 192
    logits, x, wg, wu, wd = layer(cuda, T, E, k, d, f, DTYPES[dtype], seed=T)
    w, idx = ref.router_ref(logits, k, gating="sigmoid", norm_topk=True,
                            routed_scale=2.446)
    sched = build_dynamic_schedule(idx, E, 128)
    assert sched.block_m == 8
    xp = ops.permute(x, sched)
    h = ops.fused_gate_up(xp, wg, wu, sched)
    torch.testing.assert_close(
        h.float(), ref.fused_gate_up_ref(xp, wg, wu, sched).float(),
        **TOL[dtype])
    scale = combine_scale_rows(sched, w)
    y = ops.grouped_gemm(h, wd, sched, row_scale=scale)
    torch.testing.assert_close(
        y.float(), ref.grouped_gemm_ref(h, wd, sched, scale).float(),
        **TOL[dtype])
    dead = (sched.block_active == 0).repeat_interleave(8)
    assert torch.equal(h[dead], torch.zeros_like(h[dead]))
    assert torch.equal(y[dead], torch.zeros_like(y[dead]))
    torch.cuda.synchronize()


def paged_inputs(dev, B, Hkv, G, D, Dv, bs, nb, dt):
    g = torch.Generator(device=dev).manual_seed(B)
    n_blocks = B * nb + 3
    kp = torch.randn(n_blocks, bs, Hkv, D, generator=g, device=dev).to(dt)
    vp = torch.randn(n_blocks, bs, Hkv, Dv, generator=g, device=dev).to(dt)
    q = torch.randn(B, Hkv, G, D, generator=g, device=dev).to(dt)
    tables = torch.randperm(n_blocks, generator=g, device=dev)[:B * nb]
    tables = tables.reshape(B, nb).to(torch.int32).contiguous()
    lim = torch.randint(0, nb * bs, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    return q, kp, vp, tables, lim


# moonshot decode and chunk steps, mixtral's GQA, a narrow odd shape, and
# tables of 512 entries (long context: 32 splits at B=2, Hkv=16), where
# most splits start past a short row's kv_limit
PAGED_SHAPES = [(2, 16, 1, 128, 128, 16, 8), (64, 16, 1, 128, 128, 16, 8),
                (5, 8, 4, 128, 128, 16, 6), (3, 2, 2, 16, 32, 4, 5),
                (2, 16, 1, 128, 128, 16, 512), (3, 8, 4, 128, 128, 16, 512),
                (4, 2, 3, 64, 32, 16, 100), (2, 4, 1, 256, 256, 32, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hkv,G,D,Dv,bs,nb", PAGED_SHAPES)
def test_paged_attention_kernel_matches_plain(cuda, B, Hkv, G, D, Dv, bs, nb,
                                              dtype):
    q, kp, vp, tables, lim = paged_inputs(cuda, B, Hkv, G, D, Dv, bs, nb,
                                          DTYPES[dtype])
    qpos = torch.clamp(lim - 2, min=0)
    short = lim.clone()
    short[0] = bs + 3                  # row 0: one split live of many
    for kv, kw in ((lim, dict()), (lim, dict(q_pos=qpos, causal=True,
                                              window=5)),
                   (lim, dict(logit_softcap=8.0)), (lim, dict(scale=0.3)),
                   (short, dict())):
        out = paged_decode_attention(q, kp, vp, tables, kv, **kw)
        want = paged_decode_attention_plain(q, kp, vp, tables, kv, **kw)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
        # fixed-order merges, no atomics: bitwise equal across two calls
        assert torch.equal(paged_decode_attention(q, kp, vp, tables, kv,
                                                  **kw), out)
    # whole blocks past kv_limit are never read: NaN there, in blocks that
    # later splits would take, leaks nothing
    lim1 = torch.full((B,), bs - 1, dtype=torch.int32, device=cuda)
    base = paged_decode_attention(q, kp, vp, tables, lim1)
    past = tables[:, 1:].reshape(-1).long()
    kp[past] = float("nan")
    vp[past] = float("nan")
    assert torch.equal(paged_decode_attention(q, kp, vp, tables, lim1), base)
    torch.cuda.synchronize()


# the dense family's attention in a decode step (B=2) and a 64-row chunk
# step, blocks of 16: (Hkv, G, D, softcap) of gemma2-9b, qwen2-7b,
# starcoder2-3b and smollm-360m
DENSE_ATTN = {"gemma2": (8, 2, 256, 50.0), "qwen2": (4, 7, 128, None),
              "starcoder2": (2, 12, 128, None), "smollm": (5, 3, 64, None)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B", [2, 64])
@pytest.mark.parametrize("arch", sorted(DENSE_ATTN))
def test_paged_attention_kernel_at_dense_shapes(cuda, arch, B, dtype):
    """GQA groups of 2, 3, 7 and 12 over heads of 64-256 columns (several
    passes of a warp's head tile where G passes it), the model's softcap,
    scalar and vector kv_limit and a causal window: within TOL of the plain
    version and bitwise across two calls."""
    Hkv, G, D, cap = DENSE_ATTN[arch]
    q, kp, vp, tables, lim = paged_inputs(cuda, B, Hkv, G, D, D, 16, 8,
                                          DTYPES[dtype])
    qpos = torch.clamp(lim - 3, min=0)
    for kv, kw in ((lim, dict(logit_softcap=cap)), (60, dict()),
                   (lim, dict(q_pos=qpos, causal=True, window=40,
                              logit_softcap=cap))):
        out = paged_decode_attention(q, kp, vp, tables, kv, **kw)
        want = paged_decode_attention_plain(q, kp, vp, tables, kv, **kw)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
        assert torch.equal(paged_decode_attention(q, kp, vp, tables, kv,
                                                  **kw), out)


@pytest.mark.gpu
def test_paged_gemma2_engine_reads_through_the_kernel(cuda):
    """Reduced gemma2 (local and global layers, softcaps 50 and 30, tied
    head), fp32: the fused read launches the GQA kernel once per layer per
    forward, and serves the gather read's greedy tokens; no MoE kernel
    runs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("gemma2-9b"), layers=4)
    model = init_params(cfg, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 9, 33)]
    outs = {}
    for read in ("fused", "gather"):
        eng = ServeEngine(cfg, model, slots=2, capacity=96, kv_block_size=16,
                          prefill_chunk=32, rc=RunConfig(paged_attn=read))
        reqs = [Request(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
        ops.reset_launches()
        done = eng.run(reqs)
        assert len(done) == 3 and all(len(r.out) == 5 for r in done)
        launches = dict(ops.LAUNCHES)
        assert launches.pop("paged_attention") == \
            (cfg.n_layers * eng.n_forwards if read == "fused" else 0)
        assert all(n == 0 for n in launches.values()), ops.LAUNCHES
        outs[read] = [r.out for r in reqs]
    assert outs["fused"] == outs["gather"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hkv,G,D,Dv,bs,nb", PAGED_SHAPES[::2])
def test_paged_attention_kernel_matches_walk(cuda, B, Hkv, G, D, Dv, bs, nb,
                                             dtype):
    """The kernel against the plain model of its own walk (the card's SM
    count, the same split plan): fp32 within 1e-5, bf16 within TOL; a row
    with every position masked is exact zeros."""
    q, kp, vp, tables, lim = paged_inputs(cuda, B, Hkv, G, D, Dv, bs, nb,
                                          DTYPES[dtype])
    lim[-1] = -1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    out = paged_decode_attention(q, kp, vp, tables, lim)
    want = paged_decode_attention_walk(q, kp, vp, tables, lim, sms=sms)
    tol = TOL[dtype] if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))


@pytest.mark.gpu
def test_paged_attention_no_host_sync(cuda):
    """The wrapper and its two launches (the splits, then their merge) run
    under set_sync_debug_mode("error"): the split plan reads shapes only."""
    q, kp, vp, tables, lim = paged_inputs(cuda, 2, 16, 1, 128, 128, 16, 512,
                                          torch.bfloat16)
    qpos = torch.clamp(lim - 1, min=0)
    paged_decode_attention(q, kp, vp, tables, lim)          # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = paged_decode_attention(q, kp, vp, tables, lim, q_pos=qpos,
                                     causal=True, window=100,
                                     logit_softcap=30.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = paged_decode_attention_plain(q, kp, vp, tables, lim, q_pos=qpos,
                                        causal=True, window=100,
                                        logit_softcap=30.0)
    torch.testing.assert_close(out.float(), want.float(), **TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,G,D,D2,bs,nb", [(2, 128, 512, 64, 16, 8),
                                            (20, 128, 512, 64, 16, 3),
                                            (5, 20, 512, 64, 16, 4),
                                            (3, 4, 32, 8, 4, 5),
                                            (4, 20, 64, 16, 32, 3),
                                            (3, 128, 512, 64, 64, 4),
                                            (4, 20, 64, 16, 48, 3)])
def test_paged_attention_mla_kernel_matches_plain(cuda, B, G, D, D2, bs, nb,
                                                  dtype):
    """The MLA kernels (q2 against the rope-key pool, the latent pool as key
    and value) against their plain version: head counts that are and are
    not multiples of the bf16 kernel's 64-head tiles and of the fp32 one's
    8- and 16-head tiles (B=20 x 128 heads fills the card with 16-head
    tiles), blocks of 4 to 64 positions (the fp32 kernel walks blocks of
    more than 32 in chunks), vector and scalar kv_limit,
    masks, and NaN in whole blocks past kv_limit leaking nothing."""
    dt = DTYPES[dtype]
    g = torch.Generator(device=cuda).manual_seed(G + D)
    n_blocks = B * nb + 3
    ckv = torch.randn(n_blocks, bs, 1, D, generator=g, device=cuda).to(dt)
    kr = torch.randn(n_blocks, bs, 1, D2, generator=g, device=cuda).to(dt)
    q = torch.randn(B, 1, G, D, generator=g, device=cuda).to(dt)
    q2 = torch.randn(B, 1, G, D2, generator=g, device=cuda).to(dt)
    tables = torch.randperm(n_blocks, generator=g, device=cuda)[:B * nb]
    tables = tables.reshape(B, nb).to(torch.int32).contiguous()
    lim = torch.randint(0, nb * bs, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    qpos = torch.clamp(lim - 2, min=0)
    sc = (D + D2) ** -0.5
    for lim_, kw in ((lim, dict(scale=sc)), (nb * bs // 2, dict(scale=sc)),
                     (lim, dict(q_pos=qpos, causal=True, window=5)),
                     (lim, dict(logit_softcap=8.0))):
        out = paged_decode_attention(q, ckv, ckv, tables, lim_, q2=q2,
                                     k2_pool=kr, **kw)
        want = paged_decode_attention_plain(q, ckv, ckv, tables, lim_, q2=q2,
                                            k2_pool=kr, **kw)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    lim1 = torch.full((B,), bs - 1, dtype=torch.int32, device=cuda)
    base = paged_decode_attention(q, ckv, ckv, tables, lim1, q2=q2,
                                  k2_pool=kr)
    past = tables[:, 1:].reshape(-1).long()
    ckv[past] = float("nan")
    kr[past] = float("nan")
    assert torch.equal(paged_decode_attention(q, ckv, ckv, tables, lim1,
                                              q2=q2, k2_pool=kr), base)
    with pytest.raises(ValueError, match="v_pool must be k_pool"):
        paged_decode_attention(q, ckv, ckv.clone(), tables, lim1, q2=q2,
                               k2_pool=kr)
    torch.cuda.synchronize()


def mla_inputs(dev, lims, nb, dtype, G=128, D=512, D2=64, bs=16, seed=0):
    """deepseek-v2's absorbed decode: one row per entry of ``lims`` over its
    own ``nb`` blocks of a shuffled pool."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lims)
    n_blocks = B * nb
    ckv = torch.randn(n_blocks, bs, 1, D, generator=g, device=dev).to(dtype)
    kr = torch.randn(n_blocks, bs, 1, D2, generator=g, device=dev).to(dtype)
    q = torch.randn(B, 1, G, D, generator=g, device=dev).to(dtype)
    q2 = torch.randn(B, 1, G, D2, generator=g, device=dev).to(dtype)
    tables = torch.randperm(n_blocks, generator=g, device=dev)
    tables = tables.reshape(B, nb).to(torch.int32).contiguous()
    lim = torch.tensor(lims, dtype=torch.int32, device=dev)
    return q, q2, ckv, kr, tables, lim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lims,nb", [([8191, 6143, -1], 512),
                                     ([2047] * 31 + [-1], 128)])
def test_paged_attention_mla_kernel_long_and_batched(cuda, lims, nb, dtype):
    """deepseek's shape at long context (tables of 512 blocks: many splits
    in bf16) and 32 rows of 2,047 (two splits): within TOL of plain, bitwise
    equal across two calls, a row at kv_limit -1 exact zeros, and NaN in
    the blocks past a short kv_limit, later splits' ranges among them,
    leaking nothing."""
    q, q2, ckv, kr, tables, lim = mla_inputs(cuda, lims, nb, DTYPES[dtype])
    kw = dict(scale=576 ** -0.5, q2=q2, k2_pool=kr)
    out = paged_decode_attention(q, ckv, ckv, tables, lim, **kw)
    want = paged_decode_attention_plain(q, ckv, ckv, tables, lim, **kw)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    assert torch.equal(paged_decode_attention(q, ckv, ckv, tables, lim, **kw),
                       out)
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    short = torch.clamp(lim, max=40)               # blocks 0-2
    base = paged_decode_attention(q, ckv, ckv, tables, short, **kw)
    past = tables[:, 3:].reshape(-1).long()
    ckv[past] = float("nan")
    kr[past] = float("nan")
    assert torch.equal(paged_decode_attention(q, ckv, ckv, tables, short,
                                              **kw), base)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("lims,nb,G,bs,D,D2", [
    ([100, 77], 8, 128, 16, 512, 64), ([8191, 6143], 512, 128, 16, 512, 64),
    ([2047] * 32, 128, 120, 16, 512, 64), ([300, -1, 5], 80, 20, 4, 512, 64),
    ([250, 90], 40, 64, 8, 512, 64),
    # ten 64-column groups: the kernel's 32-position tiles; bs 12 does not
    # divide them, and leaves rows of every tile unloaded
    ([200, 90, -1], 24, 20, 12, 488, 88), ([150, 40], 16, 72, 8, 8, 568),
    # the reduced deepseek's widths: groups zero-padded to nine
    ([60, 7], 10, 4, 8, 32, 8),
    # a pool block a tile: 64 positions, and 48 (16 rows of a tile unloaded)
    ([700, 100, -1], 12, 128, 64, 512, 64), ([300, 47], 8, 20, 48, 64, 8)])
def test_paged_attention_mla_kernel_matches_walk(cuda, lims, nb, G, bs, D,
                                                 D2):
    """The bf16 kernel against the plain model of its own walk (the card's
    SM count, the same split plan and tiles) within TOL; a row at kv_limit
    -1 is exact zeros."""
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_mla_walk)
    q, q2, ckv, kr, tables, lim = mla_inputs(cuda, lims, nb, torch.bfloat16,
                                             G=G, D=D, D2=D2, bs=bs,
                                             seed=G + bs)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    out = paged_decode_attention(q, ckv, ckv, tables, lim, scale=0.05, q2=q2,
                                 k2_pool=kr)
    want = paged_decode_attention_mla_walk(q, ckv, kr, tables, lim, q2=q2,
                                           scale=0.05, sms=sms)
    torch.testing.assert_close(out.float(), want.float(), **TOL["bfloat16"])
    for b, n in enumerate(lims):
        if n < 0:
            assert torch.equal(out[b], torch.zeros_like(out[b]))


@pytest.mark.gpu
def test_paged_attention_mla_no_host_sync(cuda):
    """The bf16 MLA call (its split plan from the shapes, partials from
    torch.empty, the kernel and the merge) runs under
    set_sync_debug_mode("error")."""
    q, q2, ckv, kr, tables, lim = mla_inputs(cuda, [8191, 6143], 512,
                                             torch.bfloat16)
    qpos = torch.clamp(lim - 1, min=0)
    kw = dict(scale=576 ** -0.5, q2=q2, k2_pool=kr, q_pos=qpos, causal=True,
              window=3000, logit_softcap=30.0)
    paged_decode_attention(q, ckv, ckv, tables, lim, **kw)     # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = paged_decode_attention(q, ckv, ckv, tables, lim, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = paged_decode_attention_plain(q, ckv, ckv, tables, lim, **kw)
    torch.testing.assert_close(out.float(), want.float(), **TOL["bfloat16"])


@pytest.mark.gpu
def test_paged_engine_serves_mla_through_the_mla_kernel(cuda):
    """Reduced deepseek-v2 on the paged engine: the MLA kernel runs once per
    layer per forward and the GQA one never; the MoE kernels once per MoE
    layer per forward; the contiguous engine runs neither attention
    kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params, n_moe_layers
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("deepseek-v2-236b"), layers=3)
    model = init_params(cfg, 0, param_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 20)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               .astype(np.int32) for n in (3, 5, 1)]
    for kv_block, policy in ((8, "dynamic"), (0, "fixed")):
        eng = ServeEngine(cfg, model, slots=2, capacity=48,
                          kv_block_size=kv_block, prefill_chunk=8,
                          rc=RunConfig(compute_dtype=torch.bfloat16,
                                       schedule_policy=policy))
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        ops.reset_launches()
        done = eng.run(reqs)
        assert len(done) == 3 and all(len(r.out) == 4 for r in done)
        launches = dict(ops.LAUNCHES)
        assert launches.pop("paged_attention") == 0
        assert launches.pop("paged_attention_mla") == \
            (cfg.n_layers * eng.n_forwards if kv_block else 0)
        assert all(launches.pop(k) == 0 for k in QUANT_KERNELS
                   + BACKWARD_KERNELS), ops.LAUNCHES
        expect = n_moe_layers(cfg) * eng.n_forwards
        assert all(n == expect for n in launches.values()), ops.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "dynamic", "capacity_factor"])
def test_moe_ffn_makes_no_host_sync(cuda, policy):
    T, E, k, d, f = 8, 64, 6, 256, 192
    logits, x, wg, wu, wd = layer(cuda, T, E, k, d, f, torch.bfloat16)
    router = torch.randn((d, E), device=cuda)
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                            executor="cuda", gating="sigmoid",
                            norm_topk=True, routed_scale=2.446,
                            schedule_policy=policy)
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
    eng = ServeEngine(cfg, model, slots=2, capacity=40, kv_block_size=0,
                      rc=RunConfig(compute_dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=4)
            for i, n in enumerate((5, 17, 3))]
    ops.reset_launches()
    done = eng.run(reqs)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    expect = n_moe_layers(cfg) * eng.n_forwards
    launches = dict(ops.LAUNCHES)
    assert launches.pop("paged_attention") == 0
    assert launches.pop("paged_attention_mla") == 0
    assert all(launches.pop(k) == 0 for k in QUANT_KERNELS
               + BACKWARD_KERNELS), ops.LAUNCHES
    assert all(n == expect for n in launches.values()), ops.LAUNCHES


@pytest.mark.gpu
def test_paged_engine_launches_attention_per_layer_forward(cuda):
    """The paged engine (dynamic, fused read): the paged-attention kernel
    runs once per layer per forward, the MoE kernels once per MoE layer per
    forward, and a shared prompt prefix hits the cache."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params, n_moe_layers
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    model = init_params(cfg, 0, param_dtype=torch.bfloat16)
    eng = ServeEngine(cfg, model, slots=2, capacity=48, kv_block_size=8,
                      prefill_chunk=8,
                      rc=RunConfig(compute_dtype=torch.bfloat16,
                                   schedule_policy="dynamic"))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 20)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               if i != 1 else rng.integers(0, cfg.vocab_size, 9)
               for i, n in enumerate((3, 0, 5))]
    reqs = [Request(rid=i, prompt=p.astype(np.int32), max_new=4)
            for i, p in enumerate(prompts)]
    ops.reset_launches()
    done = eng.run(reqs)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    launches = dict(ops.LAUNCHES)
    assert launches.pop("paged_attention") == cfg.n_layers * eng.n_forwards
    assert launches.pop("paged_attention_mla") == 0
    assert all(launches.pop(k) == 0 for k in QUANT_KERNELS
               + BACKWARD_KERNELS), ops.LAUNCHES
    expect = n_moe_layers(cfg) * eng.n_forwards
    assert all(n == expect for n in launches.values()), ops.LAUNCHES
    assert eng.kv.stats()["prefix_hit_tokens"] >= 16


def quantized_layer(dev, T, E, k, d, f, dtype, scheme, seed=0):
    from repro_torch.quantization import get_scheme
    logits, x, wg, wu, wd = layer(dev, T, E, k, d, f, dtype, seed=seed)
    sch = get_scheme(scheme)
    return logits, x, sch.quantize(wg), sch.quantize(wu), sch.quantize(wd)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scheme", ["int8_expert", "int8_channel",
                                    "int4_packed"])
def test_quantized_gemms_match_plain(cuda, scheme, dtype, policy):
    """The int8 and int4 formats of fused_gate_up and grouped_gemm (the
    folded combine rows too) against their plain versions; inactive rows
    exactly zero after NaN in the allocator; each format counts its own
    launches."""
    from repro_torch.kernels.grouped_gemm import launch_key
    T, E, k, d, f = 16, 64, 6, 256, 192
    logits, x, qg, qu, qd = quantized_layer(cuda, T, E, k, d, f,
                                            DTYPES[dtype], scheme, seed=3)
    w, idx = ref.router_ref(logits, k, gating="sigmoid", norm_topk=True,
                            routed_scale=2.446)
    build = build_fixed_schedule if policy == "fixed" \
        else build_dynamic_schedule
    sched = build(idx, E, 128)
    xp = ops.permute(x, sched)
    fmt = "int4" if scheme == "int4_packed" else "int8"
    ops.reset_launches()
    junk = torch.full((sched.capacity * d,), float("nan"), device=cuda)
    del junk
    h = ops.fused_gate_up(xp, qg, qu, sched)
    torch.testing.assert_close(
        h.float(), ref.fused_gate_up_ref(xp, qg, qu, sched).float(),
        **TOL[dtype])
    scale = combine_scale_rows(sched, w)
    y = ops.grouped_gemm(h, qd, sched, row_scale=scale)
    torch.testing.assert_close(
        y.float(), ref.grouped_gemm_ref(h, qd, sched, scale).float(),
        **TOL[dtype])
    dead = (sched.block_active == 0).repeat_interleave(sched.block_m)
    assert torch.equal(h[dead], torch.zeros_like(h[dead]))
    assert torch.equal(y[dead], torch.zeros_like(y[dead]))
    assert ops.LAUNCHES[launch_key("fused_gate_up", fmt)] == 1
    assert ops.LAUNCHES[launch_key("grouped_gemm", fmt)] == 1
    assert ops.LAUNCHES["fused_gate_up"] == ops.LAUNCHES["grouped_gemm"] == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("block_m", [8, 16, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scheme", ["int8_expert", "int8_channel",
                                    "int4_packed"])
def test_quantized_gemm_dequantizes_bitwise(cuda, scheme, dtype, block_m):
    """One-hot activation rows pick single weight rows: the product of a
    row with one 1.0 is exact, so the kernel's output must equal the plain
    dequantization bf16/fp32(q * s) bit for bit, in every tile height and
    over partial K stages (K = 176).  The schedule is built by hand on the
    schedules' contract (each expert's blocks one contiguous run from
    seg_start; the active blocks a prefix): experts of two blocks, of one,
    and of none, and an inactive block whose rows must be zeros."""
    from repro_torch.kernels.ops import _weight_operands
    from repro_torch.quantization import get_scheme
    E, K, N = 5, 176, 192
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((E, K, N), generator=g, device=cuda)
    w = (w * torch.logspace(-3, 2, N, device=cuda)).to(DTYPES[dtype])
    qt = get_scheme(scheme).quantize(w)
    runs = [0, 0, 1, 2, 2, 3]              # expert of each active block
    nb = len(runs) + 1                     # and one inactive block
    cap = nb * block_m
    be = torch.tensor(runs + [0], dtype=torch.int32, device=cuda)
    ba = torch.tensor([1] * len(runs) + [0], dtype=torch.int32, device=cuda)
    seg = torch.tensor([runs.index(e) if e in runs else len(runs)
                        for e in range(E)], dtype=torch.int32,
                       device=cuda) * block_m
    rows = torch.arange(cap, device=cuda)
    k_of_row = (rows * 37 + 5) % K
    x = torch.zeros((cap, K), dtype=DTYPES[dtype], device=cuda)
    x[rows, k_of_row] = 1.0
    wq, ws, fmt = _weight_operands(qt)
    out = ops._gg.grouped_gemm(x, wq, be, ba, block_m=block_m, w_scale=ws,
                               w_format=fmt, seg_start=seg)
    want = qt.materialize()[be.long()[rows // block_m], k_of_row]
    want[ba.repeat_interleave(block_m) == 0] = 0
    assert torch.equal(out, want)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_quantized_wrapper_refuses_mismatched_operands(cuda):
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    x = torch.zeros((16, 32), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((2, 32, 32), dtype=torch.int8, device=cuda)
    s = torch.ones((2, 32), device=cuda)
    be = torch.zeros(1, dtype=torch.int32, device=cuda)
    seg = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="w_scale"):
        grouped_gemm(x, q, be, be, block_m=16, w_format="int8")
    with pytest.raises(ValueError, match=r"\(E, 16, N\)"):
        grouped_gemm(x, q, be, be, block_m=16, w_scale=s, w_format="int4")
    out = grouped_gemm(x, q, be, be, block_m=16, w_scale=s, w_format="int8",
                       seg_start=seg)
    assert torch.equal(out, torch.zeros_like(out))      # inactive block
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["int8_expert", "int4_packed"])
def test_quantized_moe_ffn_makes_no_host_sync(cuda, scheme):
    from repro_torch.quantization import QuantTensor
    T, E, k, d, f = 8, 64, 6, 256, 192
    _, x, qg, qu, qd = quantized_layer(cuda, T, E, k, d, f, torch.bfloat16,
                                       scheme)
    assert isinstance(qg, QuantTensor)
    router = torch.randn((d, E), device=cuda)
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                            executor="cuda", gating="sigmoid",
                            norm_topk=True, routed_scale=2.446,
                            schedule_policy="dynamic")
    moe_ffn(x, router, qg, qu, qd, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe_ffn(x, router, qg, qu, qd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert y.shape == (T, d) and not torch.isnan(y).any()


@pytest.mark.gpu
def test_paged_engine_serves_int8_experts_through_int8_kernels(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params, n_moe_layers
    from repro_torch.quantization import routed_expert_bytes
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    model = init_params(cfg, 0, param_dtype=torch.bfloat16)
    dense = routed_expert_bytes(model)
    eng = ServeEngine(cfg, model, slots=2, capacity=48, kv_block_size=8,
                      prefill_chunk=8,
                      rc=RunConfig(compute_dtype=torch.bfloat16,
                                   schedule_policy="dynamic",
                                   quant="int8_expert"))
    assert eng.quant_expert_bytes < dense * 0.51
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=4) for i, n in enumerate(
                        (9, 20, 5))]
    ops.reset_launches()
    done = eng.run(reqs)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    expect = n_moe_layers(cfg) * eng.n_forwards
    launches = dict(ops.LAUNCHES)
    assert launches.pop("paged_attention") == cfg.n_layers * eng.n_forwards
    for name in ("fused_gate_up_int8", "grouped_gemm_int8", "router_topk",
                 "permute", "unpermute"):
        assert launches.pop(name) == expect, (name, ops.LAUNCHES)
    assert all(n == 0 for n in launches.values()), ops.LAUNCHES


# ---------------------------------------------------------------- backward
def routed_pair(dev, T, E, k, d, f, dtype, policy, experts=None, seed=0):
    """A schedule of T tokens (routed to ``experts`` only, when given) and
    x, dy in its padded layout."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((T, E), generator=g, device=dev)
    if experts is not None:
        keep = torch.zeros(E, dtype=torch.bool, device=dev)
        keep[list(experts)] = True
        logits = torch.where(keep, logits, torch.full_like(logits, -1e4))
    _, idx = ref.router_ref(logits, k)
    sched = (build_fixed_schedule(idx, E, 128) if policy == "fixed"
             else build_dynamic_schedule(idx, E, 128))
    x = ops.permute(torch.randn((T, d), generator=g, device=dev).to(dtype),
                    sched)
    dy = ops.permute(torch.randn((T, f), generator=g, device=dev).to(dtype),
                     sched)
    return sched, x, dy


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,E,k,d,f,experts", [
    (512, 8, 2, 128, 192, None),
    (64, 16, 4, 80, 48, None),          # K and N not multiples of 64
    (96, 16, 2, 128, 64, (0, 3, 7, 15))])   # 12 experts with no tokens
def test_grouped_wgrad_kernel_matches_plain(cuda, T, E, k, d, f, experts,
                                            dtype, policy):
    """B7 against its plain version: fp32 output, both sides sum exact
    products in fp32 (1e-4); every element written (the allocator is
    poisoned with NaN first); exact zeros for experts with no tokens."""
    sched, x, dy = routed_pair(cuda, T, E, k, d, f, DTYPES[dtype], policy,
                               experts)
    junk = torch.full((E * d * f,), float("nan"), device=cuda)
    del junk
    ops.reset_launches()
    dw = ops.grouped_wgrad(x, dy, sched, E)
    assert ops.LAUNCHES["grouped_wgrad"] == 1
    want = ref.grouped_wgrad_ref(x, dy, sched, E)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32 and dw.shape == (E, d, f)
    assert not torch.isnan(dw).any()
    torch.testing.assert_close(dw, want, rtol=1e-4, atol=1e-4)
    empty = sched.counts == 0
    assert torch.equal(dw[empty], torch.zeros_like(dw[empty]))
    if experts is not None:
        assert int(empty.sum()) == E - len(experts)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,E,k,d,f", [(512, 8, 2, 128, 192),
                                       (64, 16, 4, 80, 48)])
def test_grouped_gemm_t_kernel_matches_plain(cuda, T, E, k, d, f, dtype,
                                             policy):
    """B1 with its weight read transposed: dy (capacity, f) against the
    forward's (E, d, f) stack -> (capacity, d); zeros on inactive blocks."""
    sched, _, dy = routed_pair(cuda, T, E, k, d, f, DTYPES[dtype], policy)
    w = (torch.randn((E, d, f), device=cuda) * f ** -0.5).to(DTYPES[dtype])
    ops.reset_launches()
    out = ops.grouped_gemm_t(dy, w, sched)
    assert ops.LAUNCHES["grouped_gemm_t"] == 1
    want = ref.grouped_gemm_t_ref(dy, w, sched)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    dead = (sched.block_active == 0).repeat_interleave(sched.block_m)
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


# the backward's Hopper kernels (wgmma + TMA over per-expert work lists) at
# shapes that stress their tiling: K and N multiples of 16 but not of 64,
# experts with no rows and with one, block_m 8, 16 and 128 (runs ending
# inside a 64-row stage), the dynamic policy's 8-row blocks
COUNTS = (1, 0, 37, 130, 0, 9, 300, 64)    # tokens per expert (E = 8)
# capacity_factor at 1.25: buckets of 88 (block_m 8) or 128 rows, so the
# experts of 130 and 300 tokens drop some, those of 0 leave empty buckets,
# and every bucket but a full one has an inactive tail
TILE_SHAPES = [("fixed", 8), ("fixed", 16), ("fixed", 128), ("dynamic", 128),
               ("capacity_factor", 8), ("capacity_factor", 128)]


def counted_pair(dev, K, N, dtype, policy, M, seed=0):
    """A top-1 schedule giving expert e COUNTS[e] tokens (in shuffled
    order), and x (capacity, K), dy (capacity, N) in its padded layout."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(np.repeat(np.arange(len(COUNTS)), COUNTS))
    idx = torch.as_tensor(idx[:, None].astype(np.int32), device=dev)
    E = len(COUNTS)
    sched = {"fixed": lambda: build_fixed_schedule(idx, E, M),
             "dynamic": lambda: build_dynamic_schedule(idx, E, M),
             "capacity_factor": lambda: build_capacity_schedule(
                 idx, E, M, capacity_factor=1.25)}[policy]()
    g = torch.Generator(device=dev).manual_seed(seed)
    T = idx.shape[0]
    x = ops.permute(torch.randn((T, K), generator=g, device=dev).to(dtype),
                    sched)
    dy = ops.permute(torch.randn((T, N), generator=g, device=dev).to(dtype),
                     sched)
    return sched, x, dy


@pytest.mark.gpu
@pytest.mark.parametrize("policy,M", TILE_SHAPES)
def test_expert_tiles_kernel_matches_plain(cuda, policy, M):
    from repro_torch.kernels.expert_tiles import expert_tiles, expert_tiles_plain
    sched, _, _ = counted_pair(cuda, 16, 16, torch.float32, policy, M)
    args = (sched.seg_start, sched.block_expert, sched.block_active)
    kw = dict(block_m=sched.block_m, capacity=sched.capacity)
    runs, tiles = expert_tiles(*args, **kw)
    runs_p, tiles_p = expert_tiles_plain(*(a.cpu() for a in args), **kw)
    assert torch.equal(runs.cpu(), runs_p) and torch.equal(tiles.cpu(),
                                                           tiles_p)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", sorted(DTYPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("policy,M", TILE_SHAPES)
def test_grouped_wgrad_tiling_matches_plain(cuda, policy, M, dtype,
                                            out_dtype):
    """B7 at K=176, N=192: within 1e-4 (fp32 output) or the bf16
    tolerance (bf16 output, both sides round the fp32 sum once); every
    element written (NaN-poisoned allocator); exact zeros for the experts
    with no rows; bitwise equal across two calls."""
    K, N, E = 176, 192, len(COUNTS)
    odt = DTYPES[out_dtype]
    sched, x, dy = counted_pair(cuda, K, N, DTYPES[dtype], policy, M)
    junk = torch.full((E * K * N,), float("nan"), device=cuda, dtype=odt)
    del junk
    ops.reset_launches()
    dw = ops.grouped_wgrad(x, dy, sched, E, out_dtype=odt)
    again = ops.grouped_wgrad(x, dy, sched, E, out_dtype=odt)
    assert ops.LAUNCHES["grouped_wgrad"] == 2
    want = ref.grouped_wgrad_ref(x, dy, sched, E, out_dtype=odt)
    torch.cuda.synchronize()
    assert dw.dtype == odt and dw.shape == (E, K, N)
    assert not torch.isnan(dw).any()
    assert torch.equal(dw, again)
    tol = dict(rtol=1e-4, atol=1e-4) if odt == torch.float32 \
        else TOL["bfloat16"]
    torch.testing.assert_close(dw.float(), want.float(), **tol)
    empty = torch.as_tensor([c == 0 for c in COUNTS], device=cuda)
    assert torch.equal(dw[empty], torch.zeros_like(dw[empty]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("policy,M", TILE_SHAPES)
def test_grouped_gemm_t_tiling_matches_plain(cuda, policy, M, dtype):
    """B1^T at K=176 (the reduction), N=192: within TOL, every element
    written (NaN-poisoned allocator), zeros on inactive rows, bitwise equal
    across two calls."""
    K, N, E = 176, 192, len(COUNTS)
    sched, dy, _ = counted_pair(cuda, K, N, DTYPES[dtype], policy, M)
    w = (torch.randn((E, N, K), device=cuda) * K ** -0.5).to(DTYPES[dtype])
    junk = torch.full((sched.capacity * N,), float("nan"), device=cuda,
                      dtype=DTYPES[dtype])
    del junk
    out = ops.grouped_gemm_t(dy, w, sched)
    again = ops.grouped_gemm_t(dy, w, sched)
    want = ref.grouped_gemm_t_ref(dy, w, sched)
    torch.cuda.synchronize()
    assert out.shape == (sched.capacity, N) and not torch.isnan(out).any()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    dead = (sched.block_active == 0).repeat_interleave(sched.block_m)
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.gpu
def test_backward_kernels_refuse_misaligned_views(cuda):
    """TMA takes 16-byte-aligned tensors: a view that starts one element
    into its buffer is refused by the wrappers, not launched."""
    from repro_torch.kernels.grouped_gemm import grouped_gemm_t
    from repro_torch.kernels.grouped_wgrad import grouped_wgrad
    K, N, E = 176, 192, len(COUNTS)
    sched, x, dy = counted_pair(cuda, K, N, torch.bfloat16, "fixed", 128)
    cap = sched.capacity
    buf = torch.zeros(cap * K + 8, dtype=torch.bfloat16, device=cuda)
    bad = buf[1:1 + cap * K].view(cap, K)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    arrays = (sched.seg_start, sched.block_expert, sched.block_active)
    with pytest.raises(ValueError, match="16-byte"):
        grouped_wgrad(bad, dy, *arrays, block_m=sched.block_m, n_experts=E)
    w = torch.zeros((E, N, K), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        grouped_gemm_t(bad, w, *arrays, block_m=sched.block_m)


# the forward's Hopper kernels (B1 and B2 in bf16 on dense weights, over
# the same work lists), at the tiling stresses of the backward's; fp32 runs
# the block-tiled kernels on the same inputs
def forward_pair(dev, K, N, dtype, policy, M, seed=0):
    """counted_pair's schedule and x, the stacks W, Wg, Wu (E, K, N), and a
    distinct row_scale per row (a wrong row map shows)."""
    sched, x, _ = counted_pair(dev, K, N, dtype, policy, M, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    E = len(COUNTS)
    w, wg, wu = ((torch.randn((E, K, N), generator=g, device=dev)
                  * K ** -0.5).to(dtype) for _ in range(3))
    rs = torch.linspace(0.25, 2.0, sched.capacity, device=dev)
    rs = rs[torch.randperm(sched.capacity, generator=g, device=dev)]
    return sched, x, w, wg, wu, rs


@pytest.mark.gpu
def test_forward_gemms_one_item_match_plain(cuda):
    """One expert whose run is one 64-row slice, N = 128: B1 is one work
    item (and a zero tile), the MN-major weight read and the row_scale
    epilogue held against the plain versions before anything else."""
    T, K, N = 64, 64, 128
    idx = torch.zeros((T, 1), dtype=torch.int32, device=cuda)
    sched = build_fixed_schedule(idx, 1, 64)
    g = torch.Generator(device=cuda).manual_seed(7)
    x = ops.permute(torch.randn((T, K), generator=g, device=cuda)
                    .to(torch.bfloat16), sched)
    w, wu = ((torch.randn((1, K, N), generator=g, device=cuda) * 0.125)
             .to(torch.bfloat16) for _ in range(2))
    rs = torch.linspace(0.5, 1.5, sched.capacity, device=cuda)
    y = ops.grouped_gemm(x, w, sched, row_scale=rs)
    h = ops.fused_gate_up(x, w, wu, sched)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y.float(), ref.grouped_gemm_ref(x, w, sched, rs).float(),
        **TOL["bfloat16"])
    torch.testing.assert_close(
        h.float(), ref.fused_gate_up_ref(x, w, wu, sched).float(),
        **TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("policy,M", TILE_SHAPES)
def test_forward_gemms_tiling_match_plain(cuda, policy, M, dtype):
    """B1 (with a distinct row_scale per row) and B2 at K=176, N=192,
    experts with 0 and 1 rows: within TOL, every element written
    (NaN-poisoned allocator), exact zeros on the rows past the active
    blocks, bitwise equal across two calls, one launch counted each."""
    K, N = 176, 192
    sched, x, w, wg, wu, rs = forward_pair(cuda, K, N, DTYPES[dtype],
                                           policy, M)
    dead = (sched.block_active == 0).repeat_interleave(sched.block_m)
    for name, kern, plain in (
            ("grouped_gemm",
             lambda: ops.grouped_gemm(x, w, sched, row_scale=rs),
             lambda: ref.grouped_gemm_ref(x, w, sched, rs)),
            ("fused_gate_up", lambda: ops.fused_gate_up(x, wg, wu, sched),
             lambda: ref.fused_gate_up_ref(x, wg, wu, sched))):
        junk = torch.full((sched.capacity * N,), float("nan"), device=cuda,
                          dtype=DTYPES[dtype])
        del junk
        ops.reset_launches()
        out = kern()
        again = kern()
        assert ops.LAUNCHES[name] == 2
        want = plain()
        torch.cuda.synchronize()
        assert out.shape == (sched.capacity, N)
        assert not torch.isnan(out).any(), name
        assert torch.equal(out, again), name
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
        assert torch.equal(out[dead], torch.zeros_like(out[dead])), name


@pytest.mark.gpu
def test_forward_gemms_refuse_missing_seg_start_and_misaligned_views(cuda):
    """In bf16 on dense weights the kernels walk each expert's run from
    seg_start: a call without it is refused, never sent another route;
    so is a view off a 16-byte boundary (TMA)."""
    K, N = 176, 192
    sched, x, w, wg, wu, _ = forward_pair(cuda, K, N, torch.bfloat16,
                                          "fixed", 128)
    arrays = (sched.block_expert, sched.block_active)
    kw = dict(block_m=sched.block_m)
    with pytest.raises(ValueError, match="seg_start"):
        ops._gg.grouped_gemm(x, w, *arrays, **kw)
    with pytest.raises(ValueError, match="seg_start"):
        ops._fgu.fused_gate_up(x, wg, wu, *arrays, **kw)
    cap = sched.capacity
    buf = torch.zeros(cap * K + 8, dtype=torch.bfloat16, device=cuda)
    bad = buf[1:1 + cap * K].view(cap, K)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        ops._gg.grouped_gemm(bad, w, *arrays, seg_start=sched.seg_start, **kw)
    with pytest.raises(ValueError, match="16-byte"):
        ops._fgu.fused_gate_up(bad, wg, wu, *arrays,
                               seg_start=sched.seg_start, **kw)


# the forward's Hopper kernels on int8/int4 weights (the same work lists,
# the payload expanded on chip), at the tiling stresses above
QUANT_SCHEMES = ["int8_expert", "int8_channel", "int4_packed"]


def quantized_pair(dev, K, N, dtype, policy, M, scheme, seed=0):
    """forward_pair's inputs with the stacks quantized under ``scheme``:
    (schedule, x, row_scale, [(kernel name, kernel call, plain call)])."""
    from repro_torch.quantization import get_scheme
    sched, x, w, wg, wu, rs = forward_pair(dev, K, N, dtype, policy, M,
                                           seed=seed)
    q, qg, qu = (get_scheme(scheme).quantize(t) for t in (w, wg, wu))
    return sched, x, rs, [
        ("grouped_gemm", lambda: ops.grouped_gemm(x, q, sched, row_scale=rs),
         lambda: ref.grouped_gemm_ref(x, q, sched, rs)),
        ("fused_gate_up", lambda: ops.fused_gate_up(x, qg, qu, sched),
         lambda: ref.fused_gate_up_ref(x, qg, qu, sched))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("policy,M", TILE_SHAPES)
@pytest.mark.parametrize("scheme", QUANT_SCHEMES)
def test_quantized_gemms_tiling_match_plain(cuda, scheme, policy, M, dtype):
    """B1 (a distinct row_scale per row) and B2 on int8/int4 weights at
    K=176 (a partial K stage), N=192, experts with 0 and 1 rows and runs of
    up to 300 (passes of 128 rows): within TOL, every element written
    (NaN-poisoned allocator), exact zeros on the rows past the active
    blocks, bitwise equal across two calls, one launch counted each."""
    from repro_torch.kernels.grouped_gemm import launch_key
    from repro_torch.quantization import get_scheme
    K, N = 176, 192
    fmt = get_scheme(scheme).kernel_format
    sched, x, _, calls = quantized_pair(cuda, K, N, DTYPES[dtype], policy, M,
                                        scheme)
    dead = (sched.block_active == 0).repeat_interleave(sched.block_m)
    for name, kern, plain in calls:
        junk = torch.full((sched.capacity * N,), float("nan"), device=cuda,
                          dtype=DTYPES[dtype])
        del junk
        ops.reset_launches()
        out = kern()
        again = kern()
        assert ops.LAUNCHES[launch_key(name, fmt)] == 2
        want = plain()
        torch.cuda.synchronize()
        assert out.shape == (sched.capacity, N)
        assert not torch.isnan(out).any(), name
        assert torch.equal(out, again), name
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
        assert torch.equal(out[dead], torch.zeros_like(out[dead])), name


@pytest.mark.gpu
@pytest.mark.parametrize("policy,M", TILE_SHAPES)
@pytest.mark.parametrize("scheme", ["none", "int8_channel", "int4_packed"])
def test_every_tile_shape_is_bitwise_the_default(cuda, scheme, policy, M):
    """Every tile shape B1 (a distinct row_scale per row) and B2 take in
    bf16 (``TILE_SHAPES`` of grouped_gemm.py), at K=176, N=192 and runs of
    0-300 rows (slices of 128 and 256 rows, zero tiles): bitwise the
    default shape's output, since no shape splits K; within TOL of the
    plain version; every element written (NaN-poisoned allocator); the
    work lists at 128 rows equal to the plain version's; a shape outside
    the set raises."""
    from repro_torch.kernels import expert_tiles as et
    from repro_torch.kernels.grouped_gemm import TILE_SHAPES as SHAPES
    from repro_torch.quantization import get_scheme
    K, N = 176, 192
    sched, x, w, wg, wu, rs = forward_pair(cuda, K, N, torch.bfloat16,
                                           policy, M)
    if scheme != "none":
        w, wg, wu = (get_scheme(scheme).quantize(t) for t in (w, wg, wu))
    (q, s, fmt), (qg, sg, _), (qu, su, _) = (
        ops._weight_operands(t) for t in (w, wg, wu))
    arrays = (sched.block_expert, sched.block_active)
    kw = dict(block_m=sched.block_m, seg_start=sched.seg_start,
              w_format=fmt)
    calls = {
        "grouped_gemm": (
            lambda tile: ops._gg.grouped_gemm(
                x, q, *arrays, row_scale=rs, w_scale=s, tile_rows=tile[0],
                block_n=tile[1], **kw),
            lambda: ref.grouped_gemm_ref(x, w, sched, rs)),
        "fused_gate_up": (
            lambda tile: ops._fgu.fused_gate_up(
                x, qg, qu, *arrays, wg_scale=sg, wu_scale=su,
                tile_rows=tile[0], block_n=tile[1], **kw),
            lambda: ref.fused_gate_up_ref(x, wg, wu, sched))}
    for name, (kern, plain) in calls.items():
        shapes = SHAPES[name, fmt]
        want = plain()
        outs = []
        for tile in shapes:
            junk = torch.full((sched.capacity * N,), float("nan"),
                              device=cuda, dtype=torch.bfloat16)
            del junk
            outs.append(kern(tile))
        torch.cuda.synchronize()
        for tile, out in zip(shapes, outs):
            assert not torch.isnan(out).any(), (name, tile)
            assert torch.equal(out, outs[0]), (name, tile)
            torch.testing.assert_close(out.float(), want.float(),
                                       **TOL["bfloat16"])
        with pytest.raises(ValueError, match="tile shapes"):
            kern((64, 128))
    args = (sched.seg_start, sched.block_expert, sched.block_active)
    lkw = dict(block_m=sched.block_m, capacity=sched.capacity, tile_rows=128)
    runs, tiles = et.expert_tiles(*args, **lkw)
    runs_p, tiles_p = et.expert_tiles_plain(*(a.cpu() for a in args), **lkw)
    assert torch.equal(runs.cpu(), runs_p)
    assert torch.equal(tiles.cpu(), tiles_p)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "dynamic"])
def test_autotuned_moe_ffn_runs_the_cached_tile(cuda, policy, tmp_path,
                                                monkeypatch):
    """``autotune=True`` with a cache that names a non-default tile for
    this call's keys: the same output bitwise as the default tiles, one
    launch of each kernel, every lookup a hit, no host sync."""
    from repro_torch import tuning
    T, E, k, d, f = 64, 16, 4, 256, 192
    logits, x, wg, wu, wd = layer(cuda, T, E, k, d, f, torch.bfloat16)
    router = torch.randn((d, E), device=cuda)
    c = tuning.TuneCache(device="test")
    key = dict(M=T * k, E=E, dtype="bfloat16")
    c.put(tuning.make_key("fused_gate_up", K=d, N=f, **key), block_m=128,
          block_n=128, block_k=64)
    c.put(tuning.make_key("grouped_gemm", K=f, N=d, **key), block_m=128,
          block_n=256, block_k=64)
    c.save(tmp_path / "cache.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "cache.json"))
    tuning.reset_cache()
    try:
        cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                                schedule_policy=policy)
        y0, _ = moe_ffn(x, router, wg, wu, wd, cfg)
        moe_ffn(x, router, wg, wu, wd, cfg._replace(autotune=True))
        torch.cuda.synchronize()
        tuning.reset_stats()
        ops.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y1, _ = moe_ffn(x, router, wg, wu, wd,
                            cfg._replace(autotune=True))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.equal(y0, y1)
        assert ops.LAUNCHES["fused_gate_up"] == 1
        assert ops.LAUNCHES["grouped_gemm"] == 1
        # the two GEMMs, and the dynamic floor's sub_block key (a miss)
        assert tuning.STATS["hits"] == 2
        assert tuning.STATS["lookups"] == (3 if policy == "dynamic" else 2)
    finally:
        tuning.reset_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["int8_expert", "int4_packed"])
@pytest.mark.parametrize("T", [2, 64])
def test_quantized_gemms_160_experts_match_plain(cuda, T, scheme):
    """deepseek-v2's expert count (E=160, k=6, softmax) at narrow widths on
    the dynamic policy's 8-row blocks: within TOL, dead rows exact zeros
    after NaN poisoning, bitwise equal across two calls."""
    E, k, d, f = 160, 6, 256, 192
    logits, x, qg, qu, qd = quantized_layer(cuda, T, E, k, d, f,
                                            torch.bfloat16, scheme, seed=T)
    w, idx = ref.router_ref(logits, k, gating="softmax", norm_topk=False,
                            routed_scale=16.0)
    sched = build_dynamic_schedule(idx, E, 128)
    xp = ops.permute(x, sched)
    h = ref.fused_gate_up_ref(xp, qg, qu, sched)
    scale = combine_scale_rows(sched, w)
    dead = (sched.block_active == 0).repeat_interleave(sched.block_m)
    for kern, plain, n in (
            (lambda: ops.fused_gate_up(xp, qg, qu, sched),
             lambda: ref.fused_gate_up_ref(xp, qg, qu, sched), f),
            (lambda: ops.grouped_gemm(h, qd, sched, row_scale=scale),
             lambda: ref.grouped_gemm_ref(h, qd, sched, scale), d)):
        junk = torch.full((sched.capacity * n,), float("nan"), device=cuda,
                          dtype=torch.bfloat16)
        del junk
        out = kern()
        again = kern()
        want = plain()
        torch.cuda.synchronize()
        assert not torch.isnan(out).any()
        assert torch.equal(out, again)
        torch.testing.assert_close(out.float(), want.float(),
                                   **TOL["bfloat16"])
        assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int4_with_channel_scales_matches_plain(cuda, dtype):
    """int4 payloads with one scale per (expert, column), which no scheme
    makes but the wrappers take: the kernel's column scales on int4,
    against the plain versions, on the dynamic policy."""
    from repro_torch.kernels.ops import _weight_operands
    from repro_torch.quantization import get_scheme
    K, N = 176, 192
    sched, x, w, wg, wu, rs = forward_pair(cuda, K, N, DTYPES[dtype],
                                           "dynamic", 128)
    g = torch.Generator(device=cuda).manual_seed(11)
    (q, _, fmt), (qg, _, _), (qu, _, _) = (
        _weight_operands(get_scheme("int4_packed").quantize(t))
        for t in (w, wg, wu))
    s, sg, su = (torch.rand((len(COUNTS), N), generator=g, device=cuda)
                 * 0.1 + 0.01 for _ in range(3))
    arrays = (sched.block_expert, sched.block_active)
    kw = dict(block_m=sched.block_m, w_format=fmt)
    y = ops._gg.grouped_gemm(x, q, *arrays, w_scale=s, row_scale=rs,
                             seg_start=sched.seg_start, **kw)
    h = ops._fgu.fused_gate_up(x, qg, qu, *arrays, wg_scale=sg, wu_scale=su,
                               seg_start=sched.seg_start, **kw)
    y_p = ops._gg.grouped_gemm_plain(x, q, *arrays, w_scale=s, row_scale=rs,
                                     **kw)
    h_p = ops._fgu.fused_gate_up_plain(x, qg, qu, *arrays, wg_scale=sg,
                                       wu_scale=su, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_p.float(), **TOL[dtype])
    torch.testing.assert_close(h.float(), h_p.float(), **TOL[dtype])


@pytest.mark.gpu
def test_quantized_gemms_refuse_missing_seg_start_and_misaligned_views(cuda):
    """In bf16 on int8/int4 weights the kernels walk each expert's run
    from seg_start: a call without it is refused, never sent another
    route; so is a payload view off a 16-byte boundary (TMA)."""
    from repro_torch.kernels.ops import _weight_operands
    from repro_torch.quantization import get_scheme
    K, N = 176, 192
    sched, x, w, wg, wu, _ = forward_pair(cuda, K, N, torch.bfloat16,
                                          "fixed", 128)
    arrays = (sched.block_expert, sched.block_active)
    for scheme in ("int8_channel", "int4_packed"):
        sch = get_scheme(scheme)
        (q, s, fmt), (qg, sg, _), (qu, su, _) = (
            _weight_operands(sch.quantize(t)) for t in (w, wg, wu))
        kw = dict(block_m=sched.block_m, w_format=fmt)
        with pytest.raises(ValueError, match="seg_start"):
            ops._gg.grouped_gemm(x, q, *arrays, w_scale=s, **kw)
        with pytest.raises(ValueError, match="seg_start"):
            ops._fgu.fused_gate_up(x, qg, qu, *arrays, wg_scale=sg,
                                   wu_scale=su, **kw)
        buf = torch.zeros(q.numel() + 16, dtype=torch.int8, device=cuda)
        bad = buf[1:1 + q.numel()].view(q.shape)
        assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
        with pytest.raises(ValueError, match="16-byte"):
            ops._gg.grouped_gemm(x, bad, *arrays, w_scale=s,
                                 seg_start=sched.seg_start, **kw)
        with pytest.raises(ValueError, match="16-byte"):
            ops._fgu.fused_gate_up(x, bad, qu, *arrays, wg_scale=sg,
                                   wu_scale=su, seg_start=sched.seg_start,
                                   **kw)


def plain_moe(x, router, wg, wu, wd, cfg):
    """The MoE layer composed of the kernels' plain versions, for autograd
    to differentiate (torch's own backward of each plain op)."""
    from repro_torch.execution import plan_schedule, router_aux_losses
    logits = torch.matmul(x.float(), router.float())
    w, idx = ref.router_ref(logits, cfg.top_k, gating=cfg.gating,
                            norm_topk=cfg.norm_topk,
                            routed_scale=cfg.routed_scale)
    sched = plan_schedule(idx, cfg)
    xp = ref.permute_ref(x, sched)
    h = ref.fused_gate_up_ref(xp, wg, wu, sched)
    y = ref.grouped_gemm_ref(h, wd, sched, combine_scale_rows(sched, w))
    return ref.unpermute_ref(y, sched, None), router_aux_losses(logits, idx,
                                                                cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("policy", ["fixed", "dynamic", "capacity_factor"])
def test_moe_backward_on_kernels_matches_autograd_through_plain(cuda, policy,
                                                                fuse):
    """fp32 (1e-4): the layer's gradients with respect to x, the router and
    the three stacks, on the kernels (B7 three times, B1^T three times)
    against autograd through the plain versions."""
    T, E, k, d, f = 96, 16, 4, 128, 96
    _, x, wg, wu, wd = layer(cuda, T, E, k, d, f, torch.float32, seed=3)
    router = torch.randn((d, E), device=cuda) * d ** -0.5
    proj = torch.randn((T, d), device=cuda)
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                            executor="cuda", gating="sigmoid",
                            norm_topk=True, routed_scale=2.446,
                            fuse_gate_up=fuse, schedule_policy=policy,
                            capacity_factor=1.25)
    grads = []
    for fn in (moe_ffn, plain_moe):
        args = [t.clone().requires_grad_(True)
                for t in (x, router, wg, wu, wd)]
        ops.reset_launches()
        y, aux = fn(*args, cfg)
        loss = ((y * proj).sum() + 0.01 * aux["lb_loss"]
                + 1e-4 * aux["router_z"])
        loss.backward()
        grads.append([a.grad for a in args])
        if fn is moe_ffn:
            assert ops.LAUNCHES["grouped_wgrad"] == 3
            assert ops.LAUNCHES["grouped_gemm_t"] == 3
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "dynamic", "capacity_factor"])
def test_moe_backward_makes_no_host_sync(cuda, policy):
    T, E, k, d, f = 64, 64, 6, 256, 192
    _, x, wg, wu, wd = layer(cuda, T, E, k, d, f, torch.bfloat16)
    args = [t.requires_grad_(True) for t in
            (x, torch.randn((d, E), device=cuda), wg, wu, wd)]
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                            executor="cuda", gating="sigmoid",
                            norm_topk=True, routed_scale=2.446,
                            schedule_policy=policy)
    y, _ = moe_ffn(*args, cfg)
    y.float().sum().backward()                 # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_ffn(*args, cfg)
        (y.float().sum() + aux["lb_loss"]).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(a.grad).all() for a in args)


def router_logits(dev, T: int, E: int, k: int, seed: int):
    """(T, E) fp32 logits: after a random row, an all-equal row, a row
    whose k-th place is a tie of three, -inf on every third expert, -inf
    all but a quarter of the experts (tied at 1.0), coarse values with many
    ties, a row ordered by (e % 32, e // 32), which gives the ranking its
    most candidates; random rows after that."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((max(T, 8), E), generator=g)
    x[1] = 0.25
    top = torch.randperm(E, generator=g)
    x[2] = torch.randn(E, generator=g) * 0.1 - 5.0
    x[2, top[:k - 1]] = 3.0 + torch.arange(k - 1, dtype=torch.float32)
    x[2, top[k - 1:k + 2]] = 2.0
    x[3, 1::3] = float("-inf")
    x[4] = float("-inf")
    x[4, top[:max(1, E // 4)]] = 1.0
    x[5] = torch.round(x[5] * 2) / 2
    e = torch.arange(E)
    x[6] = 3.0 - 0.1 * (e % 32) - 0.001 * (e // 32)
    return x[:T].contiguous().to(dev)


ROUTE_KW = ({"gating": "softmax", "norm_topk": False, "routed_scale": 16.0},
            {"gating": "sigmoid", "norm_topk": True, "routed_scale": 2.446},
            {"gating": "softmax", "norm_topk": True, "routed_scale": 1.0})


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 3, 64, 4096])
@pytest.mark.parametrize("E", [8, 64, 160, 256])
def test_router_topk_kernel_matches_plain(cuda, E, T):
    """Every k the wrapper takes (1 to min(E, 16)), softmax and sigmoid,
    with renorm and scale: indices equal to the plain version's, weights
    within 1e-5 / 1e-6, and two calls bitwise equal."""
    for k in range(1, min(E, 16) + 1):
        logits = router_logits(cuda, T, E, k, seed=E * 100 + k)
        for kw in ROUTE_KW:
            w, idx = ops.router_topk(logits, top_k=k, **kw)
            w_p, idx_p = ref.router_ref(logits, k, **kw)
            assert torch.equal(idx, idx_p), (k, kw)
            torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-6)
            w2, idx2 = ops.router_topk(logits, top_k=k, **kw)
            assert torch.equal(w, w2) and torch.equal(idx, idx2)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [2048, 4096, 5120, 7168])
def test_unpermute_kernel_bitwise_plain(cuda, d, dtype):
    """Weighted and folded, from one token to training's 4096: bitwise
    equal to the plain version; NaN in the rows of y that pos never names
    changes nothing."""
    dt = DTYPES[dtype]
    g = torch.Generator(device=cuda).manual_seed(d)
    for T in (1, 2, 64, 4096):
        for k in (1, 2, 6, 8):
            cap = T * k + 64
            y = torch.randn((cap, d), generator=g, device=cuda).to(dt)
            perm = torch.randperm(cap, generator=g, device=cuda)
            pos = perm[:T * k].reshape(T, k).to(torch.int32).contiguous()
            y[perm[T * k:]] = float("nan")
            w = torch.rand((T, k), generator=g, device=cuda)
            for weights in (None, w):
                got = ops._unperm.unpermute(y, pos, weights)
                want = ops._unperm.unpermute_plain(y, pos, weights)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (T, k, weights is None)
                assert torch.equal(got, ops._unperm.unpermute(y, pos,
                                                              weights))
            del y, perm, pos, w
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_unpermute_refuses_a_misaligned_view(cuda):
    buf = torch.zeros(64 * 16 + 8, dtype=torch.bfloat16, device=cuda)
    y = buf[1:1 + 64 * 16].view(64, 16)            # 2 bytes past 16
    pos = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        ops._unperm.unpermute(y, pos, None)
    ok = buf[8:8 + 64 * 16].view(64, 16)            # 16 bytes in
    assert torch.equal(ops._unperm.unpermute(ok, pos, None),
                       ops._unperm.unpermute_plain(ok, pos, None))


@pytest.mark.gpu
def test_launch_floor_kernel_launches(cuda):
    from repro_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    _build.launch_floor(cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_engine_with_64_position_blocks_reads_by_the_mla_kernel(cuda,
                                                                    dtype):
    """A reduced deepseek-v2 engine with 64-position KV blocks: under
    ``auto`` it reads the pool with the MLA kernel, once per layer per
    forward.  In fp32 it serves the gather read's greedy tokens.  In bf16
    the tensor-core kernel sums in another order than the gather's einsum,
    and on this random model the greedy tokens of 16-position blocks
    already part from the gather's within a few steps; there the
    64-position engine must serve the 16-position engine's tokens (the
    kernel itself is held against the plain version at 48- and 64-position
    blocks above).  128-position blocks, more than the kernel takes, raise
    under ``auto`` and ``fused`` alike."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params
    from repro_torch.serve.engine import Request, ServeEngine
    dt = DTYPES[dtype]
    cfg = reduced(get_config("deepseek-v2-236b"), layers=3)
    model = init_params(cfg, 0, param_dtype=dt)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 5, 33)]
    outs = {}
    for read, bs in (("auto", 64), ("gather", 64), ("auto", 16)):
        eng = ServeEngine(cfg, model, slots=2, capacity=160,
                          kv_block_size=bs, prefill_chunk=16,
                          rc=RunConfig(compute_dtype=dt,
                                       schedule_policy="dynamic",
                                       paged_attn=read))
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        ops.reset_launches()
        eng.run(reqs)
        assert ops.LAUNCHES["paged_attention_mla"] == \
            (cfg.n_layers * eng.n_forwards if read == "auto" else 0)
        assert ops.LAUNCHES["paged_attention"] == 0
        outs[read, bs] = [r.out for r in reqs]
        assert all(len(o) == 6 for o in outs[read, bs])
    want = outs["gather", 64] if dt == torch.float32 else outs["auto", 16]
    assert outs["auto", 64] == want
    for read in ("auto", "fused"):
        with pytest.raises(ValueError, match="at most 64 positions"):
            ServeEngine(cfg, model, slots=1, capacity=256,
                        kv_block_size=128,
                        rc=RunConfig(compute_dtype=dt,
                                     schedule_policy="dynamic",
                                     paged_attn=read)).run(
                [Request(rid=0, prompt=prompts[1], max_new=2)])


# the capacity_factor policy: only a prefix of each expert's bucket is
# active, a bucket with no tokens is wholly inactive, and the sentinel block
# [E cap, E cap + M) takes the dropped assignments.  The work lists give
# every such span a zero tile; with the allocator poisoned by NaN, every
# row that holds no token must come out exactly 0.
CAPACITY_CASES = [(2, 64, 0.5), (64, 64, 1.25), (64, 64, 0.5),
                  (2, 160, 1.25)]


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["none", "int8_expert", "int4_packed"])
@pytest.mark.parametrize("T,E,cf", CAPACITY_CASES)
def test_capacity_gemms_store_zeros_on_every_row_without_a_token(cuda, T, E,
                                                                 cf, scheme):
    """B2 and B1 (dense bf16, int8, int4) and B1^T (dense bf16) on a
    capacity_factor schedule at k=6, d=256, f=192: within TOL of the plain
    versions, bitwise across two calls, and exactly 0 on every row whose
    src_tok is -1 (bucket tails, empty buckets, the sentinel block)."""
    from repro_torch.quantization import get_scheme
    k, d, f = 6, 256, 192
    logits, x, wg, wu, wd = layer(cuda, T, E, k, d, f, torch.bfloat16,
                                  seed=T + E)
    if scheme != "none":
        wg, wu, wd = (get_scheme(scheme).quantize(w) for w in (wg, wu, wd))
    w, idx = ref.router_ref(logits, k, gating="softmax", norm_topk=False,
                            routed_scale=16.0)
    sched = build_capacity_schedule(idx, E, 128, capacity_factor=cf)
    empty = (sched.src_tok < 0)
    assert int(sched.block_active[-1]) == 0            # the sentinel
    assert int(empty.sum()) > sched.block_m            # and bucket tails
    xp = ops.permute(x, sched)
    h = ref.fused_gate_up_ref(xp, wg, wu, sched)
    scale = combine_scale_rows(sched, w)
    dy = ops.permute(torch.randn((T, d), device=cuda).to(torch.bfloat16),
                     sched)
    calls = [(lambda: ops.fused_gate_up(xp, wg, wu, sched),
              lambda: ref.fused_gate_up_ref(xp, wg, wu, sched), f),
             (lambda: ops.grouped_gemm(h, wd, sched, row_scale=scale),
              lambda: ref.grouped_gemm_ref(h, wd, sched, scale), d)]
    if scheme == "none":
        calls.append((lambda: ops.grouped_gemm_t(dy, wd, sched),
                      lambda: ref.grouped_gemm_t_ref(dy, wd, sched), f))
    for kern, plain, n in calls:
        junk = torch.full((sched.capacity * n,), float("nan"), device=cuda,
                          dtype=torch.bfloat16)
        del junk
        out = kern()
        again = kern()
        want = plain()
        torch.cuda.synchronize()
        assert not torch.isnan(out).any()
        assert torch.equal(out, again)
        assert torch.equal(out[empty], torch.zeros_like(out[empty]))
        torch.testing.assert_close(out.float(), want.float(),
                                   **TOL["bfloat16"])


@pytest.mark.gpu
def test_moe_layer_under_remat_makes_no_host_sync(cuda):
    """moe_ffn on capacity_factor inside the non-reentrant checkpoint that
    ``RunConfig.remat`` wraps each layer in: the forward, and the backward
    with its recomputed forward, under set_sync_debug_mode("error")."""
    from torch.utils.checkpoint import checkpoint
    T, E, k, d, f = 64, 64, 6, 256, 192
    _, x, wg, wu, wd = layer(cuda, T, E, k, d, f, torch.bfloat16)
    args = [t.requires_grad_(True) for t in
            (x, torch.randn((d, E), device=cuda), wg, wu, wd)]
    cfg = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                            executor="cuda", gating="sigmoid",
                            norm_topk=True, routed_scale=2.446,
                            schedule_policy="capacity_factor",
                            capacity_factor=1.25, emit_stats=True)

    def step():
        y, aux = checkpoint(moe_ffn, *args, cfg, use_reentrant=False,
                            preserve_rng_state=False)
        (y.float().sum() + aux["lb_loss"]).backward()
        return aux
    step()                                     # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(a.grad).all() for a in args)
    assert 0.0 <= float(aux["sched/drop_fraction"]) < 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "capacity_factor"])
def test_train_step_launches_under_remat(cuda, policy):
    """Reduced moonshot (1 dense + 2 MoE layers), bf16 compute: remat adds
    each MoE layer's forward kernels once (router, permute, fused_gate_up,
    the down grouped_gemm, unpermute) and nothing of the backward's; the
    loss and every gradient equal those without remat within fp32's
    default closeness (the CPU test holds them bitwise; here the
    embedding's backward accumulates with atomics)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params, loss_fn
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(0))
    got = {}
    for remat in (False, True):
        model = init_params(cfg, 0, device=cuda).requires_grad_(True)
        rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=16,
                       schedule_policy=policy, capacity_factor=1.25,
                       remat=remat)
        ops.reset_launches()
        loss, _ = loss_fn(model, cfg, rc, {"tokens": toks})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        got[remat] = (loss.detach(), grads,
                      {k: v for k, v in ops.LAUNCHES.items() if v})
    n = 2
    base = {"router_topk": n, "permute": 2 * n, "unpermute": 2 * n,
            "fused_gate_up": n, "grouped_gemm": 3 * n,
            "grouped_gemm_t": 3 * n, "grouped_wgrad": 3 * n}
    assert got[False][2] == base
    assert got[True][2] == {**base, "router_topk": 2 * n,
                            "permute": 3 * n, "unpermute": 3 * n,
                            "fused_gate_up": 2 * n, "grouped_gemm": 4 * n}
    torch.testing.assert_close(got[True][0], got[False][0])
    for a, b in zip(got[True][1], got[False][1]):
        torch.testing.assert_close(a, b)


@pytest.mark.gpu
def test_threefry_and_sampled_tokens_on_the_card_equal_the_cpu(cuda):
    """Integer threefry is exact: keys, bits and uniforms on the card are
    bitwise the CPU's; the sampled tokens for the same logits too (a draw
    flips only on a near-tie the one-ulp ``log`` difference could
    decide, which these logits do not hold)."""
    from repro_torch.sampling import (SamplingConfig, row_key, sample_rows,
                                      uniform_rows)
    from repro_torch.sampling import threefry
    seeds = torch.tensor([0, 7, -3, 2 ** 31 - 1], dtype=torch.int64)
    ctr = torch.tensor([0, 5, 70000, 12], dtype=torch.int64)
    for role in range(4):
        kc = row_key(seeds, ctr, role)
        kg = row_key(seeds.to(cuda), ctr.to(cuda), role)
        for a, b in zip(kc, kg):
            assert torch.equal(a, b.cpu())
        assert torch.equal(threefry.random_bits(kc, 163840),
                           threefry.random_bits(kg, 163840).cpu())
        assert torch.equal(threefry.uniform(kc, 4099),
                           threefry.uniform(kg, 4099).cpu())
    assert torch.equal(uniform_rows(seeds, ctr, 5),
                       uniform_rows(seeds.to(cuda), ctr.to(cuda), 5).cpu())
    logits = torch.randn(4, 4096, generator=torch.Generator().manual_seed(0))
    for kw in (dict(method="temperature", temperature=0.8),
               dict(method="top_k", top_k=50, temperature=0.8),
               dict(method="top_p", top_p=0.9, temperature=0.8)):
        cfg = SamplingConfig(**kw)
        got = sample_rows(logits.to(cuda), cfg, seeds.to(cuda),
                          ctr.to(cuda))
        assert torch.equal(got.cpu(), sample_rows(logits, cfg, seeds, ctr))


def _spec_engine(cuda, k=3, sampling=None):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params
    from repro_torch.spec import SpecEngine, make_draft_config
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=3)
    dcfg = make_draft_config(cfg, reduce=True)
    eng = SpecEngine(cfg, init_params(cfg, 0), draft_cfg=dcfg,
                     draft_model=init_params(dcfg, 1), spec_k=k, slots=2,
                     capacity=96, kv_block_size=16, prefill_chunk=32,
                     rc=RunConfig(schedule_policy="dynamic"),
                     sampling=sampling)
    return cfg, dcfg, eng


@pytest.mark.gpu
def test_spec_verify_launch_counts(cuda):
    """Every step of a speculative run (reduced moonshot, 3 layers: 2 MoE;
    reduced smollm draft, fused reads): the GQA kernel once a layer a
    forward, target and draft, and each MoE kernel once a MoE layer a
    target forward: one plan for the whole verify sweep; the tokens are
    the plain engine's."""
    from repro_torch.models.lm import n_moe_layers
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, dcfg, eng = _spec_engine(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 9)]
    reqs = [Request(rid=i, prompt=p, max_new=12)
            for i, p in enumerate(prompts)]
    pending = eng.enqueue(reqs)
    while pending or eng.n_active:
        eng.schedule(pending)
        f0, d0 = eng.n_forwards, eng.n_draft_forwards
        ops.reset_launches()
        eng.step()
        df, dd = eng.n_forwards - f0, eng.n_draft_forwards - d0
        launches = dict(ops.LAUNCHES)
        assert launches.pop("paged_attention") \
            == cfg.n_layers * df + dcfg.n_layers * dd, ops.LAUNCHES
        for name in ("router_topk", "permute", "fused_gate_up",
                     "grouped_gemm", "unpermute"):
            assert launches.pop(name) == n_moe_layers(cfg) * df, name
        assert all(n == 0 for n in launches.values()), ops.LAUNCHES
    assert eng.n_spec_rounds > 0 and all(r.done for r in reqs)
    base = ServeEngine(cfg, eng.model, slots=2, capacity=96,
                       kv_block_size=16, prefill_chunk=32, rc=eng.rc)
    breqs = [Request(rid=i, prompt=p, max_new=12)
             for i, p in enumerate(prompts)]
    base.run(breqs)
    assert [r.out for r in breqs] == [r.out for r in reqs]


@pytest.mark.gpu
def test_spec_round_makes_no_host_sync(cuda):
    """The k draft steps and the verify forward of a round run under
    ``set_sync_debug_mode("error")``: the round's one transfer is the
    emit, after them; greedy and ``top_p``."""
    from repro_torch.sampling import SamplingConfig
    from repro_torch.serve.engine import Request
    for sampling in (None, SamplingConfig(method="top_p", top_p=0.9,
                                          temperature=0.8)):
        cfg, _, eng = _spec_engine(cuda, sampling=sampling)
        device_part = eng.spec_device
        guarded = []

        def spec_device(inp):
            if eng.n_spec_rounds == 0:
                return device_part(inp)          # the first round warms up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = device_part(inp)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            guarded.append(1)
            return out
        eng.spec_device = spec_device
        reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32) + 1,
                        max_new=16) for i in range(2)]
        eng.run(reqs)
        assert all(r.done for r in reqs) and len(guarded) >= 2
