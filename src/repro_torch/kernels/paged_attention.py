"""Paged decode attention straight off the KV block pool (counterpart of
``repro.kernels.paged_attention``; kernel in ``csrc/paged_attention.cu``).

Row b of ``q`` is one decode query (a slot's decode token or one token of a
prompt chunk), GQA-grouped as (B, Hkv, G, D).  Its keys and values live in
the pool blocks its table row names, in logical order; an online softmax
over those blocks attends to positions ``<= kv_limit[b]`` (and, when asked,
the causal and sliding-window terms against ``q_pos[b]``), with an optional
logit softcap.  ``gather_block_kv`` reassembles a row's contiguous view for
the plain version and for the gather path of the model (the oracle).

On the card the GQA form splits each row's table entries into contiguous
ranges (``split_plan``, from the shapes alone: the wrapper never reads
``kv_limit`` on the host), walks the ranges in parallel and merges them in
split order; ``paged_decode_attention_walk`` is a plain model of that walk
for the tests.

The query is scaled by ``scale`` (default ``D**-0.5``) in its own dtype
before the kernel sees it, as in the reference: in bf16 that product
rounds, and the plain version rounds the same way.

MLA's absorbed decode adds a second score operand: ``q2`` against
``k2_pool`` (the rope key), so a score is ``q.k + q2.k2`` in fp32, and the
latent pool is both ``k_pool`` and ``v_pool``.  ``q2`` is scaled by the same
``scale``.  On the card that form runs its own kernels
(``paged_attention_mla`` in the launch counts), which read each latent
tile once as key and value: in bf16 a Hopper kernel that, like the GQA
one, walks ``mla_split_plan``'s ranges of each row's table in parallel and
merges them in order (``paged_decode_attention_mla_walk`` is its plain
model); in fp32 one pass over each row on CUDA cores."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, shapes

NEG_INF = -1e30          # finite -inf stand-in, as in the reference
# the GQA kernel (csrc/paged_attention.cu): a block of up to GQA_WARPS
# warps takes as many KV heads, a warp one, with a ring of GQA_STAGES (K, V)
# tiles each in the GQA_SMEM_BYTES of shared memory a block may have; a warp
# scores a pool block GQA_CHUNK positions at a time (each ends in two
# lanes); a lane holds at most GQA_MAX_WIDTH / 64 pairs of a head's q and
# accumulator
GQA_WARPS, GQA_STAGES, GQA_CHUNK, GQA_MAX_WIDTH = 4, 2, 16, 256
GQA_SMEM_BYTES = 232448            # the H100's opt-in limit a block
# the split plan's model of the card: the block slots it fills an SM (three
# blocks of bf16 heads of 128 fit, 64 KB of rings each, but fewer and
# longer splits measured faster on the H100: PERF.md), a block's fixed cost
# and the merge launch's, each in the time of one pool block's walk
SPLIT_SLOTS_PER_SM, SPLIT_BLOCK_COST, SPLIT_MERGE_COST = 2, 3, 2


def gather_block_kv(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool: (n_blocks, block_size, ...); tables: (B, nb) physical block ids
    in logical order -> (B, nb * block_size, ...), row b's positions in
    order.  Entries past a row's kv_limit may name any block: they are
    masked downstream."""
    g = pool[tables.long()]                           # (B, nb, bs, ...)
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _row_vector(val, B: int, device) -> torch.Tensor:
    """A scalar or (B,) int -> (B,) int32 on ``device``."""
    t = torch.as_tensor(val, dtype=torch.int32, device=device)
    return t.expand(B).contiguous() if t.dim() == 0 else t.contiguous()


def scale_q(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """``q * scale`` with the scale rounded to q's dtype first and the
    product rounded once, as the reference's ``q * asarray(scale,
    q.dtype)`` (default scale ``D**-0.5``)."""
    return q * _scale_value(q, scale)


def _scale_value(q: torch.Tensor, scale: Optional[float]) -> float:
    """The scale rounded to q's dtype, on the host."""
    s = q.shape[-1] ** -0.5 if scale is None else scale
    return torch.tensor(s, dtype=q.dtype).item()


def _require_rows(tables: torch.Tensor, lim: torch.Tensor, q_pos,
                  B: int) -> None:
    """The kernels take contiguous int32 (B, nb) tables and (B,) kv_limit
    and q_pos."""
    _build.require(tables.dtype == torch.int32 and tables.dim() == 2
                   and tables.shape[0] == B and tables.is_contiguous(),
                   f"paged attention takes contiguous int32 ({B}, nb) tables")
    _build.require(lim.shape == (B,)
                   and (q_pos is None or q_pos.shape == (B,)),
                   f"paged attention takes ({B},) kv_limit and q_pos")


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, tables: torch.Tensor,
                                 kv_limit, *, scale: Optional[float] = None,
                                 q_pos: Optional[torch.Tensor] = None,
                                 causal: bool = False,
                                 window: Optional[int] = None,
                                 logit_softcap: Optional[float] = None,
                                 q2: Optional[torch.Tensor] = None,
                                 k2_pool: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Dense fp32 attention over the gathered views with explicit masks
    (the reference test's two-term ``ref_paged_decode``); ``p`` is cast to
    V's dtype before the PV product, as the kernel does."""
    B, Hkv, G, D = q.shape
    dev = q.device
    S = tables.shape[1] * k_pool.shape[1]
    scale = D ** -0.5 if scale is None else scale    # q2 takes q's scale
    k = gather_block_kv(k_pool, tables).float()      # (B, S, Hkv, D)
    v = gather_block_kv(v_pool, tables)              # (B, S, Hkv, Dv)
    s = torch.einsum("bhgd,bshd->bhgs", scale_q(q, scale).float(), k)
    if q2 is not None:
        k2 = gather_block_kv(k2_pool, tables).float()
        s = s + torch.einsum("bhgd,bshd->bhgs", scale_q(q2, scale).float(),
                             k2)
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    kpos = torch.arange(S, device=dev)[None, None, None, :]
    lim = _row_vector(kv_limit, B, dev)[:, None, None, None]
    ok = kpos <= lim
    if causal or window is not None:
        qp = _row_vector(q_pos, B, dev)[:, None, None, None]
        if causal:
            ok = ok & (kpos <= qp)
        if window is not None:
            ok = ok & (kpos > qp - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    out = torch.where(l > 0, out / torch.clamp(l, min=1e-30),
                      torch.zeros_like(out))
    return out.to(q.dtype)


@functools.lru_cache(maxsize=1024)
def split_plan(B: int, Hkv: int, nb: int, sms: int) -> tuple:
    """The GQA kernel's cut of each row's ``nb`` table entries -> (n_split,
    per_split): split s takes entries [s * per_split, min(nb, (s + 1) *
    per_split)), no split empty.  The cut that minimises the model time
    rounds x (per_split + SPLIT_BLOCK_COST) (+ SPLIT_MERGE_COST where there
    is more than one split), where rounds = ceil(blocks / (SPLIT_SLOTS_PER_SM
    x sms)) over the B x ceil(Hkv / GQA_WARPS) x n_split blocks: few long
    splits where the rows fill the card, as many as fill its slots once
    where they do not.  It reads the shapes only, never ``kv_limit``: the
    call stays free of host syncs."""
    units = B * -(-Hkv // GQA_WARPS)
    slots = SPLIT_SLOTS_PER_SM * sms
    best = None
    for n0 in range(1, nb + 1):
        per = -(-nb // n0)
        n = -(-nb // per)
        cost = -(-units * n // slots) * (per + SPLIT_BLOCK_COST) \
            + (SPLIT_MERGE_COST if n > 1 else 0)
        if best is None or cost < best[0]:
            best = (cost, n, per)
    return best[1], best[2]


def gqa_warps(bs: int, D: int, Dv: int, itemsize: int) -> int:
    """Warps a block of the GQA kernel: GQA_WARPS, or as many as have
    room for their rings (0: one ring does not fit)."""
    ring = GQA_STAGES * bs * (D + Dv) * itemsize
    return min(GQA_WARPS, GQA_SMEM_BYTES // ring)


def _online_step(state, s, ok, v):
    """One online-softmax step of a warp over a chunk of positions: s (B,
    Hkv, G, n) fp32 scores, ok their mask, v (B, n, Hkv, Dv) in V's
    dtype."""
    m, l, acc = state
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(ok, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
    corr = torch.exp(m - m_new)
    pv = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return m_new, corr * l + p.sum(-1), corr[..., None] * acc + pv


def paged_decode_attention_walk(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, tables: torch.Tensor,
                                kv_limit, *, scale: Optional[float] = None,
                                q_pos: Optional[torch.Tensor] = None,
                                causal: bool = False,
                                window: Optional[int] = None,
                                logit_softcap: Optional[float] = None,
                                sms: int = 132) -> torch.Tensor:
    """A plain model of the GQA kernel's walk, for the tests: the split
    plan for ``sms`` SMs; in each split, each (row, KV head)'s warp runs
    the online softmax over the split's entries below the block holding
    kv_limit, in order, GQA_CHUNK positions at a time (fp32 statistics, p
    rounded to V's dtype before PV); the live splits (those that start
    below that block) merge in split order; l > 0 ? acc / max(l, 1e-30) :
    0.  Entries past that block are never read: poison there stays out."""
    B, Hkv, G, D = q.shape
    dev = q.device
    bs, nb, Dv = k_pool.shape[1], tables.shape[1], v_pool.shape[-1]
    n_split, per = split_plan(B, Hkv, nb, sms)
    lim = _row_vector(kv_limit, B, dev).long()
    qp = (_row_vector(q_pos, B, dev).long() if causal or window is not None
          else None)
    n_used = torch.where(lim < 0, torch.zeros_like(lim),
                         torch.clamp(lim // bs + 1, max=nb))
    qs = scale_q(q, scale).float()
    splits = []
    for s in range(n_split):
        j0 = s * per
        state = (torch.full((B, Hkv, G), NEG_INF, device=dev),
                 torch.zeros((B, Hkv, G), device=dev),
                 torch.zeros((B, Hkv, G, Dv), device=dev))
        for j in range(j0, min(nb, j0 + per)):
            taken = j < n_used                                 # (B,)
            blk = torch.where(taken, tables[:, j].long(),
                              torch.zeros_like(lim))
            keep = taken[:, None, None, None]
            kt = k_pool[blk].float()                           # (B, bs, Hkv, D)
            kt = torch.where(keep, kt, torch.zeros_like(kt))
            vt = v_pool[blk]
            vt = torch.where(keep, vt, torch.zeros_like(vt))
            for c0 in range(0, bs, GQA_CHUNK):
                c1 = min(bs, c0 + GQA_CHUNK)
                sc = torch.einsum("bhgd,bkhd->bhgk", qs, kt[:, c0:c1])
                if logit_softcap is not None:
                    sc = logit_softcap * torch.tanh(sc / logit_softcap)
                kpos = j * bs + torch.arange(c0, c1, device=dev)[None]
                ok = (kpos <= lim[:, None]) & taken[:, None]
                if causal:
                    ok = ok & (kpos <= qp[:, None])
                if window is not None:
                    ok = ok & (kpos > qp[:, None] - window)
                state = _online_step(state, sc, ok[:, None, None, :],
                                     vt[:, c0:c1])
        splits.append(((j0 < n_used)[:, None, None], state))
    return _merge_splits(splits).to(q.dtype)


def _merge_splits(splits) -> torch.Tensor:
    """The merge of the kernels' split partials, in split order: ``splits``
    is [(live (B, 1, 1), (m, l, acc))]; splits that start past the block
    holding kv_limit are left out (the kernel writes no partial for them);
    L > 0 ? acc / max(L, 1e-30) : 0, in fp32."""
    m0, _, a0 = splits[0][1]
    M = torch.full_like(m0, NEG_INF)
    for live, (m, _, _) in splits:
        M = torch.where(live, torch.maximum(M, m), M)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(a0)
    for live, (m, l, a) in splits:
        f = torch.where(live, torch.exp(m - M), torch.zeros_like(M))
        L = L + l * f
        acc = acc + a * f[..., None]
    return torch.where(L[..., None] > 0,
                       acc / torch.clamp(L[..., None], min=1e-30),
                       torch.zeros_like(acc))


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           kv_limit, *, scale: Optional[float] = None,
                           q_pos: Optional[torch.Tensor] = None,
                           causal: bool = False, window: Optional[int] = None,
                           logit_softcap: Optional[float] = None,
                           q2: Optional[torch.Tensor] = None,
                           k2_pool: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: (B, Hkv, G, D); k_pool: (n_blocks, bs, Hkv, D); v_pool:
    (n_blocks, bs, Hkv, Dv); tables: (B, nb) int32; kv_limit: scalar or
    (B,) inclusive last attended position; q_pos: (B,), needed for the
    causal and window masks; q2: (B, Hkv, G, D2) and k2_pool: (n_blocks,
    bs, Hkv, D2), the optional second score operand -> (B, Hkv, G, Dv) in
    q's dtype.

    CPU tensors run the plain version; CUDA tensors the kernel (with
    ``q2``, the MLA kernel, which takes ``v_pool`` to be ``k_pool``).
    Without ``q2`` the kernel walks each row's table in ``split_plan``'s
    ranges in parallel, a warp a (row, KV head, split), and, where there is
    more than one range, merges them in a second launch, in split order."""
    if (q2 is None) != (k2_pool is None):
        raise ValueError("the second score operand needs both q2 and "
                         "k2_pool")
    if (causal or window is not None) and q_pos is None:
        raise ValueError("causal/window masks need q_pos (per-row query "
                         "positions)")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be positive, not "
                         f"{logit_softcap}")
    B, Hkv, G, D = q.shape
    if shapes.is_fake(q, k_pool, v_pool, tables):
        return shapes.paged_attention_shape(q, k_pool, v_pool, tables, q2,
                                            k2_pool)
    lim = _row_vector(kv_limit, B, q.device)
    qp = None if q_pos is None else _row_vector(q_pos, B, q.device)
    kw = dict(scale=scale, q_pos=qp, causal=causal, window=window,
              logit_softcap=logit_softcap)
    if q2 is not None:
        _build.require(q2.dim() == 4 and k2_pool.dim() == 4
                       and q2.shape[:3] == (B, Hkv, G)
                       and k2_pool.shape[:3] == k_pool.shape[:3]
                       and k2_pool.shape[3] == q2.shape[3],
                       f"the second score operand takes q2 ({B}, {Hkv}, "
                       f"{G}, D2) and k2_pool {tuple(k_pool.shape[:3])} + "
                       "(D2,)")
    if not _build.on_cuda(q, k_pool, v_pool, tables, lim, qp, q2, k2_pool):
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, lim,
                                            q2=q2, k2_pool=k2_pool, **kw)
    if q2 is not None:
        return _launch_mla(q, q2, k_pool, v_pool, k2_pool, tables, lim, **kw)
    code = _build.dtype_code(q.dtype)
    n_blocks, bs = k_pool.shape[0], k_pool.shape[1]
    Dv = v_pool.shape[-1]
    nb = tables.shape[1] if tables.dim() == 2 else -1
    _build.require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
                   "paged attention takes q and both pools of one dtype")
    _build.require(k_pool.shape == (n_blocks, bs, Hkv, D)
                   and v_pool.shape == (n_blocks, bs, Hkv, Dv),
                   f"paged attention takes (n_blocks, bs, {Hkv}, D) pools")
    _build.require(k_pool.is_contiguous() and v_pool.is_contiguous(),
                   "paged attention takes contiguous pools")
    refusal = fused_read_refusal(bs, D, Dv, q.element_size())
    _build.require(refusal is None, refusal)
    warps = min(Hkv, gqa_warps(bs, D, Dv, q.element_size()))
    _require_rows(tables, lim, qp, B)
    qc = q.contiguous()            # the kernel scales it in q's dtype
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=q.device)
    n_split, per = split_plan(
        B, Hkv, nb, torch.cuda.get_device_properties(q.device)
        .multi_processor_count)
    part_ml = part_acc = None
    if n_split > 1:                      # each split's fp32 (m, l) and acc
        part_ml = torch.empty((B, Hkv, G, n_split, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((B, Hkv, G, n_split, Dv),
                               dtype=torch.float32, device=q.device)
    lib = _build.library()
    err = lib.moe_paged_attention(
        qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lim.data_ptr(),
        None if qp is None else qp.data_ptr(), out.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        _scale_value(q, scale),
        B, Hkv, G, D, Dv, bs, nb, per, n_split, warps, int(causal),
        int(window is not None), 0 if window is None else int(window),
        0.0 if logit_softcap is None else float(logit_softcap), code,
        _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    _build.LAUNCHES["paged_attention"] += 1
    return out


# the MLA kernels' limits (csrc/paged_attention.cu): the fp32 one holds a
# lane's share of a head's [q | q2] and of its accumulator in registers; the
# bf16 one takes the same widths, and pool blocks of at most one of its
# tiles (mla_tile), whose TMA boxes are a pool block's rows
MLA_MAX_QK, MLA_MAX_V = 576, 512
# the bf16 kernel: a thread block takes MLA_HEADS query heads (wgmma's M)
# of one (row, KV head) and walks its split in tiles of mla_tile() positions
MLA_HEADS = 64
# the MLA plan's model of the card, in the time of one pool block's walk: a
# split's fixed cost beside its q tile, and the merge launch's; a split's
# fp32 partial (written, then read by the merge) costs the walk of one pool
# block for each MLA_PARTIAL_PER_WALK of its size in pool blocks' bytes (a
# walk is held by TMA's box rate and the tensor cores, not by bytes)
MLA_SPLIT_FIXED, MLA_MERGE_COST, MLA_PARTIAL_PER_WALK = 3, 1, 4


def fused_read_refusal(bs: int, D: int, Dv: int, itemsize: int,
                       D2: Optional[int] = None) -> Optional[str]:
    """Why the fused paged read's kernels refuse a pool of ``bs``-position
    blocks, or None where they take it: GQA heads of ``D`` key and ``Dv``
    value columns of ``itemsize`` bytes, or with ``D2`` the MLA kernels'
    latent of ``D`` (also the value) and rope key of ``D2``.  The kernels'
    wrappers raise with it; the gather path and the reference take every
    shape."""
    if D2 is not None:
        if not (0 < D and D % 8 == 0 and D2 % 8 == 0 and D + D2 <= MLA_MAX_QK
                and D <= MLA_MAX_V):
            return (f"the MLA kernel takes D and D2 multiples of 8 with D "
                    f"<= {MLA_MAX_V} and D + D2 <= {MLA_MAX_QK}, not {D}, "
                    f"{D2}")
        if not 0 < bs <= mla_tile(D, D2):
            return (f"the MLA kernel takes blocks of at most "
                    f"{mla_tile(D, D2)} positions at D={D}, D2={D2}, not "
                    f"{bs}")
        return None
    if not (D % 8 == 0 and Dv % 8 == 0 and 0 < D <= GQA_MAX_WIDTH
            and 0 < Dv <= GQA_MAX_WIDTH):
        return (f"paged attention loads 16-byte vectors and holds at most "
                f"{GQA_MAX_WIDTH} columns a head: D={D} and Dv={Dv} must be "
                f"multiples of 8 up to {GQA_MAX_WIDTH}")
    if gqa_warps(bs, D, Dv, itemsize) <= 0:
        return (f"paged attention keeps two (bs, D + Dv) tiles a warp in "
                f"{GQA_SMEM_BYTES} bytes: bs={bs}, D={D}, Dv={Dv} of "
                f"{itemsize}-byte elements do not fit")
    return None


def mla_tile(D: int, D2: int) -> int:
    """Positions a tile of the bf16 MLA kernel: 64, or 32 where the row's
    64-column groups of [latent | rope key] number ten (the q tile and two
    stages of 64 positions would not fit in 227 KB)."""
    return 64 if -(-D // 64) + -(-D2 // 64) <= 9 else 32


@functools.lru_cache(maxsize=1024)
def mla_split_plan(B: int, Hkv: int, G: int, nb: int, bs: int, D: int,
                   D2: int, sms: int) -> tuple:
    """The bf16 MLA kernel's cut of each row's ``nb`` table entries ->
    (n_split, per_split), per_split a whole number of the kernel's tiles
    (``mla_tile(D, D2) // bs`` pool blocks), no split empty.  A thread block
    takes one split of one of B x Hkv x ceil(G / MLA_HEADS) units; one block
    fits an SM.  Model time, in pool-block walks: rounds x (per_split + the
    q tile + MLA_SPLIT_FIXED), and where there is more than one split, +
    rounds x the partial's cost (each split writes its fp32 64 x D
    accumulator and the merge reads it back: about seven pool blocks' bytes
    at deepseek's shape, two walks) + MLA_MERGE_COST; rounds = ceil(blocks
    / sms).  It reads the shapes only, never ``kv_limit``: the call stays
    free of host syncs."""
    units = B * Hkv * -(-G // MLA_HEADS)
    nbt = max(1, mla_tile(D, D2) // bs)
    block = bs * (D + D2)                      # a pool block's latent, bf16
    fixed = -(-MLA_HEADS * (D + D2) // block) + MLA_SPLIT_FIXED
    part = -(-MLA_HEADS * 2 * (D + 2) // block)     # fp32 acc, m and l
    part_cost = -(-part // MLA_PARTIAL_PER_WALK)
    best = None
    for tiles in range(1, -(-nb // nbt) + 1):
        per = min(nb, tiles * nbt)
        n = -(-nb // per)
        rounds = -(-units * n // sms)
        cost = rounds * (per + fixed) if n == 1 else \
            rounds * (per + fixed + part_cost) + MLA_MERGE_COST
        if best is None or cost < best[0]:
            best = (cost, n, per)
    return best[1], best[2]


def paged_decode_attention_mla_walk(q: torch.Tensor, kv_pool: torch.Tensor,
                                    k2_pool: torch.Tensor,
                                    tables: torch.Tensor, kv_limit, *,
                                    q2: torch.Tensor,
                                    scale: Optional[float] = None,
                                    q_pos: Optional[torch.Tensor] = None,
                                    causal: bool = False,
                                    window: Optional[int] = None,
                                    logit_softcap: Optional[float] = None,
                                    sms: int = 132) -> torch.Tensor:
    """A plain model of the bf16 MLA kernel's walk, for the tests: the MLA
    plan for ``sms`` SMs; in each split, the online softmax over the split's
    entries below the block holding kv_limit, in order, a tile of
    ``mla_tile`` positions at a time (scores q.kv + q2.k2 in fp32, fp32
    statistics, p rounded to the latent's dtype before PV, the latent as the
    value); the live splits merged in split order; l > 0 ? acc / max(l,
    1e-30) : 0.  Entries past that block are never read: poison there stays
    out."""
    B, Hkv, G, D = q.shape
    D2 = q2.shape[-1]
    dev = q.device
    bs, nb = kv_pool.shape[1], tables.shape[1]
    n_split, per = mla_split_plan(B, Hkv, G, nb, bs, D, D2, sms)
    nbt = max(1, mla_tile(D, D2) // bs)
    lim = _row_vector(kv_limit, B, dev).long()
    qp = (_row_vector(q_pos, B, dev).long() if causal or window is not None
          else None)
    n_used = torch.where(lim < 0, torch.zeros_like(lim),
                         torch.clamp(lim // bs + 1, max=nb))
    s = D ** -0.5 if scale is None else scale
    qs, q2s = scale_q(q, s).float(), scale_q(q2, s).float()
    splits = []
    for sp in range(n_split):
        j0 = sp * per
        j_end = min(nb, j0 + per)
        state = (torch.full((B, Hkv, G), NEG_INF, device=dev),
                 torch.zeros((B, Hkv, G), device=dev),
                 torch.zeros((B, Hkv, G, D), device=dev))
        for t0 in range(j0, j_end, nbt):
            js = range(t0, min(j_end, t0 + nbt))
            kv, k2, ok = [], [], []
            for j in js:
                taken = j < n_used                             # (B,)
                blk = torch.where(taken, tables[:, j].long(),
                                  torch.zeros_like(lim))
                keep = taken[:, None, None, None]
                kv.append(torch.where(keep, kv_pool[blk],
                                      torch.zeros_like(kv_pool[blk])))
                k2.append(torch.where(keep, k2_pool[blk],
                                      torch.zeros_like(k2_pool[blk])))
                kpos = j * bs + torch.arange(bs, device=dev)[None]
                okj = (kpos <= lim[:, None]) & taken[:, None]
                if causal:
                    okj = okj & (kpos <= qp[:, None])
                if window is not None:
                    okj = okj & (kpos > qp[:, None] - window)
                ok.append(okj)
            kvt, k2t = torch.cat(kv, 1), torch.cat(k2, 1)  # (B, n, Hkv, *)
            sc = torch.einsum("bhgd,bkhd->bhgk", qs, kvt.float()) \
                + torch.einsum("bhgd,bkhd->bhgk", q2s, k2t.float())
            if logit_softcap is not None:
                sc = logit_softcap * torch.tanh(sc / logit_softcap)
            state = _online_step(state, sc, torch.cat(ok, 1)[:, None, None],
                                 kvt)
        splits.append(((j0 < n_used)[:, None, None], state))
    return _merge_splits(splits).to(q.dtype)


def _launch_mla(q, q2, kv_pool, v_pool, k2_pool, tables, lim, *, scale,
                q_pos, causal, window, logit_softcap) -> torch.Tensor:
    """The MLA kernels: scores ``q.kv + q2.k2`` over the latent pool, which
    is also the value.  bf16: the Hopper kernel, a thread block per (row,
    KV head, tile of 64 query heads, split of ``mla_split_plan``), then the
    merge where there is more than one split.  fp32: one thread block per
    (row, KV head, tile of 16 query heads, or of 8 where 16-head tiles
    would not fill the card), over the whole table."""
    B, Hkv, G, D = q.shape
    D2 = q2.shape[-1]
    n_blocks, bs = kv_pool.shape[0], kv_pool.shape[1]
    nb = tables.shape[1] if tables.dim() == 2 else -1
    _build.require(v_pool.data_ptr() == kv_pool.data_ptr()
                   and v_pool.shape == kv_pool.shape,
                   "the MLA kernel reads one latent pool as key and value: "
                   "v_pool must be k_pool")
    _build.require(all(t.dtype == q.dtype for t in (q2, kv_pool, k2_pool)),
                   "paged attention takes q, q2 and the pools of one dtype")
    _build.require(kv_pool.shape == (n_blocks, bs, Hkv, D)
                   and k2_pool.shape == (n_blocks, bs, Hkv, D2),
                   f"the MLA kernel takes (n_blocks, bs, {Hkv}, {D}) and "
                   f"(n_blocks, bs, {Hkv}, {D2}) pools")
    _build.require(kv_pool.is_contiguous() and k2_pool.is_contiguous(),
                   "paged attention takes contiguous pools")
    refusal = fused_read_refusal(bs, D, D, q.element_size(), D2=D2)
    _build.require(refusal is None, refusal)
    _require_rows(tables, lim, q_pos, B)
    _build.require(nb > 0, "the MLA kernel takes tables of at least one "
                   "entry")
    s = D ** -0.5 if scale is None else scale
    out = torch.empty((B, Hkv, G, D), dtype=q.dtype, device=q.device)
    n_split, per = 1, nb
    part_ml = part_acc = None
    if q.dtype == torch.bfloat16:
        # the kernel rounds q * scale and q2 * scale to bf16 itself
        qs, q2s, k_scale = q.contiguous(), q2.contiguous(), _scale_value(q, s)
        _build.require(_build.aligned(qs, q2s, kv_pool, k2_pool),
                       "the bf16 MLA kernel loads q, q2 and the pools with "
                       "TMA: each must start on a 16-byte boundary")
        n_split, per = mla_split_plan(
            B, Hkv, G, nb, bs, D, D2,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
        if n_split > 1:                  # each split's fp32 (m, l) and acc
            part_ml = torch.empty((B, Hkv, G, n_split, 2),
                                  dtype=torch.float32, device=q.device)
            part_acc = torch.empty((B, Hkv, G, n_split, D),
                                   dtype=torch.float32, device=q.device)
    else:                                 # fp32: q and q2 arrive scaled
        qs, q2s, k_scale = (scale_q(q, s).contiguous(),
                            scale_q(q2, s).contiguous(), 1.0)
    err = _build.library().moe_paged_attention_mla(
        qs.data_ptr(), q2s.data_ptr(), kv_pool.data_ptr(),
        k2_pool.data_ptr(), tables.data_ptr(), lim.data_ptr(),
        None if q_pos is None else q_pos.data_ptr(), out.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(), k_scale,
        B, Hkv, G, D, D2, bs, nb, n_blocks, per, n_split, int(causal),
        int(window is not None), 0 if window is None else int(window),
        0.0 if logit_softcap is None else float(logit_softcap),
        _build.dtype_code(q.dtype), _build.stream_ptr(q.device))
    _build.check(err, "paged_attention_mla")
    _build.LAUNCHES["paged_attention_mla"] += 1
    return out
