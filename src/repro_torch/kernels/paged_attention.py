"""Paged decode attention straight off the KV block pool (counterpart of
``repro.kernels.paged_attention``; kernel in ``csrc/paged_attention.cu``).

Row b of ``q`` is one decode query (a slot's decode token or one token of a
prompt chunk), GQA-grouped as (B, Hkv, G, D).  Its keys and values live in
the pool blocks its table row names, in logical order; an online softmax
over those blocks attends to positions ``<= kv_limit[b]`` (and, when asked,
the causal and sliding-window terms against ``q_pos[b]``), with an optional
logit softcap.  ``gather_block_kv`` reassembles a row's contiguous view for
the plain version and for the gather path of the model (the oracle).

The query is scaled by ``scale`` (default ``D**-0.5``) in its own dtype
before the kernel sees it, as in the reference: in bf16 that product
rounds, and the plain version rounds the same way.

MLA's absorbed decode adds a second score operand: ``q2`` against
``k2_pool`` (the rope key), so a score is ``q.k + q2.k2`` in fp32, and the
latent pool is both ``k_pool`` and ``v_pool``.  ``q2`` is scaled by the same
``scale``.  On the card that form runs its own kernel
(``paged_attention_mla`` in the launch counts), which reads each latent
tile once as key and value."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30          # finite -inf stand-in, as in the reference


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
    s = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.tensor(s, dtype=q.dtype).item()       # host-side rounding
    return q * s


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
    ``q2``, the MLA kernel, which takes ``v_pool`` to be ``k_pool``)."""
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
    _build.require(D % 8 == 0 and Dv % 8 == 0,
                   f"paged attention loads 16-byte vectors: D={D} and "
                   f"Dv={Dv} must be multiples of 8")
    _require_rows(tables, lim, qp, B)
    qs = scale_q(q, scale).contiguous()
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=q.device)
    lib = _build.library()
    err = lib.moe_paged_attention(
        qs.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lim.data_ptr(),
        None if qp is None else qp.data_ptr(), out.data_ptr(),
        B, Hkv, G, D, Dv, bs, nb, int(causal), int(window is not None),
        0 if window is None else int(window),
        0.0 if logit_softcap is None else float(logit_softcap), code,
        _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    _build.LAUNCHES["paged_attention"] += 1
    return out


# the MLA kernel's limits (csrc/paged_attention.cu): each lane holds its
# share of a head's [q | q2] and of its accumulator in registers, and a lane
# holds one position of a pool block
MLA_MAX_QK, MLA_MAX_V, MLA_MAX_BLOCK = 576, 512, 32


def _launch_mla(q, q2, kv_pool, v_pool, k2_pool, tables, lim, *, scale,
                q_pos, causal, window, logit_softcap) -> torch.Tensor:
    """The MLA kernel: scores ``q.kv + q2.k2`` over the latent pool, which
    is also the value.  One thread block per (row, KV head, tile of 16 query
    heads, or of 8 where 16-head tiles would not fill the card)."""
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
    _build.require(D % 8 == 0 and D2 % 8 == 0 and D + D2 <= MLA_MAX_QK
                   and D <= MLA_MAX_V,
                   f"the MLA kernel takes D and D2 multiples of 8 with D <= "
                   f"{MLA_MAX_V} and D + D2 <= {MLA_MAX_QK}, not {D}, {D2}")
    _build.require(0 < bs <= MLA_MAX_BLOCK,
                   f"the MLA kernel takes blocks of at most {MLA_MAX_BLOCK} "
                   f"positions, not {bs}")
    _require_rows(tables, lim, q_pos, B)
    s = D ** -0.5 if scale is None else scale
    qs = scale_q(q, s).contiguous()
    q2s = scale_q(q2, s).contiguous()
    out = torch.empty((B, Hkv, G, D), dtype=q.dtype, device=q.device)
    err = _build.library().moe_paged_attention_mla(
        qs.data_ptr(), q2s.data_ptr(), kv_pool.data_ptr(),
        k2_pool.data_ptr(), tables.data_ptr(), lim.data_ptr(),
        None if q_pos is None else q_pos.data_ptr(), out.data_ptr(),
        B, Hkv, G, D, D2, bs, nb, int(causal), int(window is not None),
        0 if window is None else int(window),
        0.0 if logit_softcap is None else float(logit_softcap),
        _build.dtype_code(q.dtype), _build.stream_ptr(q.device))
    _build.check(err, "paged_attention_mla")
    _build.LAUNCHES["paged_attention_mla"] += 1
    return out
