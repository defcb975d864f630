"""Analytic per-cell FLOP / HBM-byte / parameter models (counterpart of
``repro.analysis.flops``, with the same arithmetic).

Matmul-exact FLOP counting per architecture block, used three ways:

1. MODEL_FLOPS = 6 * N_active * D (N_active = matmul-participating
   parameters touched per token incl. the LM head, excl. the embedding
   gather; D = tokens processed).
2. DISPATCH_FLOPS = what the executed program computes, including the
   paper-relevant overheads: top-k expansion (k x expert FFN per token),
   EP capacity padding, causal-mask waste in chunked attention, remat
   recompute (train: bwd = 2x fwd, remat adds ~1x fwd).
3. HBM byte estimates for the memory roofline term (dominant flows only:
   weights, activations residual traffic, KV-cache reads, optimizer state).

One difference from the reference: ``cell_cost`` takes the size of the
EP group (``ep``).  The reference fixes it at 16, so below 16 chips its
``chips // 16`` is 0, the tokens a group falls to 1 and the capacity-waste
term explodes (ROADMAP C17: moonshot's dispatch FLOPs 994.5x its model
FLOPs at 1 and 8 chips, 2.2x at 16).  With ``ep`` left out it is 16, which
must divide ``chips``: the reference's numbers exactly.  The dry run
passes its grid's EP size (the 'model' axis of a MoE model's grid; 1 on
one card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import group_structure


@dataclass
class CellCost:
    model_flops: float          # 6*N_active*D convention (global)
    dispatch_flops: float       # executed, incl. waste (global)
    hbm_bytes: float            # per-device estimate
    n_params: float
    n_active: float
    notes: str = ""


def _attn_params(cfg: ModelConfig) -> float:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return (d * m.q_lora_rank + m.q_lora_rank * H * (m.qk_nope_head_dim
                + m.qk_rope_head_dim) + d * (m.kv_lora_rank
                + m.qk_rope_head_dim) + m.kv_lora_rank * H
                * (m.qk_nope_head_dim + m.v_head_dim) + H * m.v_head_dim * d)
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def _ffn_params(cfg: ModelConfig, f: int) -> float:
    return (3 if cfg.act in ("swiglu", "geglu") else 2) * cfg.d_model * f


def _ssm_params(cfg: ModelConfig) -> float:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    return (cfg.d_model * (2 * d_in + 2 * gn + H)
            + s.conv_kernel * (d_in + 2 * gn) + d_in * cfg.d_model)


def _rwkv_params(cfg: ModelConfig) -> float:
    d, f = cfg.d_model, cfg.d_ff
    r = cfg.rwkv.decay_lora
    return 5 * d * d + 2 * d * r + (d * f + f * d + d * d) + d * d


def block_params(cfg: ModelConfig, kind: str) -> float:
    if kind == "rwkv":
        return _rwkv_params(cfg)
    if kind == "mamba":
        return _ssm_params(cfg)
    a = _attn_params(cfg)
    if kind == "moe":
        m = cfg.moe
        routed = m.n_experts * 3 * cfg.d_model * m.d_ff_expert
        shared = m.n_shared_experts * 3 * cfg.d_model * m.d_ff_expert
        return a + cfg.d_model * m.n_experts + routed + shared
    if kind == "moe_dense":
        return a + _ffn_params(cfg, cfg.moe.d_ff_dense or 4 * cfg.d_model)
    return a + _ffn_params(cfg, cfg.d_ff)


def block_active_params(cfg: ModelConfig, kind: str) -> float:
    """Params touched per token (MoE: only top-k + shared experts)."""
    if kind == "moe":
        m = cfg.moe
        a = _attn_params(cfg)
        return (a + cfg.d_model * m.n_experts
                + (m.top_k + m.n_shared_experts) * 3 * cfg.d_model
                * m.d_ff_expert)
    return block_params(cfg, kind)


def _all_kinds(cfg: ModelConfig):
    prefix, body, n_groups, suffix = group_structure(cfg)
    kinds = list(prefix) + list(body) * n_groups + list(suffix)
    # shared_attn blocks share weights: params counted once per unique block,
    # but ACTIVE per application
    return kinds


def total_params(cfg: ModelConfig) -> float:
    kinds = _all_kinds(cfg)
    n = 0.0
    seen_shared = 0
    for k in kinds:
        if k == "shared_attn":
            if seen_shared < cfg.n_shared_attn_blocks:
                n += block_params(cfg, "attn")
                seen_shared += 1
            continue
        n += block_params(cfg, k)
    n += cfg.vocab_size * cfg.d_model            # embedding
    if not cfg.tie_embeddings and not cfg.encoder_only:
        n += cfg.d_model * cfg.vocab_size        # head
    return n


def active_params(cfg: ModelConfig) -> float:
    """Matmul params per token (head included, embed-gather excluded)."""
    n = 0.0
    for k in _all_kinds(cfg):
        kk = "attn" if k == "shared_attn" else k
        n += block_active_params(cfg, kk)
    n += cfg.d_model * cfg.vocab_size            # LM/classifier head
    return n


# ----------------------------------------------------------------------
def _attn_flops_token(cfg: ModelConfig, kv_len: float, kind: str,
                      decode: bool) -> float:
    """Attention score+value FLOPs per token (projections counted via
    active params)."""
    window = cfg.local_window if kind == "attn_local" else None
    eff = min(kv_len, window) if window else kv_len
    if cfg.mla is not None:
        m = cfg.mla
        if decode:
            r = m.kv_lora_rank
            per = (2 * cfg.n_heads * m.qk_nope_head_dim * r         # absorb q
                   + 2 * cfg.n_heads * (r + m.qk_rope_head_dim) * eff
                   + 2 * cfg.n_heads * r * eff
                   + 2 * cfg.n_heads * r * m.v_head_dim)
            return per
        return 2 * cfg.n_heads * eff * (m.qk_nope_head_dim
                                        + m.qk_rope_head_dim
                                        + m.v_head_dim)
    return 2 * cfg.n_heads * cfg.head_dim * eff * 2


def _mixer_state_flops_token(cfg: ModelConfig) -> float:
    if cfg.family == "ssm":                      # rwkv: rank-1 state updates
        n = cfg.rwkv.head_size
        return 5 * cfg.d_model * n
    if cfg.ssm is not None:                      # mamba2 SSD
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        L = s.chunk
        # intra-chunk (L x L attention-like) + state update/readout
        return (2 * L * s.n_groups * s.d_state + 2 * L * d_in / (d_in
                // s.head_dim) * 0 + 4 * d_in * s.d_state)
    return 0.0


def ep_size(chips: int, ep: Optional[int] = None) -> int:
    """The EP group size ``cell_cost`` models: ``ep`` (which must divide
    ``chips``), or the reference's 16 where it divides ``chips``; anything
    else raises (C17)."""
    if ep is None:
        if chips % 16:
            raise ValueError(f"{chips} chips: pass the grid's EP size (the "
                             "reference's fixed 16 does not divide them; "
                             "ROADMAP C17)")
        return 16
    if ep < 1 or chips % ep:
        raise ValueError(f"ep={ep} must divide chips={chips}")
    return ep


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, *, chips: int,
              accum: int = 1, capacity_factor: float = 2.0,
              remat: bool = True, ep: Optional[int] = None) -> CellCost:
    ep = ep_size(chips, ep)
    mode = shape.kind
    decode = mode == "decode"
    if decode:
        tokens = float(shape.global_batch)       # one token per sequence
        kv_len = float(shape.seq_len)
        seq_avg = kv_len
    else:
        tokens = float(shape.global_batch) * shape.seq_len
        kv_len = shape.seq_len
        seq_avg = shape.seq_len / 2 if cfg.causal else shape.seq_len

    n_par = total_params(cfg)
    n_act = active_params(cfg)

    # --- MODEL_FLOPS (assignment convention) ---
    fwd_factor = 2.0                             # 2 flops per param-MAC
    mult = 3.0 if mode == "train" else 1.0       # bwd = 2x fwd
    model_flops = fwd_factor * mult * n_act * tokens

    # --- DISPATCH_FLOPS: add attention quadratic + waste terms ---
    kinds = _all_kinds(cfg)
    attn_extra = 0.0
    moe_waste = 0.0
    mixer_extra = 0.0
    for k in kinds:
        if k in ("attn", "attn_global", "attn_local", "cross", "moe",
                 "moe_dense", "shared_attn"):
            kk = "attn_local" if k == "attn_local" else k
            kvl = cfg.n_image_tokens if k == "cross" else \
                (kv_len if decode else seq_avg)
            attn_extra += _attn_flops_token(cfg, kvl, kk, decode) * tokens
        if k == "moe":
            m = cfg.moe
            # EP static-capacity padding: dispatched rows/useful rows
            tl = max(tokens / chips * (chips // ep), 1)
            cap = max(128, capacity_factor * tl * m.top_k / m.n_experts)
            waste_ratio = (m.n_experts * cap) / max(tl * m.top_k, 1)
            moe_waste += (waste_ratio - 1.0) * m.top_k * 3 * 2 \
                * cfg.d_model * m.d_ff_expert * tokens
        if k in ("rwkv", "mamba"):
            mixer_extra += _mixer_state_flops_token(cfg) * tokens
    dispatch = model_flops + mult * (attn_extra + mixer_extra) \
        + mult * moe_waste
    if mode == "train" and remat:
        dispatch *= 4.0 / 3.0                    # remat: fwd recompute in bwd

    # --- HBM bytes per device (dominant flows) ---
    pb = 2.0                                     # bf16 params
    per_dev = 1.0 / chips
    if mode == "train":
        # per microbatch: weights gathered+read fwd & bwd(+remat) ~ 3x;
        # optimizer m,v read+write fp32 (16B/param); activations: residual
        # stream read/write ~ 12x d_model bytes per token per layer
        hbm = (3.0 * accum * n_par * pb + n_par * 16) / chips \
            + len(kinds) * 12 * tokens * cfg.d_model * 2.0 / chips
    elif mode == "prefill":
        hbm = (n_par * pb + len(kinds) * 8 * tokens * cfg.d_model * 2.0) \
            / chips
    else:
        # decode: weights + full KV-cache read per step
        cache = _cache_bytes(cfg, kinds, [kv_len] * shape.global_batch)
        hbm = (n_par * pb + cache) / chips

    return CellCost(model_flops=model_flops, dispatch_flops=dispatch,
                    hbm_bytes=hbm, n_params=n_par, n_active=n_act)


def _cache_bytes(cfg: ModelConfig, kinds, context) -> float:
    """The cache one decode step reads, its rows at ``context`` positions
    each (bf16 K/V or MLA latent; a recurrent state read and written), as
    the reference counts it: no K/V for a MoE block without MLA (C18)."""
    rows, pos = len(context), float(sum(context))
    cache = 0.0
    for k in kinds:
        if cfg.mla is not None and k in ("moe", "moe_dense"):
            cache += (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) \
                * pos * 2.0
        elif k in ("attn", "attn_global", "shared_attn"):
            cache += 2 * cfg.n_kv_heads * cfg.head_dim * pos * 2.0
        elif k == "attn_local":
            w = cfg.local_window
            cache += 2 * cfg.n_kv_heads * cfg.head_dim * float(sum(
                min(c, w or c) for c in context)) * 2.0
        elif k == "mamba":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            cache += d_in * s.d_state * 4.0 * rows * 2
        elif k == "rwkv":
            n = cfg.rwkv.head_size
            cache += cfg.d_model * n * 4.0 * rows * 2
    return cache


@dataclass
class StepWork:
    flops: float                # the step's useful products
    hbm_bytes: float            # the bytes it must move at the least
    parts: dict                 # hbm_bytes by part


def step_work(cfg: ModelConfig, shape: ShapeConfig, *, remat: bool = False,
              param_bytes: float = 2.0, routed: Optional[float] = None,
              expert_bytes: Optional[float] = None,
              context=None) -> StepWork:
    """The least work one timed step of ``shape`` does on one card: the
    roofline bound of a measured step (the port's own; ``cell_cost`` is
    the reference's model of a cell, with its dominant flows and its EP
    padding).

    FLOPs: ``cell_cost``'s dispatch FLOPs on one card without the
    static-capacity term (a schedule's padding is the step's waste, not
    its work): model FLOPs, attention and recurrent-state products, the
    backward, and the forward again under ``remat``.  Decode rows attend
    over their own ``context`` (positions each row's step reads; default
    ``shape.seq_len`` for every row).

    Bytes: decode reads every parameter it uses once, at its stored size
    (``param_bytes``): the embedding only in the rows it gathers (whole
    where it is the tied head), of the routed experts only the ``routed``
    its router chose (summed over the MoE layers; all of them when None),
    ``expert_bytes`` each (default ``3 d f param_bytes``), and the cache
    at each row's context (a MoE block's K/V too, C18).  Train and
    prefill: ``cell_cost``'s bytes."""
    kinds = _all_kinds(cfg)
    decode = shape.kind == "decode"
    if decode:
        ctx = [float(c) for c in (context if context is not None
                                  else [shape.seq_len] * shape.global_batch)]
        tokens = float(len(ctx))
    else:
        tokens = float(shape.global_batch) * shape.seq_len
        seq_avg = shape.seq_len / 2 if cfg.causal else shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0
    extra = 0.0
    for k in kinds:
        if k in ("attn", "attn_global", "attn_local", "cross", "moe",
                 "moe_dense", "shared_attn"):
            kk = "attn_local" if k == "attn_local" else k
            if k == "cross":
                extra += _attn_flops_token(cfg, cfg.n_image_tokens, kk,
                                           decode) * tokens
            elif decode:
                extra += sum(_attn_flops_token(cfg, c, kk, True)
                             for c in ctx)
            else:
                extra += _attn_flops_token(cfg, seq_avg, kk, False) * tokens
        if k in ("rwkv", "mamba"):
            extra += _mixer_state_flops_token(cfg) * tokens
    flops = mult * (2.0 * active_params(cfg) * tokens + extra)
    if shape.kind == "train" and remat:
        flops *= 4.0 / 3.0
    if not decode:
        b = cell_cost(cfg, shape, chips=1, ep=1, remat=remat).hbm_bytes
        return StepWork(flops, b, {"cell_cost": b})
    d = cfg.d_model
    params = total_params(cfg) * param_bytes
    parts = {}
    if not cfg.tie_embeddings:
        params -= cfg.vocab_size * d * param_bytes
        parts["embedding rows"] = tokens * d * param_bytes
    n_moe = sum(k == "moe" for k in kinds)
    if n_moe:
        m = cfg.moe
        per = 3 * d * m.d_ff_expert
        params -= n_moe * m.n_experts * per * param_bytes
        parts["routed experts"] = (n_moe * m.n_experts if routed is None
                                   else routed) * (
            per * param_bytes if expert_bytes is None else expert_bytes)
    parts["other parameters"] = params
    parts["cache"] = _cache_bytes(cfg, kinds, ctx)
    if cfg.mla is None:         # the K/V of MoE blocks, C18
        parts["cache"] += sum(k in ("moe", "moe_dense") for k in kinds) \
            * 2 * cfg.n_kv_heads * cfg.head_dim * sum(ctx) * 2.0
    return StepWork(flops, sum(parts.values()), parts)
