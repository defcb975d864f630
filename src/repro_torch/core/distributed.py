"""Expert-parallel MoE dispatch over an ``EPGroup`` (counterpart of
``repro.core.distributed``).

The paper targets single-GPU dispatch and defers multi-device expert
parallelism (its Limitation 6).  Here the paper's pipeline becomes each
rank's inner loop of a GShard-style EP layer: each rank routes with
``plan_dispatch`` (B5) and runs the configured executor's phases (B3
``permute``, B2 ``fused_gate_up``, B1 ``grouped_gemm``, B4 ``unpermute``)
on the experts it owns; only the layout between the phases is EP-specific.

The reference runs one program whose ``shard_map`` hands every device its
slice.  The port runs one process per rank (``repro_torch.distributed``):
``apply_moe_ep`` takes the GLOBAL ``x``, the same on every rank, and
returns the global ``y``, the same on every rank.  Non-expert weights are
whole on every rank; the routed stacks hold this rank's ``E // ep``
experts (``repro_torch.weights.shard_experts``).

``token_layout="sharded"`` (prefill, batch-sharded decode): this rank's
slice of the tokens goes through the padding-free send path (X-MoE style):
local routing -> the policy's drop decisions on GLOBAL slot ranks ->
per-destination COMPACTED send buffers (``a2a_send_rows`` rows each, sized
by the policy's capacity, not ``E_local * static_cap``) -> an int32
all_to_all of each row's local expert and the payload all_to_all -> the
receive side builds the policy's ``BlockSchedule`` over its rows (one
sentinel expert absorbs transport padding) and runs the executor phases ->
the inverse all_to_all -> the weighted combine on the source rank -> an
all_gather of every rank's slice.

``token_layout="sharded_static"``: the legacy static-capacity transport
(every expert a tile-aligned bucket, ``E_local * cap`` rows a destination
whatever the load; assignments past a bucket dropped whatever the policy),
kept for A/B measurement of the padding-free path's payload.

``token_layout="replicated"`` (decode): every rank routes all the tokens,
sends the assignments of experts it does not own to a sentinel expert
whose blocks are inactive, runs the phases with the combine weights folded
into B1, and one all_reduce sums the partial outputs: O(T d) instead of an
all_to_all of expert rows.

Drops are the schedule policy's under every layout but the static one:
``fixed`` and ``dynamic`` drop nothing, ``capacity_factor`` drops past its
bucket sized over the GLOBAL token count, first come first kept in global
token order, row for row the single-device policy's.  ``sched/*`` stats,
with ``cfg.emit_stats``, are sums over the group.

Send sizes come from T, k, E and ep on the host: nothing here reads the
device to size a buffer.

Every layout trains, as the reference's differentiates: each payload
exchange is an autograd Function whose backward is the all_to_all with
the counts reversed (under ``overlap`` too: each microbatch's exchange
stays in flight over the previous microbatch's GEMMs, and the waited
result enters the graph through ``_Landed``); the replicated layout's sum
of partial outputs has the identity for its backward.  The rank-local
phases are the executor's, whose kernels' backward runs B1 with its
weight read transposed and B7 (``kernels/autograd.py``).
``apply_moe_ep_local`` is the sharded training path's entry: it takes this
rank's own tokens (under sequence parallelism they are already local) and
returns their outputs, with the router losses and the capacity policy's
drops decided over the whole batch (``token_group``).  ``apply_moe_ep`` on
the global x runs under autograd in every layout, every rank getting the
whole gradient of its replicated inputs.  Quantized experts have no
backward and raise there."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dispatch import MoEDispatchConfig
from repro_torch.core.moe_layer import shared_experts
from repro_torch.distributed.group import EPGroup, current_ep_group
from repro_torch.execution import (combine_scale_rows, get_executor,
                                   plan_dispatch)
from repro_torch.quantization import expert_weights, params_scheme
from repro_torch.scheduling import (BlockSchedule, ScheduleStats,
                                    build_schedule, capacity_slots,
                                    expert_capacity, policy_config_kwargs,
                                    round_up)

# Padding-free send buffers are aligned to this row multiple (no per-expert
# block_m rounding: that is the whole point).
_SEND_ALIGN = 8
_I32 = torch.int32


def _needs_grad(params, x) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        isinstance(v, torch.Tensor) and v.requires_grad
        for v in params.values()))


class _Exchange(torch.autograd.Function):
    """The payload all_to_all: chunk i to rank i.  Its backward sends each
    received chunk's gradient back where the chunk came from: the
    all_to_all with the counts reversed (every chunk here has the same
    ``a2a_send_rows`` rows, so the same call)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_to_all(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_to_all(grad.contiguous()), None


def _exchange(t: torch.Tensor, group: EPGroup) -> torch.Tensor:
    return _Exchange.apply(t, group) if t.requires_grad \
        else group.all_to_all(t)


class _Landed(torch.autograd.Function):
    """The result of a payload all_to_all issued earlier (``async_op``),
    waited on here and put in the graph after ``send``, the tensor that
    went out: the forward's exchange stays in flight until the wait, and
    the backward is ``_Exchange``'s, the all_to_all with the counts
    reversed."""

    @staticmethod
    def forward(ctx, send, pending, group):
        ctx.group = group
        return pending.wait()

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_to_all(grad.contiguous()), None, None


class _SumOver(torch.autograd.Function):
    """The sum over the group of each rank's partial output; every rank
    backpropagates the same replicated loss, so each rank's part takes
    that gradient whole: the identity."""

    @staticmethod
    def forward(ctx, t, group):
        return group.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CountOnce(torch.autograd.Function):
    """Identity on a value every rank computes alike from replicated
    inputs that reached it through ``_SumGrad``: their backward sums the
    ranks' gradients, so each rank passes on 1/size of this one's and the
    sum counts it once."""

    @staticmethod
    def forward(ctx, t, size):
        ctx.size = size
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


class _MeanOver(torch.autograd.Function):
    """The mean over the group of a per-rank value every rank then holds;
    each rank backpropagates that replicated mean, so a rank's own value
    gets 1/size of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.size = group.size
        return group.all_reduce(t, "mean")

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


class _SumGrad(torch.autograd.Function):
    """Identity on a replicated tensor that each rank uses on its own part
    of the work: the gradient is the sum of the ranks' parts."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous()), None


class _Split(torch.autograd.Function):
    """Rank r's block of a replicated tensor on ``dim``; the backward
    all-gathers every rank's block gradient, so each rank holds the whole
    gradient of its replicated copy."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        n = t.shape[dim] // group.size
        return t.narrow(dim, group.rank * n, n)

    @staticmethod
    def backward(ctx, grad):
        parts = ctx.group.all_gather(grad.contiguous())
        return torch.cat(parts.unbind(), dim=ctx.dim), None, None


class _Join(torch.autograd.Function):
    """Every rank's block, joined on ``dim`` (the inverse of ``_Split``);
    the backward keeps this rank's block of the replicated gradient."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        parts = group.all_gather(t)
        return torch.cat(parts.unbind(), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // ctx.group.size
        return grad.narrow(ctx.dim, ctx.group.rank * n, n), None, None


def require_phases(cfg: MoEDispatchConfig) -> None:
    """Refuse an executor without phase methods: every EP layout runs
    ``permute`` / ``expert_ffn`` / ``unpermute`` on a rank-local
    schedule, which the schedule-free ``dense`` oracle has not."""
    if not get_executor(cfg.executor).needs_schedule:
        raise ValueError(
            f"executor {cfg.executor!r} has no schedule and no phase "
            "methods, which expert parallelism composes; run EP on a "
            "schedule-capable executor: 'blocks' or 'cuda'")


def _refuse_quant_grad(params, x) -> None:
    """Quantized expert stacks have no backward (nor have the
    reference's int8 leaves): refuse them under autograd in every
    layout."""
    if params_scheme(params) != "none" and _needs_grad(params, x):
        raise NotImplementedError(
            "quantized expert weights have no backward: train dense stacks")


def _resolve_capacity_factor(cfg: MoEDispatchConfig,
                             capacity_factor: Optional[float]) -> float:
    """The resolution order of the EP capacity headroom: an explicit
    ``capacity_factor`` wins; ``None`` takes ``cfg.capacity_factor``."""
    return cfg.capacity_factor if capacity_factor is None else capacity_factor


def a2a_send_rows(n_local_tokens: int, top_k: int, n_experts: int, ep: int,
                  block_m: int, capacity_factor: float, policy: str) -> int:
    """Rows of one destination's send buffer on the padding-free path: the
    worst case (every local assignment to one destination) for the no-drop
    policies, bounded by the destination's post-drop acceptance
    (``E_local * cap_global``) under ``capacity_factor``.  One rank's whole
    payload is ``ep * a2a_send_rows(...)`` rows."""
    F = n_local_tokens * top_k
    C = round_up(max(F, 1), _SEND_ALIGN)
    if policy == "capacity_factor":
        cap_g = expert_capacity(n_local_tokens * ep, top_k, n_experts,
                                block_m, capacity_factor)
        C = min(C, round_up((n_experts // ep) * cap_g, _SEND_ALIGN))
    return C


def a2a_send_rows_static(n_local_tokens: int, top_k: int, n_experts: int,
                         block_m: int, capacity_factor: float) -> int:
    """Total send rows of the legacy static-capacity transport: a
    tile-aligned bucket for every expert, used or not."""
    return n_experts * expert_capacity(n_local_tokens, top_k, n_experts,
                                       block_m, capacity_factor)


def _static_schedule(n_rows: int, n_local_experts: int, block_m: int,
                     rows_per_expert: int, device=None) -> BlockSchedule:
    """The legacy receive layout's schedule: rows grouped by local expert,
    ``rows_per_expert`` each.  An unaligned capacity would misassign
    ``block_expert``, so it raises (round capacity up with ``round_up``)."""
    if rows_per_expert % block_m or n_rows % block_m:
        raise ValueError(
            f"static EP receive layout requires block_m-aligned capacity: "
            f"rows_per_expert={rows_per_expert}, n_rows={n_rows}, "
            f"block_m={block_m}; round capacity up with "
            f"scheduling.round_up before building the layout")
    nb = n_rows // block_m
    offsets = torch.arange(n_local_experts + 1, dtype=_I32,
                           device=device) * rows_per_expert
    return BlockSchedule(
        counts=torch.full((n_local_experts,), rows_per_expert, dtype=_I32,
                          device=device),
        group_offsets=offsets,
        src_tok=torch.zeros((n_rows,), dtype=_I32, device=device),
        pos=torch.zeros((1, 1), dtype=_I32, device=device),
        block_expert=(torch.arange(nb, dtype=_I32, device=device)
                      // (rows_per_expert // block_m)),
        block_active=torch.ones((nb,), dtype=_I32, device=device),
        capacity=n_rows, block_m=block_m, seg_start=offsets[:-1])


def _rank_plan(params, x_loc, cfg: MoEDispatchConfig, group: EPGroup):
    """This rank's routing plan (no schedule) with the router losses
    averaged over the group: one plan per batch, which every layout
    consumes."""
    plan = plan_dispatch(x_loc, params["router"], cfg, with_schedule=False)
    keys = list(plan.aux)
    stacked = torch.stack([plan.aux[k] for k in keys])
    mean = (_MeanOver.apply(stacked, group) if stacked.requires_grad
            else group.all_reduce(stacked, "mean"))
    return plan._replace(aux=dict(zip(keys, mean.unbind())))


def _ep_stats(group: EPGroup, *, kept, dropped, counts_local,
              sched: BlockSchedule) -> dict:
    """``sched/*`` under the single-device key contract: ``kept`` and
    ``dropped`` count this rank's SOURCE assignments, the padding comes
    from its receive schedule, and every total is summed over the group in
    one all_reduce, so each rank returns the same global values."""
    n_active = (sched.block_active != 0).sum(dtype=_I32)
    packed = torch.cat([torch.stack([kept.to(_I32), dropped.to(_I32),
                                     n_active]), counts_local.to(_I32)])
    packed = group.all_reduce(packed)
    useful, dropped, n_active = packed[0], packed[1], packed[2]
    counts_g = packed[3:]
    padded = n_active * sched.block_m
    total = counts_g.sum(dtype=_I32)
    f32 = torch.float32

    def safe(a, b):
        return a.to(f32) / torch.clamp(b, min=1).to(f32)
    st = ScheduleStats(
        useful_rows=useful, dropped_rows=dropped, padded_rows=padded,
        pad_waste=safe(padded, useful),
        drop_fraction=safe(dropped, useful + dropped),
        top1_share=safe(counts_g.max(), total),
        n_blocks_active=n_active, occupancy=safe(useful, padded))
    return {f"sched/{k}": v for k, v in st._asdict().items()}


def _deactivate_sentinel(sched: BlockSchedule,
                         n_local_experts: int) -> BlockSchedule:
    """Turn the sentinel expert's blocks off (the GEMMs write zeros there)
    and give the kernels the real experts' ``seg_start`` only."""
    be = sched.block_expert
    return sched._replace(
        block_active=sched.block_active * (be < n_local_experts).to(_I32),
        block_expert=torch.clamp(be, max=n_local_experts - 1),
        seg_start=(None if sched.seg_start is None
                   else sched.seg_start[:n_local_experts].contiguous()))


def _recv_schedule(e_recv, cfg: MoEDispatchConfig, E_local: int,
                   cap_global: Optional[int]) -> BlockSchedule:
    """The receive side's schedule under the configured policy: E_local
    real experts and one sentinel absorbing transport padding.  Under
    ``capacity_factor`` the bucket is the GLOBAL cap, so the send side's
    drops are final (the policy never drops twice)."""
    kw = policy_config_kwargs(cfg.schedule_policy, cfg)
    if cfg.schedule_policy == "capacity_factor":
        kw["cap"] = cap_global
    sched = build_schedule(e_recv[:, None], E_local + 1, cfg.block_m,
                           policy=cfg.schedule_policy, **kw)
    return _deactivate_sentinel(sched, E_local)


# ----------------------------------------------------------------------
# Padding-free sharded path (token_layout="sharded")
# ----------------------------------------------------------------------
def _capacity_keep(flat, gtok, Tl: int, k: int, E: int, cap_global: int,
                   group: EPGroup):
    """Single-device first-come-first-kept under the capacity policy:
    gather every rank's (expert, global token order) keys, rank slots in
    global token order, keep this rank's verdicts.  ``gtok`` (Tl,) holds
    each local row's global token id, so the drop set does not depend on
    the dim the tokens were split on.  The gather is O(T k) int32."""
    F, ep, r = Tl * k, group.size, group.rank
    dev = flat.device
    if gtok is None:
        gtok = r * Tl + torch.arange(Tl, dtype=_I32, device=dev)
    gkey = (gtok.to(_I32)[:, None] * k
            + torch.arange(k, dtype=_I32, device=dev)[None, :]).reshape(-1)
    both = group.all_gather(torch.stack([flat.to(_I32), gkey]))  # (ep, 2, F)
    fa = both[:, 0].reshape(-1)
    perm = torch.argsort(both[:, 1].reshape(-1))   # keys are distinct
    slot_sorted, _ = capacity_slots(fa[perm], E)
    keep_all = torch.zeros((ep * F,), dtype=torch.bool, device=dev)
    keep_all[perm] = slot_sorted < cap_global
    return keep_all[r * F:(r + 1) * F]


def _sharded_send_phase(x_loc, cfg: MoEDispatchConfig, ep: int, plan, keep,
                        cap_global: Optional[int]):
    """Compact this rank's KEPT assignments into per-destination send
    chunks (token-major inside a chunk).  Returns (send (ep, C, d), e_send
    (ep, C) int32 local expert ids, ``E_local`` marking transport padding,
    state for the compute and combine phases)."""
    E, k = cfg.n_experts, cfg.top_k
    E_local = E // ep
    Tl, d = x_loc.shape
    F = Tl * k
    dev = x_loc.device

    flat = plan.indices.reshape(-1).to(_I32)                 # (F,) global e
    _, counts_local = capacity_slots(flat, E)
    C = round_up(max(F, 1), _SEND_ALIGN)
    if cap_global is not None:
        C = min(C, round_up(E_local * cap_global, _SEND_ALIGN))
    dkey = torch.where(keep, flat // E_local,
                       torch.full_like(flat, ep))            # drops -> bin ep
    send_slot, _ = capacity_slots(dkey, ep + 1)
    tkeep = keep & (send_slot < C)
    send_pos = dkey * C + send_slot                          # row in send buf
    # the reference's drop-mode scatter: rows not sent land in one overflow
    # row past the buffer, then cut off
    oob = torch.where(tkeep, send_pos,
                      torch.full_like(send_pos, ep * C)).long()
    src_rows = torch.arange(Tl, device=dev).repeat_interleave(k)
    send = torch.zeros((ep * C + 1, d), dtype=x_loc.dtype, device=dev)
    send.index_copy_(0, oob, x_loc[src_rows])
    e_send = torch.full((ep * C + 1,), E_local, dtype=_I32, device=dev)
    e_send.index_copy_(0, oob, flat % E_local)
    state = dict(plan=plan, tkeep=tkeep, send_pos=send_pos,
                 counts_local=counts_local, cap_global=cap_global,
                 C=C, ep=ep, E_local=E_local, Tl=Tl, k=k, d=d)
    return (send[:ep * C].reshape(ep, C, d), e_send[:ep * C].reshape(ep, C),
            state)


def _sharded_compute_phase(recv, e_recv, cfg: MoEDispatchConfig, state):
    """Receive half: the policy's schedule over the received rows (and the
    sentinel), then the executor's phases on this rank's experts."""
    ex = get_executor(cfg.executor)
    d, E_local = state["d"], state["E_local"]
    rows = recv.reshape(-1, d)
    sched = _recv_schedule(e_recv.reshape(-1), cfg, E_local,
                           state["cap_global"])
    local_w = ex.prepare_weights(expert_weights(state["params"], rows.dtype),
                                 cfg)
    xp = ex.permute(rows, sched, cfg)
    y = ex.expert_ffn(xp, local_w, sched, cfg)
    y_rows = ex.unpermute(y, sched, None, cfg)                # (ep*C, d)
    return y_rows.reshape(state["ep"], state["C"], d), sched


def _sharded_combine_phase(back, state):
    """Source-side weighted combine of the returned expert rows, in fp32."""
    ep, C, Tl, k, d = (state["ep"], state["C"], state["Tl"], state["k"],
                       state["d"])
    y = back.reshape(ep * C, d)
    gathered = y[torch.clamp(state["send_pos"], max=ep * C - 1).long()]
    w_eff = torch.where(state["tkeep"], state["plan"].weights.reshape(-1),
                        torch.zeros((), device=y.device))
    return (gathered.reshape(Tl, k, d).float()
            * w_eff.reshape(Tl, k, 1)).sum(dim=1)


def _ep_sharded_local(params, x_loc, cfg: MoEDispatchConfig, group: EPGroup,
                      capacity_factor: float, n_micro: int = 1, gtok=None,
                      token_group: Optional[EPGroup] = None):
    """Per-rank body of ``token_layout='sharded'``.  x_loc: (T_local, d).

    ``token_group`` (default: the EP group) holds every rank whose tokens
    make up the batch: the capacity policy's buckets are sized over its
    token count and its drops ranked over its tokens in global order
    (``gtok``).  Given, the router losses are those of that whole batch
    (``router_aux_losses``); without it they are the EP group's mean of
    per-rank losses, as the reference's EP layer takes them.

    ``n_micro > 1`` pipelines the dispatch: microbatch i+1's all_to_alls
    are issued (``async_op``) before microbatch i's GEMMs and waited on
    just before its own compute, so the transport can overlap the expert
    compute (X-MoE double buffering); under autograd each waited payload
    enters the graph through ``_Landed``.  ``n_micro == 1`` is the
    straight line send -> all_to_all -> compute -> all_to_all -> combine.
    The capacity policy's drop set is decided over the whole batch before
    chunking, so the pipelined path keeps the same drops and gradients.
    Without ``token_group`` each microbatch is routed on its own and the
    router losses are the microbatches' mean, as the reference's; with it
    one plan routes the whole batch and its losses are the whole batch's,
    so a pipelined training step takes the same losses as a straight
    one."""
    ep = group.size
    E, k, M = cfg.n_experts, cfg.top_k, cfg.block_m
    if E % ep:
        raise ValueError(f"n_experts={E} must divide over EP group size {ep}")
    Tl = x_loc.shape[0]
    while Tl % n_micro:
        n_micro -= 1                       # largest divisor <= requested
    c = Tl // n_micro
    chunks = [x_loc[i * c:(i + 1) * c] for i in range(n_micro)]
    whole = None
    if token_group is None:
        plans = [_rank_plan(params, ch, cfg, group) for ch in chunks]
        token_group = group
    else:
        whole = plan_dispatch(x_loc, params["router"], cfg,
                              with_schedule=False, aux_group=token_group)
        plans = [whole._replace(indices=whole.indices[i * c:(i + 1) * c],
                                weights=whole.weights[i * c:(i + 1) * c])
                 for i in range(n_micro)]

    cap_global = None
    if cfg.schedule_policy == "capacity_factor":
        cap_global = expert_capacity(Tl * token_group.size, k, E, M,
                                     capacity_factor)
        flat_full = torch.cat([p.indices.reshape(-1).to(_I32)
                               for p in plans])
        keep_full = _capacity_keep(flat_full, gtok, Tl, k, E, cap_global,
                                   token_group)
        keeps = [keep_full[i * c * k:(i + 1) * c * k] for i in range(n_micro)]
    else:
        keeps = [torch.ones((c * k,), dtype=torch.bool, device=x_loc.device)
                 for _ in range(n_micro)]

    sends = []
    for i, ch in enumerate(chunks):
        send, e_send, st = _sharded_send_phase(ch, cfg, ep, plans[i],
                                               keeps[i], cap_global)
        st["params"] = params
        sends.append((send, e_send, st))

    def issue(i):
        return (group.all_to_all(sends[i][0].detach(), async_op=True),
                group.all_to_all(sends[i][1], async_op=True))

    outs, auxes = [], []
    recv = None if n_micro > 1 else (_exchange(sends[0][0], group),
                                     group.all_to_all(sends[0][1]))
    nxt = issue(0) if n_micro > 1 else None
    for i in range(n_micro):
        if n_micro > 1:
            cur, nxt = nxt, (issue(i + 1) if i + 1 < n_micro else None)
            recv = (_Landed.apply(sends[i][0], cur[0], group),
                    cur[1].wait())
        st = sends[i][2]
        y, sched = _sharded_compute_phase(recv[0], recv[1], cfg, st)
        back = _exchange(y, group)
        outs.append(_sharded_combine_phase(back, st))
        aux = dict(st["plan"].aux)
        if cfg.emit_stats:
            kept = st["tkeep"].sum(dtype=_I32)
            aux.update(_ep_stats(token_group, kept=kept,
                                 dropped=st["tkeep"].numel() - kept,
                                 counts_local=st["counts_local"],
                                 sched=sched))
        auxes.append(aux)
    out = torch.cat(outs, dim=0) if n_micro > 1 else outs[0]
    aux = _merge_chunk_aux(auxes)
    if whole is not None:
        aux.update(whole.aux)
    return out.to(x_loc.dtype), aux


def _merge_chunk_aux(auxes):
    """Combine per-microbatch aux: additive stats sum, ratios recompute,
    losses average; one chunk passes through untouched."""
    if len(auxes) == 1:
        return auxes[0]
    n = len(auxes)
    out = {}
    add = ("sched/useful_rows", "sched/dropped_rows", "sched/padded_rows",
           "sched/n_blocks_active")
    for key in auxes[0]:
        if key in add:
            out[key] = sum(a[key] for a in auxes)
        elif key == "sched/top1_share":
            out[key] = torch.stack([a[key] for a in auxes]).max()
        elif key.startswith("sched/"):
            continue                        # ratios rebuilt below
        else:
            out[key] = sum(a[key] for a in auxes) / n
    if "sched/useful_rows" in out:
        f32 = torch.float32

        def safe(a, b):
            return a.to(f32) / torch.clamp(b, min=1).to(f32)
        u, dr = out["sched/useful_rows"], out["sched/dropped_rows"]
        out["sched/pad_waste"] = safe(out["sched/padded_rows"], u)
        out["sched/drop_fraction"] = safe(dr, u + dr)
        out["sched/occupancy"] = safe(u, out["sched/padded_rows"])
    return out


# ----------------------------------------------------------------------
# Legacy static-capacity transport (token_layout="sharded_static")
# ----------------------------------------------------------------------
def _ep_sharded_static_local(params, x_loc, cfg: MoEDispatchConfig,
                             group: EPGroup, capacity_factor: float):
    """The pre-padding-free layout, kept for A/B payload measurement: every
    expert gets a static tile-aligned ``cap`` bucket, and assignments past
    it are dropped WHATEVER ``cfg.schedule_policy`` says."""
    ep = group.size
    E, k, M = cfg.n_experts, cfg.top_k, cfg.block_m
    E_local = E // ep
    Tl, d = x_loc.shape
    dev = x_loc.device

    plan = _rank_plan(params, x_loc, cfg, group)
    cap = round_up(expert_capacity(Tl, k, E, M, capacity_factor), M)
    flat = plan.indices.reshape(-1).to(_I32)                 # (Tl*k,)
    slot, counts_local = capacity_slots(flat, E)
    keep = slot < cap
    dest = flat * cap + slot                                 # row in send buf
    src_rows = torch.arange(Tl, device=dev).repeat_interleave(k)
    send = torch.zeros((E * cap + 1, d), dtype=x_loc.dtype, device=dev)
    send.index_copy_(0, torch.where(keep, dest, torch.full_like(
        dest, E * cap)).long(), x_loc[src_rows])
    # (E*cap, d) -> (ep, E_local*cap, d) -> all_to_all -> regrouped
    # (E_local, ep*cap, d): contiguous per local expert, groups of ep*cap
    recv = _exchange(send[:E * cap].reshape(ep, E_local * cap, d), group)
    recv = recv.reshape(ep, E_local, cap, d).transpose(0, 1) \
        .reshape(E_local * ep * cap, d)

    ex = get_executor(cfg.executor)
    sched = _static_schedule(E_local * ep * cap, E_local, M, ep * cap, dev)
    local_w = ex.prepare_weights(expert_weights(params, x_loc.dtype), cfg)
    y = ex.expert_ffn(recv, local_w, sched, cfg)
    y = y.reshape(E_local, ep, cap, d).transpose(0, 1) \
        .reshape(ep, E_local * cap, d)
    y = _exchange(y, group).reshape(E * cap, d)

    gathered = y[torch.clamp(dest, max=E * cap - 1).long()]  # (Tl*k, d)
    w_eff = torch.where(keep, plan.weights.reshape(-1),
                        torch.zeros((), device=dev))
    out = (gathered.reshape(Tl, k, d).float()
           * w_eff.reshape(Tl, k, 1)).sum(dim=1)
    aux = dict(plan.aux)
    if cfg.emit_stats:
        kept = keep.sum(dtype=_I32)
        aux.update(_ep_stats(group, kept=kept, dropped=Tl * k - kept,
                             counts_local=counts_local, sched=sched))
    return out.to(x_loc.dtype), aux


# ----------------------------------------------------------------------
# Replicated path (token_layout="replicated")
# ----------------------------------------------------------------------
def _ep_replicated_local(params, x_loc, cfg: MoEDispatchConfig,
                         group: EPGroup, capacity_factor: float):
    """Per-rank body of ``token_layout='replicated'`` (decode): x_loc is
    every token.  Under autograd x_loc and the router come through
    ``_SumGrad``, the partial outputs' sum is ``_SumOver`` and the router
    losses ``_CountOnce``, so every rank ends with the whole gradient of
    x and of the router, the router losses' counted once."""
    ep = group.size
    E, M = cfg.n_experts, cfg.block_m
    E_local = E // ep
    base = group.rank * E_local

    # every rank routes every token with the same router, so the router
    # losses are the group's already: no mean to take
    plan = plan_dispatch(x_loc, params["router"], cfg, with_schedule=False)
    plan = plan._replace(aux={k: _CountOnce.apply(v, ep)
                              for k, v in plan.aux.items()})
    idx = plan.indices
    mine = (idx >= base) & (idx < base + E_local)
    # assignments of experts this rank does not own -> the sentinel E_local
    idx_local = torch.where(mine, idx - base, torch.full_like(idx, E_local))
    w_masked = torch.where(mine, plan.weights,
                           torch.zeros((), device=idx.device))
    # the configured policy over the local experts and the sentinel, its
    # buckets sized over the GLOBAL expert count so that drops match the
    # single-device policy
    kw = policy_config_kwargs(cfg.schedule_policy, cfg)
    cap = None
    if cfg.schedule_policy == "capacity_factor":
        cap = expert_capacity(x_loc.shape[0], cfg.top_k, E, M,
                              capacity_factor)
        kw["cap"] = cap
    sched = build_schedule(idx_local, E_local + 1, M,
                           policy=cfg.schedule_policy, **kw)
    sched = _deactivate_sentinel(sched, E_local)

    ex = get_executor(cfg.executor)
    xp = ex.permute(x_loc, sched, cfg)
    scale = combine_scale_rows(sched, w_masked)
    local_w = ex.prepare_weights(expert_weights(params, x_loc.dtype), cfg)
    y = ex.expert_ffn(xp, local_w, sched, cfg, row_scale=scale)
    out = ex.unpermute(y, sched, None, cfg)
    out = _SumOver.apply(out.float(), group)
    aux = dict(plan.aux)
    if cfg.emit_stats:
        flat_mine = mine.reshape(-1)
        if cap is not None:
            slot, _ = capacity_slots(idx_local.reshape(-1), E_local + 1)
            dropped = (flat_mine & (slot >= cap)).sum(dtype=_I32)
        else:
            dropped = torch.zeros((), dtype=_I32, device=idx.device)
        kept = flat_mine.sum(dtype=_I32) - dropped
        owned = torch.where(flat_mine, idx_local.reshape(-1).to(_I32) + base,
                            torch.full_like(flat_mine, E, dtype=_I32))
        counts_local = torch.zeros(E + 1, dtype=_I32, device=idx.device) \
            .scatter_add_(0, owned.long(), torch.ones_like(owned))[:E]
        aux.update(_ep_stats(group, kept=kept, dropped=dropped,
                             counts_local=counts_local, sched=sched))
    return out.to(x_loc.dtype), aux


# ----------------------------------------------------------------------
def _token_split(shape, ep: int, token_layout: str):
    """The layout ``apply_moe_ep`` runs for an x of ``shape`` (B, S, d) on
    ``ep`` ranks, and the dim the sharded layouts split: the sequence dim
    when S divides, else the batch dim, else none (replicated)."""
    B, S = shape[0], shape[1]
    if token_layout not in ("sharded", "sharded_static", "replicated"):
        raise ValueError(f"unknown token_layout {token_layout!r}")
    if token_layout == "replicated" or (S % ep and B % ep):
        return "replicated", None
    return token_layout, (1 if S % ep == 0 else 0)


def apply_moe_ep(params, x: torch.Tensor, cfg: MoEDispatchConfig, *,
                 group: Optional[EPGroup] = None,
                 capacity_factor: Optional[float] = None,
                 token_layout: str = "sharded", overlap: int = 0):
    """Distributed MoE layer.  x: (B, S, d), the same on every rank of
    ``group`` (default: the current one, ``use_ep_group``); returns (y,
    aux), the same on every rank.  ``params`` holds this rank's routed
    experts (``E // ep`` of them, ``repro_torch.weights.shard_experts``),
    the whole router and the shared experts.

    ``capacity_factor``: an explicit argument wins, ``None`` takes
    ``cfg.capacity_factor``; it sizes the ``capacity_factor`` policy's
    buckets and the legacy ``sharded_static`` transport.

    The sharded layouts split the tokens on the sequence dim when ``S``
    divides, else on the batch dim (decode rows), else run replicated;
    each rank's output slice is all-gathered.  ``overlap`` (sharded only):
    dispatch microbatches to pipeline; 0 or 1 is the straight line.

    ``cfg.executor`` must be a schedule-capable backend with phase
    methods, ``blocks`` or ``cuda`` (``require_phases``); the ``dense``
    oracle raises.  The shared experts run outside the exchange, on every
    token.

    Under autograd, in every layout and ``overlap``, every rank
    backpropagates the same replicated loss, and each gets the whole
    gradient of x and of the router (the slice's backward gathers, the
    router's sums over the group) and its own experts' gradients; the
    router losses' gradient counts once.  The ragged fallback trains as
    ``replicated``.  Quantized experts raise there."""
    require_phases(cfg)
    capacity_factor = _resolve_capacity_factor(cfg, capacity_factor)
    group = group or current_ep_group()
    if x.dim() != 3:
        raise ValueError(f"apply_moe_ep takes x (B, S, d), not "
                         f"{tuple(x.shape)}")
    scheme = params_scheme(params)
    if not get_executor(cfg.executor).supports_scheme(scheme):
        raise ValueError(f"executor {cfg.executor!r} does not support quant "
                         f"scheme {scheme!r} under EP")
    _refuse_quant_grad(params, x)
    ep, r = group.size, group.rank
    B, S, d = x.shape
    layout, dim = _token_split(x.shape, ep, token_layout)
    grad = _needs_grad(params, x)
    routed = dict(params)
    if grad:
        # every rank uses the replicated router on its own tokens (or its
        # own experts' share of every token), and gets back the whole
        # gradient of the router and of its replicated x
        routed["router"] = _SumGrad.apply(params["router"], group)
    if layout == "replicated":
        x_rep = _SumGrad.apply(x, group) if grad else x
        y, aux = _ep_replicated_local(routed, x_rep.reshape(-1, d), cfg,
                                      group, capacity_factor)
        y = y.reshape(B, S, d)
    else:
        n = x.shape[dim] // ep
        if grad:
            x_loc = _Split.apply(x, dim, group)
        else:
            x_loc = x.narrow(dim, r * n, n)
        B_l, S_l = x_loc.shape[:2]
        # global token ids in the unsharded (b, s) flatten order, so the
        # policy's drops do not depend on the split
        idx = torch.arange(B_l * S_l, dtype=_I32, device=x.device)
        gtok = ((idx // S_l) * (S_l * ep) + r * S_l + idx % S_l if dim == 1
                else r * (B_l * S_l) + idx)
        x2 = x_loc.reshape(-1, d)
        if layout == "sharded":
            y_loc, aux = _ep_sharded_local(routed, x2, cfg, group,
                                           capacity_factor, max(1, overlap),
                                           gtok=gtok)
        else:
            y_loc, aux = _ep_sharded_static_local(routed, x2, cfg, group,
                                                  capacity_factor)
        y_loc = y_loc.reshape(B_l, S_l, d)
        if grad:
            y = _Join.apply(y_loc, dim, group)
        else:
            parts = group.all_gather(y_loc)
            y = torch.cat(parts.unbind(), dim=dim)
    if "shared" in params:
        y_sh = shared_experts(params["shared"], x.reshape(-1, d))
        y = y + y_sh.to(y.dtype).reshape(B, S, d)
    return y, aux


def apply_moe_ep_local(params, x: torch.Tensor, cfg: MoEDispatchConfig, *,
                       gtok: torch.Tensor, group: Optional[EPGroup] = None,
                       token_group: Optional[EPGroup] = None,
                       capacity_factor: Optional[float] = None,
                       overlap: int = 0):
    """The EP MoE layer on this rank's own tokens: x (..., d), returns (y
    of x's shape, aux).  The sharded training path's entry: under sequence
    and data parallelism each rank holds its block of the batch, and
    nothing is gathered or split here.

    ``group`` (default: the current one) exchanges expert rows: ``params``
    holds its rank's ``E // group.size`` routed experts, the whole router
    and the shared experts.  ``token_group`` (default: ``group``) holds
    every rank whose tokens make up the batch, each with the same token
    count; ``gtok`` (T_local,) int gives each local row's id in the whole
    batch's (b, s) flatten order.  Over ``token_group`` the router losses
    are the whole batch's (``router_aux_losses``), the ``capacity_factor``
    policy's buckets are sized over every token and its drops are decided
    in global token order, row for row the single-device policy's;
    ``sched/*`` are sums over ``token_group``.  The padding-free
    ``sharded`` layout; differentiable.  ``overlap``: dispatch
    microbatches to pipeline, as for ``apply_moe_ep``; the router losses
    stay the whole batch's.  ``cfg.executor`` as for ``apply_moe_ep``."""
    require_phases(cfg)
    capacity_factor = _resolve_capacity_factor(cfg, capacity_factor)
    group = group or current_ep_group()
    token_group = token_group or group
    _refuse_quant_grad(params, x)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    y, aux = _ep_sharded_local(params, x2, cfg, group, capacity_factor,
                               max(1, overlap), gtok=gtok.reshape(-1),
                               token_group=token_group)
    if "shared" in params:
        y = y + shared_experts(params["shared"], x2).to(y.dtype)
    return y.reshape(shape), aux
