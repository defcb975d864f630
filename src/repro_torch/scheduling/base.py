"""Schedule-policy layer: the ``BlockSchedule`` contract and the policy
registry (counterpart of ``repro.scheduling.base``).

Every policy is a function ``(indices, n_experts, block_m, **kw) ->
BlockSchedule`` built from device tensor ops only: no ``.item()``, no
``.nonzero()``, no boolean-mask indexing, so building a schedule never
synchronises the host with the card.

  - uniform physical block size ``block_m``;
  - every block is owned by exactly one expert (``block_expert``), inactive
    blocks carry only padding (``block_active``);
  - ``src_tok == -1`` marks padding rows; ``pos`` maps each expanded token
    (t, j) to its padded row.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class BlockSchedule(NamedTuple):
    """Everything the dispatch pipeline needs, all int32 device tensors.

    With T = tokens, k = top_k, E = experts, M = block size: ``capacity`` is
    a static row budget (a Python int) and num_blocks = capacity // M."""

    counts: torch.Tensor          # (E,) tokens routed to each expert
    group_offsets: torch.Tensor   # (E+1,) padded segment starts
    src_tok: torch.Tensor         # (capacity,) source token row, -1 = padding
    pos: torch.Tensor             # (T, k) padded row of expanded token (t, j)
    block_expert: torch.Tensor    # (num_blocks,) owning expert (clamped)
    block_active: torch.Tensor    # (num_blocks,) 1 = block has real rows
    capacity: int
    block_m: int
    seg_start: Optional[torch.Tensor] = None   # (E,) per-expert base row


class ScheduleStats(NamedTuple):
    """Per-schedule telemetry, every field a 0-d device tensor (counterpart
    of ``repro.scheduling.base.ScheduleStats``)."""

    useful_rows: torch.Tensor     # kept (non-dropped) expanded tokens
    dropped_rows: torch.Tensor    # assignments dropped by bounded capacity
    padded_rows: torch.Tensor     # rows covered by ACTIVE blocks
    pad_waste: torch.Tensor       # padded_rows / useful_rows
    drop_fraction: torch.Tensor   # dropped / (T*k)
    top1_share: torch.Tensor      # heaviest expert's share of raw routing
    n_blocks_active: torch.Tensor
    occupancy: torch.Tensor       # useful_rows / padded_rows


def schedule_stats(sched: BlockSchedule) -> ScheduleStats:
    """Telemetry from any policy's schedule: tensor ops on the device, no
    host read."""
    i32, f32 = torch.int32, torch.float32
    n_assign = sched.pos.numel()
    useful = (sched.src_tok >= 0).sum(dtype=i32)
    dropped = n_assign - useful
    n_active = (sched.block_active != 0).sum(dtype=i32)
    padded = n_active * sched.block_m
    total = sched.counts.sum(dtype=i32)

    def safe(a, b):
        if not isinstance(b, torch.Tensor):
            return a.to(f32) / float(max(b, 1))
        return a.to(f32) / torch.clamp(b, min=1).to(f32)
    return ScheduleStats(
        useful_rows=useful,
        dropped_rows=dropped,
        padded_rows=padded,
        pad_waste=safe(padded, useful),
        drop_fraction=safe(dropped, n_assign),
        top1_share=safe(sched.counts.max(), total),
        n_blocks_active=n_active,
        occupancy=safe(useful, padded),
    )


# The head-to-head sweep, (policy name, build kwargs), as the reference's
DEFAULT_POLICY_SWEEP = (
    ("fixed", {}),
    ("capacity_factor", {"capacity_factor": 1.25}),
    ("dynamic", {}),
)


PolicyFn = Callable[..., BlockSchedule]

_POLICIES: Dict[str, PolicyFn] = {}
_POLICY_CONFIG_FIELDS: Dict[str, tuple] = {}


def register_policy(name: str, *, config_fields: tuple = ()
                    ) -> Callable[[PolicyFn], PolicyFn]:
    """Register a schedule policy; ``config_fields`` names the dispatch-
    config fields it consumes as build kwargs."""
    def deco(fn: PolicyFn) -> PolicyFn:
        _POLICIES[name] = fn
        _POLICY_CONFIG_FIELDS[name] = tuple(config_fields)
        return fn
    return deco


def policy_config_kwargs(policy: str, cfg) -> dict:
    get_policy(policy)
    return {f: getattr(cfg, f) for f in _POLICY_CONFIG_FIELDS[policy]}


def get_policy(name: str) -> PolicyFn:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown schedule policy {name!r}; "
                         f"available: {available_policies()}") from None


def available_policies():
    return sorted(_POLICIES)


def build_schedule(indices: torch.Tensor, n_experts: int, block_m: int,
                   policy: str = "fixed", **kwargs) -> BlockSchedule:
    """Construct a block schedule under the named policy.
    indices: (T, k) int expert assignment per token."""
    return get_policy(policy)(indices, n_experts, block_m, **kwargs)


def combine_scale_rows(sched: BlockSchedule, weights: torch.Tensor):
    """Scatter the (T, k) combine weights onto padded rows for the fused
    down-projection epilogue; padding rows get 0.  The reference's drop-
    scatter writes rows at or past capacity into an overflow slot here."""
    cap = sched.capacity
    rows = sched.pos.reshape(-1)
    slot = torch.where(rows < cap, rows, torch.full_like(rows, cap)).long()
    scale = torch.zeros(cap + 1, dtype=torch.float32, device=weights.device)
    return scale.scatter_(0, slot, weights.reshape(-1).float())[:cap]
