"""``fixed`` policy: the paper's tile-aligned schedule (Algorithm 1), built
on the device (counterpart of ``repro.scheduling.fixed``).

Expert ``e``'s tokens sit at a ``block_m``-aligned base offset, so every
M-tile belongs to exactly one expert, and the static worst-case capacity is

    capacity = round_up(T*k, block_m) + n_experts * block_m

The integers equal the reference's exactly.  Ops that would synchronise
on CUDA are avoided: counts come from ``scatter_add_`` (``torch.bincount``
sizes its output on the host), and the reference's ``mode="drop"`` scatter
writes through an explicit mask into a one-row overflow slot.
"""
from __future__ import annotations

import torch

from repro_torch.scheduling.base import BlockSchedule, register_policy, round_up


def schedule_capacity(n_tokens: int, top_k: int, n_experts: int,
                      block_m: int) -> int:
    return round_up(n_tokens * top_k, block_m) + n_experts * block_m


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0, dtype=torch.int32)])


@register_policy("fixed")
def build_fixed_schedule(indices: torch.Tensor, n_experts: int,
                         block_m: int) -> BlockSchedule:
    """indices: (T, k) expert assignment per token.  All on the device."""
    T, k = indices.shape
    E, M = n_experts, block_m
    dev = indices.device
    capacity = schedule_capacity(T, k, E, M)
    num_blocks = capacity // M
    i32 = torch.int32

    flat = indices.reshape(-1).to(i32)                          # (T*k,)
    sort_idx = torch.argsort(flat, stable=True).to(i32)         # by expert
    counts = torch.zeros(E, dtype=i32, device=dev).scatter_add_(
        0, flat.long(), torch.ones_like(flat))
    padded_counts = (counts + M - 1) // M * M
    padded_starts = _exclusive_cumsum(padded_counts)            # (E+1,)
    unpadded_starts = _exclusive_cumsum(counts)

    ranks = torch.arange(T * k, dtype=i32, device=dev)
    expert_sorted = flat[sort_idx.long()].long()
    dest = (padded_starts[expert_sorted] + ranks
            - unpadded_starts[expert_sorted])                   # (T*k,)

    pos = torch.zeros(T * k, dtype=i32, device=dev).scatter_(
        0, sort_idx.long(), dest).reshape(T, k)
    # drop-scatter: rows at or past capacity go to the overflow slot
    keep = dest < capacity
    slot = torch.where(keep, dest, torch.full_like(dest, capacity)).long()
    src_tok = torch.full((capacity + 1,), -1, dtype=i32, device=dev).scatter_(
        0, slot, sort_idx // k)[:capacity]

    block_starts = torch.arange(num_blocks, dtype=i32, device=dev) * M
    padded_ends = torch.cumsum(padded_counts, 0, dtype=i32)     # (E,)
    block_expert = torch.searchsorted(padded_ends, block_starts,
                                      right=True).to(i32)
    block_active = (block_starts < padded_ends[-1]).to(i32)
    block_expert = torch.clamp(block_expert, max=E - 1)

    return BlockSchedule(
        counts=counts,
        group_offsets=padded_starts,
        src_tok=src_tok,
        pos=pos,
        block_expert=block_expert,
        block_active=block_active,
        capacity=capacity,
        block_m=M,
        seg_start=padded_starts[:-1],
    )
