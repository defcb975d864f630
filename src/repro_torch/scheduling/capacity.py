"""``capacity_factor`` policy: bounded per-expert capacity with overflow
drops, GShard-style (counterpart of ``repro.scheduling.capacity``).

Every expert gets a static tile-aligned bucket of

    cap = round_up(max(1, int(T * k * capacity_factor / E)), block_m)

rows; assignments beyond an expert's bucket are dropped first-come-first-
kept (stable in token order).  A dropped assignment's ``pos`` points at
the sentinel block ``[E * cap, E * cap + block_m)``, which is never
active, so it adds exactly zero to the layer output and the token passes
through on the residual.  The capacity envelope ``E * cap + block_m`` does
not depend on the routing.

Only a prefix of each bucket is active, and an expert with no tokens owns
a whole inactive bucket: unlike ``fixed`` and ``dynamic``, the inactive
blocks are not a suffix of the schedule (the Hopper GEMMs' work lists give
each such span a zero tile, ``kernels/expert_tiles.py``).

The integers equal the reference's exactly.  Nothing here synchronises the
host with the card: counts come from ``scatter_add_`` (``torch.bincount``
sizes its output on the host), and the reference's ``mode="drop"`` scatter
writes through a one-row overflow slot.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.scheduling.base import (BlockSchedule, register_policy,
                                         round_up)
from repro_torch.scheduling.fixed import _exclusive_cumsum


def expert_capacity(n_tokens: int, top_k: int, n_experts: int, block_m: int,
                    capacity_factor: float) -> int:
    """Static tile-aligned per-expert row budget (shared with the EP
    path)."""
    return round_up(max(1, int(n_tokens * top_k * capacity_factor
                               / n_experts)), block_m)


def capacity_slots(flat: torch.Tensor, n_experts: int):
    """Rank of each expanded assignment within its expert, stable in token
    order.  flat: (T*k,) int -> (slot (T*k,) int32, counts (E,) int32).
    ``slot < cap`` is the keep mask under a bucket of ``cap`` rows."""
    i32 = torch.int32
    flat = flat.to(i32)
    n, dev = flat.numel(), flat.device
    sort_idx = torch.argsort(flat, stable=True).long()
    counts = torch.zeros(n_experts, dtype=i32, device=dev).scatter_add_(
        0, flat.long(), torch.ones_like(flat))
    starts = _exclusive_cumsum(counts)
    ranks = torch.arange(n, dtype=i32, device=dev)
    slot_sorted = ranks - starts[flat[sort_idx].long()]
    slot = torch.zeros(n, dtype=i32, device=dev).scatter_(0, sort_idx,
                                                          slot_sorted)
    return slot, counts


@register_policy("capacity_factor", config_fields=("capacity_factor",))
def build_capacity_schedule(indices: torch.Tensor, n_experts: int,
                            block_m: int, *, capacity_factor: float = 2.0,
                            cap: Optional[int] = None) -> BlockSchedule:
    """indices: (T, k) expert assignment per token.  ``cap`` overrides the
    derived per-expert bucket (the EP path sizes it over the global expert
    count).  All on the device."""
    T, k = indices.shape
    E, M = n_experts, block_m
    if cap is None:
        cap = expert_capacity(T, k, E, M, capacity_factor)
    capacity = E * cap + M              # + one sentinel block for drops
    num_blocks = capacity // M
    bpe = cap // M                      # blocks per expert bucket
    dev = indices.device
    i32 = torch.int32

    flat = indices.reshape(-1).to(i32)
    slot, counts = capacity_slots(flat, E)
    keep = slot < cap
    dest = torch.where(keep, flat * cap + slot,
                       torch.full_like(flat, E * cap))   # drops -> sentinel
    pos = dest.reshape(T, k)

    # drop-scatter: dropped rows go to the overflow slot ``capacity``
    src_rows = torch.arange(T * k, dtype=i32, device=dev) // k
    slot_row = torch.where(keep, dest, torch.full_like(dest, capacity))
    src_tok = torch.full((capacity + 1,), -1, dtype=i32, device=dev).scatter_(
        0, slot_row.long(), src_rows)[:capacity]

    bidx = torch.arange(num_blocks, dtype=i32, device=dev)
    block_expert = torch.clamp(bidx // bpe, max=E - 1)
    kept_counts = torch.clamp(counts, max=cap)
    start_in_bucket = bidx * M - block_expert * cap
    block_active = ((bidx < E * bpe)
                    & (start_in_bucket < kept_counts[block_expert.long()])
                    ).to(i32)

    group_offsets = torch.arange(E + 1, dtype=i32, device=dev) * cap
    return BlockSchedule(
        counts=counts,
        group_offsets=group_offsets,
        src_tok=src_tok,
        pos=pos,
        block_expert=block_expert,
        block_active=block_active,
        capacity=capacity,
        block_m=M,
        seg_start=group_offsets[:-1],
    )
