"""``dynamic`` policy: adaptive block-to-expert assignment under routing skew
(counterpart of ``repro.scheduling.dynamic``).

The physical grid runs on sub-blocks of ``q = sub_block(block_m,
block_m_min)`` rows.  Heavy experts (counts >= block_m) pad to full
``block_m`` tiles, light ones to ``q`` rows, and the segments are packed in
decreasing-load order, so the heavy segments come first and start
``block_m``-aligned.  The capacity envelope is the ``fixed`` policy's
static worst case.  At the serving default ``block_m_min=8`` the schedule's
``block_m`` is 8: the CUDA GEMMs take 8-row blocks (csrc/grouped_gemm.cuh).

The integers equal the reference's exactly.  As in ``fixed``, nothing here
synchronises the host with the card: counts come from ``scatter_add_``
(``torch.bincount`` sizes its output on the host) and the reference's
``mode="drop"`` scatter writes through a one-row overflow slot.
"""
from __future__ import annotations

import torch

from repro_torch.scheduling.base import BlockSchedule, register_policy
from repro_torch.scheduling.fixed import _exclusive_cumsum, schedule_capacity


def sub_block(block_m: int, block_m_min: int = 8) -> int:
    """Largest divisor of block_m that is <= block_m_min and a multiple of
    8; block_m itself when there is none.  A block_m_min below 8 counts as
    8."""
    for q in range(max(min(block_m_min, block_m), 8), 7, -1):
        if block_m % q == 0 and q % 8 == 0:
            return q
    return block_m


@register_policy("dynamic", config_fields=("block_m_min",))
def build_dynamic_schedule(indices: torch.Tensor, n_experts: int,
                           block_m: int, *,
                           block_m_min: int = 8) -> BlockSchedule:
    """indices: (T, k) expert assignment per token.  All on the device."""
    T, k = indices.shape
    E, M = n_experts, block_m
    q = sub_block(M, block_m_min)
    dev = indices.device
    capacity = schedule_capacity(T, k, E, M)
    num_blocks = capacity // q
    i32 = torch.int32

    flat = indices.reshape(-1).to(i32)
    sort_idx = torch.argsort(flat, stable=True).to(i32)
    counts = torch.zeros(E, dtype=i32, device=dev).scatter_add_(
        0, flat.long(), torch.ones_like(flat))

    # (1) M-tiles for heavy experts, q-sub-blocks for light ones
    heavy = counts >= M
    padded_counts = torch.where(heavy, (counts + M - 1) // M * M,
                                (counts + q - 1) // q * q).to(i32)

    # (2) segments in decreasing-load order
    order = torch.argsort(-counts, stable=True).to(i32)
    ends_ord = torch.cumsum(padded_counts[order.long()], 0, dtype=i32)
    starts_ord = torch.cat([ends_ord.new_zeros(1), ends_ord])
    seg_start = torch.zeros(E, dtype=i32, device=dev).scatter_(
        0, order.long(), starts_ord[:-1])

    unpadded_starts = _exclusive_cumsum(counts)
    ranks = torch.arange(T * k, dtype=i32, device=dev)
    expert_sorted = flat[sort_idx.long()].long()
    dest = seg_start[expert_sorted] + ranks - unpadded_starts[expert_sorted]

    pos = torch.zeros(T * k, dtype=i32, device=dev).scatter_(
        0, sort_idx.long(), dest).reshape(T, k)
    slot = torch.where(dest < capacity, dest,
                       torch.full_like(dest, capacity)).long()
    src_tok = torch.full((capacity + 1,), -1, dtype=i32, device=dev).scatter_(
        0, slot, sort_idx // k)[:capacity]

    block_starts = torch.arange(num_blocks, dtype=i32, device=dev) * q
    pos_in_order = torch.searchsorted(ends_ord, block_starts, right=True)
    block_expert = order[torch.clamp(pos_in_order, max=E - 1)]
    block_active = (block_starts < ends_ord[-1]).to(i32)

    return BlockSchedule(
        counts=counts,
        group_offsets=starts_ord,      # packing order; per expert: seg_start
        src_tok=src_tok,
        pos=pos,
        block_expert=block_expert,
        block_active=block_active,
        capacity=capacity,
        block_m=q,
        seg_start=seg_start,
    )
