"""The work lists of the Hopper GEMMs (kernel in ``csrc/expert_tiles.cu``,
launched before their own kernel by the forward's B1 and B2 in bf16, in
every weight format, and by the backward's B7 and B1^T): from a block
schedule,
each expert's run of rows and the tiles over those runs.

* ``runs`` (E, 2) int32: ``[first row, end row)`` of expert e's active
  blocks, from block ``seg_start[e] // block_m`` to the last consecutive
  active block of e; ``[start, start)`` for an expert with none.
* ``tiles`` (n, 3) int32: ``(e, row0, rows)``, the ``tile_rows``-row
  slices of each run in expert order, then ``(-1, row0, rows)`` slices of
  every span of rows that no run covers, in row order (the kernels store
  zeros there).  Every row of the schedule is in exactly one tile and no
  tile spans two experts or two spans; ``n`` is at most
  ``max_tiles(capacity, E, tile_rows)``.

``tile_rows`` is ``TILE_ROWS`` (256) for the backward's B7 and B1^T, which
build their own lists, and the row tile chosen for the forward's B1 and B2
(256 or 128, ``grouped_gemm.TILE_SHAPES``).

The schedule's contract (every ported policy): each expert's active blocks
are one run starting at block ``seg_start[e] // block_m``, and the runs are
disjoint.  Under ``fixed`` and ``dynamic`` the runs tile a prefix of the
schedule and the one uncovered span is the tail; under ``capacity_factor``
the uncovered spans are also each bucket's inactive tail, the empty
buckets and the sentinel block of dropped assignments."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE_ROWS = 256          # hopper_gemm.cuh TILE_ROWS
MAX_EXPERTS = 1024       # one thread of expert_tiles_kernel per expert


def max_tiles(capacity: int, n_experts: int,
              tile_rows: int = TILE_ROWS) -> int:
    """The most tiles a schedule of ``capacity`` rows can give
    (hopper_gemm.cuh ``max_tiles``): the runs and the uncovered spans are
    at most 2E + 1 disjoint spans of ``capacity`` rows, and n spans take at
    most ``ceil(capacity / tile_rows) + n - 1`` tiles."""
    return -(-capacity // tile_rows) + 2 * n_experts


def expert_tiles_plain(seg_start: torch.Tensor, block_expert: torch.Tensor,
                       block_active: torch.Tensor, *, block_m: int,
                       capacity: int, tile_rows: int = TILE_ROWS):
    """(runs (E, 2), tiles (n, 3)) int32, as the kernel builds them."""
    E, nb = seg_start.numel(), block_expert.numel()
    be = block_expert.long()
    act = block_active != 0
    nxt_act = torch.cat([act[1:], act.new_zeros(1)])
    nxt_be = torch.cat([be[1:], be.new_full((1,), -1)])
    last = act & ~(nxt_act & (nxt_be == be))
    idx = torch.arange(nb, device=be.device)
    ends = torch.full((E,), -1, dtype=torch.long, device=be.device)
    ends[be[last]] = (idx[last] + 1) * block_m
    b0 = seg_start.long() // block_m
    start = b0 * block_m
    b0c = b0.clamp(0, max(nb - 1, 0))
    ok = (b0 >= 0) & (b0 < nb) & (ends > start)
    if nb:
        ok &= act[b0c] & (be[b0c] == torch.arange(E, device=be.device))
    end = torch.where(ok, ends, start)
    runs = torch.stack([start, end], 1).to(torch.int32)
    tiles = []
    for e, (s, t) in enumerate(runs.tolist()):
        tiles += [(e, r, min(tile_rows, t - r))
                  for r in range(s, t, tile_rows)]
    # the spans no run covers: the gaps between the runs in row order
    lo = 0
    for s, t in sorted((s, t) for s, t in runs.tolist() if t > s) \
            + [(capacity, capacity)]:
        tiles += [(-1, r, min(tile_rows, s - r))
                  for r in range(lo, s, tile_rows)]
        lo = t
    tiles = tiles[:max_tiles(capacity, E, tile_rows)]   # the kernel's clamp
    return runs, torch.tensor(tiles, dtype=torch.int32).reshape(-1, 3)


def scratch(capacity: int, n_experts: int, device,
            tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """The kernels' int32 scratch for the lists (hopper_gemm.cuh
    ``work_lists``: the tiles as int4, the runs as int2, the count)."""
    _build.require(0 < n_experts <= MAX_EXPERTS,
                   f"the Hopper GEMMs take 1 to {MAX_EXPERTS} "
                   f"experts, not {n_experts}")
    words = 4 * max_tiles(capacity, n_experts, tile_rows) + 2 * n_experts + 4
    return torch.empty(words, dtype=torch.int32, device=device)


def expert_tiles(seg_start: torch.Tensor, block_expert: torch.Tensor,
                 block_active: torch.Tensor, *, block_m: int, capacity: int,
                 tile_rows: int = TILE_ROWS):
    """CPU tensors run the plain version; CUDA tensors the kernel, whose
    lists are read back (the count on the host: for the tests, never on
    the training path, where the GEMMs read the lists on the device)."""
    if not _build.on_cuda(seg_start, block_expert, block_active):
        return expert_tiles_plain(seg_start, block_expert, block_active,
                                  block_m=block_m, capacity=capacity,
                                  tile_rows=tile_rows)
    E = seg_start.numel()
    nb = capacity // block_m
    for t, n in ((block_expert, nb), (block_active, nb), (seg_start, E)):
        _build.require(t.dtype == torch.int32 and t.shape == (n,)
                       and t.is_contiguous(),
                       f"expert_tiles takes contiguous int32 schedule "
                       f"arrays ({n},)")
    buf = scratch(capacity, E, seg_start.device, tile_rows)
    lib = _build.library()
    err = lib.moe_expert_tiles(seg_start.data_ptr(), block_expert.data_ptr(),
                               block_active.data_ptr(), buf.data_ptr(),
                               capacity, E, block_m,
                               _build.stream_ptr(seg_start.device), tile_rows)
    _build.check(err, "expert_tiles")
    nt = max_tiles(capacity, E, tile_rows)
    count = int(buf[4 * nt + 2 * E])
    runs = buf[4 * nt:4 * nt + 2 * E].reshape(E, 2)
    tiles = buf[:4 * nt].reshape(nt, 4)[:count, :3]
    return runs.clone(), tiles.clone()
