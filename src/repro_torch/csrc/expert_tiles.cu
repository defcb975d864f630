// The work lists of the Hopper GEMMs (hopper_gemm.cuh), built on the device
// from the block schedule, so that no host sync is needed:
//
//   runs[e]  = [first row, end row) of expert e's active schedule blocks;
//   tiles[i] = (e, row0, rows): the tile_rows-row slices of each expert's
//              run, in expert order, then (-1, row0, rows) slices of every
//              span of rows that no run covers, in row order (the kernels
//              write zeros there);
//   count    = the number of tiles.
//
// B7 reads the runs (each dW tile reduces its expert's run); B1^T and the
// forward's B1 and B2 walk the tiles (each output tile covers at most
// tile_rows rows of one expert: 256 for B1^T, 256 or 128 as the caller of
// B1 and B2 chose), so on the dynamic policy's 8-row blocks a heavy
// expert's weights are read once per tile, not once per 8-row block.
//
// The schedule's contract (every ported policy): each expert's active
// blocks are one contiguous run starting at block seg_start[e] / block_m.
// A block is the last of its expert's run when the next block is inactive
// or belongs to another expert; an expert whose first block is inactive or
// another expert's has no rows.  The runs are disjoint.  Under fixed and
// dynamic they tile a prefix of the schedule, so the only uncovered span
// is the tail past the last active block; under capacity_factor each
// bucket's inactive tail, each empty bucket and the sentinel block for
// dropped assignments are uncovered spans too.  The uncovered spans are
// the gaps between the runs taken in row order: before the first, between
// two neighbours, and past the last.
//
// One thread block of 1024 threads does it all: a pass over the blocks for
// the runs' ends, a scan of the per-expert tile counts, each run's rank by
// first row (a warp an expert, a lane a rival), a scan of the gaps' tile
// counts, and the tiles written in parallel (each finds its run or gap by
// binary search over a scan).
//
// max_tiles (hopper_gemm.cuh): the runs and the gaps are at most 2E + 1
// disjoint spans of `capacity` rows in all, and n spans of a_i rows take
// sum ceil(a_i / R) <= ceil(capacity / R) + n - 1 tiles of R = tile_rows
// rows, so at most ceil(capacity / R) + 2E.  The kernel never writes past that bound, and
// the count is clamped to it (a schedule that breaks the contract gets a
// short list, never an out-of-bounds write).
//
// plain version: repro_torch/kernels/expert_tiles.py, expert_tiles_plain.
#include "hopper_gemm.cuh"

namespace hopper {

constexpr int TILE_THREADS = 1024;

// the inclusive sum of v over the block's 1024 threads (32 warps); the
// block's total in *total.  Every thread must call it.
__device__ __forceinline__ int block_inclusive_sum(int v, int* s_warp,
                                                   int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  v += warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[31];
  __syncthreads();                      // s_warp is free again
  return v;
}

// the last j in [0, n) with off[j] <= i (off ascending, off[0] = 0 <= i)
__device__ __forceinline__ int last_at_or_below(const int* off, int n,
                                                int i) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(TILE_THREADS)
expert_tiles_kernel(const int* __restrict__ seg_start,
                    const int* __restrict__ block_expert,
                    const int* __restrict__ block_active, int n_blocks,
                    int block_m, int n_experts, int capacity,
                    WorkLists lists, int with_tiles, int tile_rows) {
  __shared__ int s_start[MAX_EXPERTS], s_end[MAX_EXPERTS];
  __shared__ int s_off[MAX_EXPERTS + 1];       // run tiles before expert e
  __shared__ int s_lo[MAX_EXPERTS], s_hi[MAX_EXPERTS];   // runs, row order
  __shared__ int s_goff[MAX_EXPERTS + 1];      // zero tiles before gap j
  __shared__ int s_warp[32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int E = n_experts;
  for (int e = tid; e < E; e += TILE_THREADS) s_end[e] = -1;
  __syncthreads();
  // the end row of each expert's run
  for (int b = tid; b < n_blocks; b += TILE_THREADS) {
    if (block_active[b] == 0) continue;
    const int e = block_expert[b];
    const bool next_active = b + 1 < n_blocks && block_active[b + 1] != 0;
    if (!(next_active && block_expert[b + 1] == e) && e >= 0 && e < E)
      s_end[e] = (b + 1) * block_m;
  }
  __syncthreads();
  int n = 0;                                   // this expert's tile count
  if (tid < E) {
    const int b0 = seg_start[tid] / block_m;
    const int start = b0 * block_m;
    const bool ok = b0 >= 0 && b0 < n_blocks && block_active[b0] != 0
                    && block_expert[b0] == tid && s_end[tid] > start;
    const int end = ok ? s_end[tid] : start;
    lists.runs[tid] = make_int2(start, end);
    s_start[tid] = start;
    s_end[tid] = end;
    n = (end - start + tile_rows - 1) / tile_rows;
  }
  if (!with_tiles) return;
  int total;
  const int v = block_inclusive_sum(n, s_warp, &total);
  if (tid < E) s_off[tid + 1] = v;
  if (tid == 0) s_off[0] = 0;
  // each non-empty run's rank among the non-empty runs by first row (the
  // runs are disjoint, so no two non-empty ones share a first row)
  for (int e = warp; e < E; e += TILE_THREADS / 32) {
    if (s_end[e] <= s_start[e]) continue;      // uniform over the warp
    int c = 0;
    for (int f = lane; f < E; f += 32)
      c += s_end[f] > s_start[f] && s_start[f] < s_start[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (lane == 0) {
      s_lo[c] = s_start[e];
      s_hi[c] = s_end[e];
    }
  }
  const int R = __syncthreads_count(tid < E && s_end[tid] > s_start[tid]);
  // gap j < R: the rows before run j, from the end of run j - 1 (or row 0)
  int gn = 0;
  if (tid < R) {
    const int lo = tid > 0 ? s_hi[tid - 1] : 0;
    gn = s_lo[tid] > lo ? (s_lo[tid] - lo + tile_rows - 1) / tile_rows : 0;
  }
  int inner;
  const int gv = block_inclusive_sum(gn, s_warp, &inner);
  if (tid < R) s_goff[tid + 1] = gv;
  if (tid == 0) s_goff[0] = 0;
  __syncthreads();
  const int most = max_tiles(capacity, E, tile_rows);
  for (int i = tid; i < total && i < most; i += TILE_THREADS) {
    const int e = last_at_or_below(s_off, E, i);
    const int row0 = s_start[e] + (i - s_off[e]) * tile_rows;
    lists.tiles[i] = make_int4(e, row0, min(tile_rows, s_end[e] - row0), 0);
  }
  for (int i = tid; i < inner && total + i < most; i += TILE_THREADS) {
    const int j = last_at_or_below(s_goff, R, i);
    const int row0 = (j > 0 ? s_hi[j - 1] : 0) + (i - s_goff[j]) * tile_rows;
    lists.tiles[total + i] =
        make_int4(-1, row0, min(tile_rows, s_lo[j] - row0), 0);
  }
  // the tail: the rows past the last run
  const int tail = R > 0 ? s_hi[R - 1] : 0;
  const int n_tail =
      capacity > tail ? (capacity - tail + tile_rows - 1) / tile_rows : 0;
  for (int z = tid; z < n_tail && total + inner + z < most;
       z += TILE_THREADS) {
    const int row0 = tail + z * tile_rows;
    lists.tiles[total + inner + z] =
        make_int4(-1, row0, min(tile_rows, capacity - row0), 0);
  }
  if (tid == 0) *lists.count = min(total + inner + n_tail, most);
}

int launch_expert_tiles(const int* seg_start, const int* block_expert,
                        const int* block_active, int n_blocks, int block_m,
                        int n_experts, int capacity, WorkLists lists,
                        bool with_tiles, cudaStream_t stream,
                        int tile_rows) {
  if (n_experts <= 0 || n_experts > MAX_EXPERTS || block_m <= 0
      || tile_rows <= 0 || tile_rows % 8 != 0)
    return (int)cudaErrorInvalidValue;
  expert_tiles_kernel<<<1, TILE_THREADS, 0, stream>>>(
      seg_start, block_expert, block_active, n_blocks, block_m, n_experts,
      capacity, lists, with_tiles ? 1 : 0, tile_rows);
  return moe_last_error();
}

}  // namespace hopper

// The work lists alone (for the tests: held against expert_tiles_plain):
// the schedule's (E,) seg_start and (capacity / block_m,) block arrays ->
// scratch, laid out as hopper_gemm.cuh's work_lists says for tiles of at
// most tile_rows rows.
MOE_API int moe_expert_tiles(const void* seg_start, const void* block_expert,
                             const void* block_active, void* scratch,
                             int capacity, int n_experts, int block_m,
                             void* stream, int tile_rows) {
  if (block_m <= 0 || capacity % block_m != 0)
    return (int)cudaErrorInvalidValue;
  return hopper::launch_expert_tiles(
      (const int*)seg_start, (const int*)block_expert,
      (const int*)block_active, capacity / block_m, block_m, n_experts,
      capacity, hopper::work_lists(scratch, capacity, n_experts, tile_rows),
      true, (cudaStream_t)stream, tile_rows);
}
