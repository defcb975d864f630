// The work lists of the Hopper GEMMs (hopper_gemm.cuh), built on the device
// from the block schedule, so that no host sync is needed:
//
//   runs[e]  = [first row, end row) of expert e's active schedule blocks;
//   tiles[i] = (e, row0, rows): the TILE_ROWS-row slices of each expert's
//              run, in expert order, then (-1, row0, rows) slices of the
//              rows past the active blocks (the kernels write zeros there);
//   count    = the number of tiles.
//
// B7 reads the runs (each dW tile reduces its expert's run); B1^T and the
// forward's B1 and B2 walk the tiles (each output tile covers at most 256
// rows of one expert), so on the dynamic policy's 8-row blocks a heavy
// expert's weights are read once per 256 rows, not once per 8-row block.
//
// The schedule's contract (both ported policies): the active blocks are a
// prefix of the schedule, and each expert's active blocks are one
// contiguous run starting at block seg_start[e] / block_m.  A block is the
// last of its expert's run when the next block is inactive or belongs to
// another expert; an expert whose first block is inactive or another
// expert's has no rows (as the previous kernel's walk from seg_start[e]
// found).  One thread block of 1024 threads does it all: a pass over the
// blocks, a scan of the per-expert tile counts, and the tiles written in
// parallel (each finds its expert by binary search over the scan).
//
// plain version: repro_torch/kernels/expert_tiles.py, expert_tiles_plain.
#include "hopper_gemm.cuh"

namespace hopper {

constexpr int TILE_THREADS = 1024;

__global__ void __launch_bounds__(TILE_THREADS)
expert_tiles_kernel(const int* __restrict__ seg_start,
                    const int* __restrict__ block_expert,
                    const int* __restrict__ block_active, int n_blocks,
                    int block_m, int n_experts, int capacity,
                    WorkLists lists, int with_tiles) {
  __shared__ int s_start[MAX_EXPERTS], s_end[MAX_EXPERTS];
  __shared__ int s_off[MAX_EXPERTS + 1];
  __shared__ int s_warp[32];
  __shared__ int s_active_end;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int E = n_experts;
  for (int e = tid; e < E; e += TILE_THREADS) s_end[e] = -1;
  if (tid == 0) s_active_end = 0;
  __syncthreads();
  // the end row of each expert's run, and of the active prefix
  for (int b = tid; b < n_blocks; b += TILE_THREADS) {
    if (block_active[b] == 0) continue;
    const int e = block_expert[b];
    const bool next_active = b + 1 < n_blocks && block_active[b + 1] != 0;
    if (!(next_active && block_expert[b + 1] == e) && e >= 0 && e < E)
      s_end[e] = (b + 1) * block_m;
    if (!next_active) atomicMax(&s_active_end, (b + 1) * block_m);
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
    n = (end - start + TILE_ROWS - 1) / TILE_ROWS;
  }
  if (!with_tiles) return;
  // inclusive scan of the counts: within each warp, then over the warps
  int v = n;
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
  if (tid < E) s_off[tid + 1] = v + (warp > 0 ? s_warp[warp - 1] : 0);
  if (tid == 0) s_off[0] = 0;
  __syncthreads();
  const int total = s_off[E];
  const int active_end = s_active_end;
  for (int i = tid; i < total; i += TILE_THREADS) {
    int lo = 0, hi = E - 1;                    // the last e with off <= i
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (s_off[mid] <= i) lo = mid; else hi = mid - 1;
    }
    const int row0 = s_start[lo] + (i - s_off[lo]) * TILE_ROWS;
    lists.tiles[i] =
        make_int4(lo, row0, min(TILE_ROWS, s_end[lo] - row0), 0);
  }
  const int n_zero = (capacity - active_end + TILE_ROWS - 1) / TILE_ROWS;
  for (int z = tid; z < n_zero; z += TILE_THREADS) {
    const int row0 = active_end + z * TILE_ROWS;
    lists.tiles[total + z] =
        make_int4(-1, row0, min(TILE_ROWS, capacity - row0), 0);
  }
  if (tid == 0) *lists.count = total + n_zero;
}

int launch_expert_tiles(const int* seg_start, const int* block_expert,
                        const int* block_active, int n_blocks, int block_m,
                        int n_experts, int capacity, WorkLists lists,
                        bool with_tiles, cudaStream_t stream) {
  if (n_experts <= 0 || n_experts > MAX_EXPERTS || block_m <= 0)
    return (int)cudaErrorInvalidValue;
  expert_tiles_kernel<<<1, TILE_THREADS, 0, stream>>>(
      seg_start, block_expert, block_active, n_blocks, block_m, n_experts,
      capacity, lists, with_tiles ? 1 : 0);
  return moe_last_error();
}

}  // namespace hopper

// The work lists alone (for the tests: held against expert_tiles_plain):
// the schedule's (E,) seg_start and (capacity / block_m,) block arrays ->
// scratch, laid out as hopper_gemm.cuh's work_lists says.
MOE_API int moe_expert_tiles(const void* seg_start, const void* block_expert,
                             const void* block_active, void* scratch,
                             int capacity, int n_experts, int block_m,
                             void* stream) {
  if (block_m <= 0 || capacity % block_m != 0)
    return (int)cudaErrorInvalidValue;
  return hopper::launch_expert_tiles(
      (const int*)seg_start, (const int*)block_expert,
      (const int*)block_active, capacity / block_m, block_m, n_experts,
      capacity, hopper::work_lists(scratch, capacity, n_experts), true,
      (cudaStream_t)stream);
}
