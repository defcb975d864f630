// The backward's dX product: the block-scheduled grouped GEMM with its
// weight read transposed in place,
//
//   out[rows of expert e] = x[rows] @ W[e]^T,
//
// x (capacity, K), W (E, N, K) as stored for the forward (E, in, out) ->
// (capacity, N), fp32 accumulation, zeros on the rows of inactive blocks.
// Dense only, no epilogue.
//
// Replaces: no TPU kernel of its own; it is src/repro/kernels/
// grouped_gemm.py's grouped_gemm (B1) with W read transposed, the dX that
// the reference's training takes from XLA's transposed product.
//
// What bounds it on the H100: at training's T = 4096 (moonshot: 28,672
// active rows, K x N = 1408 x 2048) the tensor cores: 165 GFLOP, 0.17 ms,
// against 0.17 ms for the bytes (the rows read once, the used experts'
// weights once, the output written once); at deepseek-v2's E = 160 the
// bytes: 2.5 GB of expert weights, 0.93 ms against 0.65 ms of products.
//
// Design (bf16, hopper_gemm.cuh).  The forward's template (grouped_gemm.
// cuh) tiles by schedule block: on the dynamic policy's 8-row blocks a
// heavy expert's whole weight matrix is reread once per 8 rows.  Here the
// work items are tiles over each expert's run of rows instead (from
// expert_tiles.cu, built on the device: no host sync): (expert e, a slice
// of at most 256 rows of e's run, a 128-column tile of the output), walked
// expert-major by the persistent blocks.  A weight tile is read once for
// all the slice's rows, so an expert's weights cross device memory once
// per 256 rows on either policy (deepseek-v2's experts take about 154 rows
// each at T = 4096: once), instead of resting on two blocks' reads
// meeting in L2.  Both operands are K-major, the layout TMA and wgmma take
// natively: A is x's slice (64 K values per stage), B is W[e]'s 128 rows
// of the same 64 K values (a 3-D tensor map over (K, N, E)).  Rows of a
// slice past its run belong to the next expert: they are loaded (or read
// as zeros past the tensor) and computed, but never stored.  The rows past
// the active blocks are zero tiles in the same list: stored as zeros,
// nothing loaded.
//
// fp32: the forward template's CUDA-core fmaf kernel with TRANS (never
// TF32), one thread block per (schedule-block row tile, 64 columns).
#include "grouped_gemm.cuh"
#include "hopper_gemm.cuh"

namespace moe_gemm_t {

using hopper::BK;
using hopper::SUB;
using hopper::TILE_ROWS;
using bf16 = __nv_bfloat16;

// A work item: a tile of up to TILE_ROWS = 256 rows of one expert's run x
// BN = 128 output columns.  Over 128 rows ("full"), each consumer
// warpgroup takes 128 rows with two 64 x 128 accumulators; otherwise each
// takes 64.  A stage holds x's 256 (or 128) rows x 64 K values, then
// W[e]'s BN rows x 64 K values, read once for all the tile's rows.  The
// epilogue stages a warpgroup's 64-row slab at a time.
constexpr int BN = 128;

struct TStage {
  static constexpr int A_BYTES = 4 * SUB;
  static constexpr int B_BYTES = (BN / 64) * SUB;
  static constexpr int BYTES = A_BYTES + B_BYTES;
  static constexpr int EPI_WG = 64 * BN * 2;
  using R = hopper::Ring<BYTES, 2 * EPI_WG>;
};

// One 64-row slab of a warpgroup's output (rows from r0, `rows` of them:
// a whole 64-row box, or the 8-row groups inside the run, as a run ends on
// a multiple of 8); columns past N are clipped by the tensor map
__device__ __forceinline__ void store_slab(const float (&d)[BN / 2],
                                           const CUtensorMap* out64,
                                           const CUtensorMap* out8,
                                           unsigned char* epi, int wg, int n0,
                                           int r0, int rows) {
  using namespace hopper;
  if (rows <= 0) return;                           // uniform in the group
  epilogue_begin(wg);
  stage_tile<bf16>(d, epi);
  epilogue_staged(wg);
  if (threadIdx.x % 128 != 0) return;
  for (int j = 0; j < BN / 64; ++j) {
    const uint32_t src = smem_addr(epi) + j * BOX;
    if (rows >= 64)
      tma_store_2d(out64, src, n0 + 64 * j, r0);
    else
      for (int g = 0; 8 * g < rows; ++g)
        tma_store_2d(out8, src + 1024 * g, n0 + 64 * j, r0 + 8 * g);
  }
  bulk_commit();
}

// The k-loop of one item: NACC = 2 (full) reads A sub-tiles 2 wg and
// 2 wg + 1 into acc0 and acc1, NACC = 1 sub-tile wg into acc0
template <int NACC, int S>
__device__ __forceinline__ void mainloop(float (&acc0)[BN / 2],
                                         float (&acc1)[BN / 2],
                                         hopper::PipeState& p, uint32_t ring,
                                         uint32_t full, uint32_t empty,
                                         int n_k, int wg) {
  using namespace hopper;
  int prev = -1;
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(full + 8 * p.stage, p.phase);
    // K-major: 8-row groups 1 KB apart, each k16 step 32 bytes along the row
    const uint32_t st = ring + p.stage * TStage::BYTES;
    const uint32_t a = st + (NACC == 2 ? 2 * wg : wg) * SUB;
    const uint32_t b = st + TStage::A_BYTES;
    fence_acc(acc0);
    if (NACC == 2) fence_acc(acc1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t db = make_desc(b + 32 * ks, 16, 1024);
      wgmma_m64n128k16<0, 0>(acc0, make_desc(a + 32 * ks, 16, 1024), db);
      if (NACC == 2)
        wgmma_m64n128k16<0, 0>(acc1, make_desc(a + SUB + 32 * ks, 16, 1024),
                               db);
    }
    wgmma_commit();
    wgmma_wait<1>();                     // the previous stage has been read
    fence_acc(acc0);
    if (NACC == 2) fence_acc(acc1);
    if (prev >= 0) mbar_arrive(empty + 8 * prev);
    prev = p.stage;
    p.advance<S>();
  }
  wgmma_wait<0>();
  fence_acc(acc0);
  if (NACC == 2) fence_acc(acc1);
  if (prev >= 0) mbar_arrive(empty + 8 * prev);
}

__global__ void __launch_bounds__(hopper::THREADS, 1)
gemm_t_hopper_kernel(const __grid_constant__ CUtensorMap x256,
                     const __grid_constant__ CUtensorMap x128,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap out64,
                     const __grid_constant__ CUtensorMap out8,
                     const int4* __restrict__ tiles,
                     const int* __restrict__ n_tiles, int K, int N) {
  using namespace hopper;
  constexpr int S = TStage::R::STAGES, STAGE = TStage::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + TStage::R::BAR_OFF, empty = full + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_nt = (N + BN - 1) / BN, n_k = (K + BK - 1) / BK;
  const int items = *n_tiles * n_nt;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                                   // producer
    reg_dealloc<40>();
    if (threadIdx.x != 2 * 128) return;
    tma_prefetch(&x256); tma_prefetch(&x128); tma_prefetch(&wmap);
    PipeState p;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int4 tile = tiles[it / n_nt];
      if (tile.x < 0) continue;                    // a zero tile
      const int n0 = (it % n_nt) * BN;
      const bool two = tile.z > 128;
      const uint32_t bytes = (two ? 4 : 2) * SUB + TStage::B_BYTES;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(empty + 8 * p.stage, p.phase ^ 1u);
        const uint32_t fb = full + 8 * p.stage;
        const uint32_t a = ring + p.stage * STAGE;
        mbar_expect_tx(fb, bytes);
        tma_load_2d(a, two ? &x256 : &x128, fb, kt * BK, tile.y);
        tma_load_3d(a + TStage::A_BYTES, &wmap, fb, kt * BK, n0, tile.x);
        p.advance<S>();
      }
    }
  } else {                                         // consumers
    reg_alloc<232>();
    PipeState p;
    unsigned char* epi = smem + TStage::R::EPI_OFF + wg * TStage::EPI_WG;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int4 tile = tiles[it / n_nt];
      const int n0 = (it % n_nt) * BN;
      const bool two = tile.z > 128;
      float acc0[BN / 2], acc1[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
      if (tile.x >= 0) {
        if (two)
          mainloop<2, S>(acc0, acc1, p, ring, full, empty, n_k, wg);
        else
          mainloop<1, S>(acc0, acc1, p, ring, full, empty, n_k, wg);
      }
      // this warpgroup's rows: 128 w + [0, 128) of the tile, or 64 w + [0, 64)
      const int r0 = (two ? 128 : 64) * wg;
      store_slab(acc0, &out64, &out8, epi, wg, n0, tile.y + r0,
                 min(64, tile.z - r0));
      if (two)
        store_slab(acc1, &out64, &out8, epi, wg, n0, tile.y + r0 + 64,
                   min(64, tile.z - r0 - 64));
    }
    if (threadIdx.x % 128 == 0) bulk_wait<false>();
  }
}

int launch_hopper(const void* x, const void* w, hopper::WorkLists lists,
                  void* out, int capacity, int K, int N, int E,
                  cudaStream_t s) {
  CUtensorMap x256, x128, wmap, out64, out8;
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)capacity};
  const uint64_t sx[1] = {(uint64_t)K * 2};
  const uint32_t bx256[2] = {64, 256}, bx128[2] = {64, 128};
  const uint64_t dw[3] = {(uint64_t)K, (uint64_t)N, (uint64_t)E};
  const uint64_t sw[2] = {(uint64_t)K * 2, (uint64_t)N * K * 2};
  const uint32_t bw[3] = {64, (uint32_t)BN, 1};
  const uint64_t dout[2] = {(uint64_t)N, (uint64_t)capacity};
  const uint64_t sout[1] = {(uint64_t)N * 2};
  const uint32_t bout64[2] = {64, 64}, bout8[2] = {64, 8};
  if (!hopper::tensor_map(&x256, x, 2, dx, sx, bx256)
      || !hopper::tensor_map(&x128, x, 2, dx, sx, bx128)
      || !hopper::tensor_map(&wmap, w, 3, dw, sw, bw)
      || !hopper::tensor_map(&out64, out, 2, dout, sout, bout64)
      || !hopper::tensor_map(&out8, out, 2, dout, sout, bout8))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = TStage::R::SMEM;
  auto* kernel = gemm_t_hopper_kernel;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal surfaces as the launch's error
  const int most = hopper::max_tiles(capacity, E) * ((N + BN - 1) / BN);
  const int grid = most < moe_num_sms() ? most : moe_num_sms();
  kernel<<<grid, hopper::THREADS, smem, s>>>(x256, x128, wmap, out64, out8,
                                             lists.tiles, lists.count, K, N);
  return moe_last_error();
}

// fp32: the forward template's kernel with TRANS, tile height as there
inline void launch_f32(const float* x, const void* w, const int* be,
                       const int* ba, float* out, int capacity, int K, int N,
                       int block_m, cudaStream_t s) {
  using moe_gemm::gemm_f32_kernel;
  const int rows = block_m % 128 == 0 ? 128 : (block_m % 16 == 0 ? 16 : 8);
  const dim3 grid((N + moe_gemm::BN - 1) / moe_gemm::BN, capacity / rows);
  if (rows == 128)
    gemm_f32_kernel<128, false, 128, kDense, true><<<grid, 256, 0, s>>>(
        x, w, nullptr, nullptr, nullptr, be, ba, nullptr, out, K, N, block_m,
        0, 0);
  else if (rows == 16)
    gemm_f32_kernel<16, false, 16, kDense, true><<<grid, 256, 0, s>>>(
        x, w, nullptr, nullptr, nullptr, be, ba, nullptr, out, K, N, block_m,
        0, 0);
  else
    gemm_f32_kernel<16, false, 8, kDense, true><<<grid, 256, 0, s>>>(
        x, w, nullptr, nullptr, nullptr, be, ba, nullptr, out, K, N, block_m,
        0, 0);
}

}  // namespace moe_gemm_t

// x (capacity, K) of dtype `dtype` (MoeDtype), W (E, N, K) of the same
// dtype, the schedule's (E,) seg_start and (capacity / block_m,) block
// arrays, the work lists' scratch (hopper_gemm.cuh work_lists) -> out
// (capacity, N), every element written.
MOE_API int moe_grouped_gemm_t(const void* x, const void* w,
                               const void* seg_start,
                               const void* block_expert,
                               const void* block_active, void* scratch,
                               void* out, int capacity, int K, int N,
                               int n_experts, int block_m, int dtype,
                               void* stream) {
  if (capacity == 0 || N == 0) return moe_last_error();
  if (block_m <= 0 || block_m % 8 != 0 || capacity % block_m != 0
      || K % 16 != 0 || N % 16 != 0 || n_experts <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* be = (const int*)block_expert;
  const int* ba = (const int*)block_active;
  if (dtype != kBF16) {
    moe_gemm_t::launch_f32((const float*)x, w, be, ba, (float*)out, capacity,
                           K, N, block_m, s);
    return moe_last_error();
  }
  if (K == 0) return (int)cudaMemsetAsync(out, 0, (size_t)capacity * N * 2, s);
  const hopper::WorkLists lists =
      hopper::work_lists(scratch, capacity, n_experts);
  const int err = hopper::launch_expert_tiles(
      (const int*)seg_start, be, ba, capacity / block_m, block_m, n_experts,
      capacity, lists, true, s);
  if (err != 0) return err;
  return moe_gemm_t::launch_hopper(x, w, lists, out, capacity, K, N,
                                   n_experts, s);
}
