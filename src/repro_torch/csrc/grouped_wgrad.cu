// Grouped weight gradient of the block-scheduled GEMM (the transposed
// grouped GEMM of training's backward):
//
//   dW[e] = sum over the rows r of expert e's active blocks of x[r]^T dy[r]
//
// x (capacity, K), dy (capacity, N) in the schedule's padded layout -> dW
// (E, K, N), fp32 or bf16 (out_dtype: the fp32 sum rounded once).
// Experts with no rows get exact zeros.
//
// Replaces: src/repro/kernels/grouped_wgrad.py, grouped_wgrad (its Pallas
// _kernel, with its out_dtype), with the zeroing of experts with counts ==
// 0 that the reference's ops wrapper adds.
//
// What bounds it on the H100: at moonshot's training shape (T = 4096,
// k = 6, E = 64, K x N = 2048 x 1408) with fp32 output the 738 MB written
// per matrix outweigh the 2 x 28,672 active rows of bf16 input (about
// 200 MB): bytes, about 0.28 ms; with bf16 output (369 MB) the 165 GFLOP
// of the active rows on the tensor cores (0.17 ms) come close to the
// bytes (0.17 ms).
//
// Design (bf16, hopper_gemm.cuh): the TPU kernel walks the M-blocks in
// order and carries an fp32 accumulator from one grid step to the next,
// flushing at each expert boundary; Hopper's blocks run in no order, so
// here a work item is one 128 x BN tile of dW[e] and its consumer
// warpgroups reduce expert e's whole run of rows (from expert_tiles.cu's
// runs, which start at seg_start[e]) in 64-row stages, in one fixed order,
// then store once: deterministic, no atomics, no split across blocks.  The
// persistent blocks walk the items expert-major, so an expert's rows (a
// few MB of x and dy) stay in L2 while its tiles run.  Both operands are
// read MN-major straight from the row-major tiles TMA brings in (x^T: the
// x tile with K contiguous; dy with N contiguous), the layout wgmma takes
// transposed for 16-bit types, so no transposed copy is built.  A stage
// that would reach past the run's end (an end inside a stage: the dynamic
// policy's 8-row blocks, or any run that is not a multiple of 64) is
// loaded in 8-row boxes, and each 8-row group past the end is read from
// beyond the tensor's last row, which TMA fills with zeros: the next
// expert's rows never enter the sum.  Experts with no rows: their items
// store zeros and load nothing.  The epilogue rounds the fp32 sum once to
// the output dtype.
//
// fp32: one thread block per (expert, 64 x 64 tile), walking its expert's
// blocks from seg_start[e] (__syncthreads_count finds the run's length),
// CUDA-core fmaf (never TF32), each of 256 threads owning a 4 x 4
// micro-tile; the sum is rounded once to the output dtype.
#include "hopper_gemm.cuh"

namespace moe_wgrad {

constexpr int TK = 64, TN = 64;        // fp32 dW tile: TK rows (of K) x TN

// [row0, row1) of expert e's active schedule blocks (see the header); every
// thread of the block gets the same range
template <int THREADS>
__device__ __forceinline__ int2 expert_rows(const int* __restrict__ seg_start,
                                            const int* __restrict__ block_expert,
                                            const int* __restrict__ block_active,
                                            int e, int n_blocks, int block_m) {
  const int b0 = seg_start[e] / block_m;
  int end = b0;
  for (int base = b0; base < n_blocks; base += THREADS) {
    const int b = base + threadIdx.x;
    const bool ok = b < n_blocks && block_active[b] != 0
                    && block_expert[b] == e;
    const int n_ok = __syncthreads_count(ok);
    end = base + n_ok;
    if (n_ok < THREADS) break;
  }
  return make_int2(b0 * block_m, (end > b0 ? end : b0) * block_m);
}

template <int THREADS, typename OT>
__device__ __forceinline__ void store_zero_tile(OT* out, int k0, int n0,
                                                int K, int N) {
  for (int v = threadIdx.x; v < TK * (TN / 4); v += THREADS) {
    const int r = v / (TN / 4), c = (v % (TN / 4)) * 4;
    if (k0 + r < K && n0 + c < N) {
      OT* p = out + (size_t)(k0 + r) * N + n0 + c;
      if constexpr (sizeof(OT) == 4)
        *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
    }
  }
}

// ------------------------------------------------------------------ bf16
using hopper::BK;
using hopper::BM;
using hopper::SUB;

// dW tiles are BM x BN; a stage holds x's two 64-column halves of the
// 128-row (K) tile, then dy's BN / 64 column sub-tiles, each 64 rows (of
// the reduction) x 64 columns.  The epilogue: each consumer warpgroup's
// 64 x BN tile of dW in OT.
constexpr int BN = 128;

template <typename OT>
struct WgradStage {
  static constexpr int A_BYTES = 2 * SUB;
  static constexpr int BYTES = A_BYTES + (BN / 64) * SUB;
  static constexpr int EPI_WG = 64 * BN * (int)sizeof(OT);
  using R = hopper::Ring<BYTES, 2 * EPI_WG>;
};

// Store a warpgroup's rows of work item `it`'s dW tile from the fragment d
// (the parts past K or N are clipped by the tensor map)
template <typename OT>
__device__ __forceinline__ void store_dw(const float (&d)[BN / 2], int it,
                                         int per_e, int n_nt, int K, int N,
                                         int wg, unsigned char* epi,
                                         const CUtensorMap* omap) {
  using namespace hopper;
  const int e = it / per_e, r = it % per_e;
  const int k0 = (r / n_nt) * BM + 64 * wg, n0 = (r % n_nt) * BN;
  epilogue_begin(wg);
  stage_tile<OT>(d, epi);
  epilogue_staged(wg);
  if (threadIdx.x % 128 == 0) {
    constexpr int W = 128 / (int)sizeof(OT);
    for (int j = 0; j < BN / W; ++j)
      if (n0 + j * W < N && k0 < K)
        tma_store_3d(omap, smem_addr(epi) + j * BOX, n0 + j * W, k0, e);
    bulk_commit();
  }
}

template <typename OT>
__global__ void __launch_bounds__(hopper::THREADS, 1)
wgrad_hopper_kernel(const __grid_constant__ CUtensorMap x64,
                    const __grid_constant__ CUtensorMap x8,
                    const __grid_constant__ CUtensorMap dy64,
                    const __grid_constant__ CUtensorMap dy8,
                    const __grid_constant__ CUtensorMap omap,
                    const int2* __restrict__ runs, int K, int N,
                    int n_experts, int capacity) {
  using namespace hopper;
  using St = WgradStage<OT>;
  constexpr int S = St::R::STAGES, STAGE = St::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + St::R::BAR_OFF, empty = full + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_mt = (K + BM - 1) / BM, n_nt = (N + BN - 1) / BN;
  const int per_e = n_mt * n_nt, items = n_experts * per_e;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                                   // producer
    reg_dealloc<40>();
    if (threadIdx.x != 2 * 128) return;
    tma_prefetch(&x64); tma_prefetch(&x8);
    tma_prefetch(&dy64); tma_prefetch(&dy8);
    PipeState p;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int e = it / per_e, r = it % per_e;
      const int k0 = (r / n_nt) * BM, n0 = (r % n_nt) * BN;
      const int2 run = runs[e];
      for (int r0 = run.x; r0 < run.y; r0 += BK) {
        mbar_wait(empty + 8 * p.stage, p.phase ^ 1u);
        const uint32_t fb = full + 8 * p.stage;
        const uint32_t a = ring + p.stage * STAGE, b = a + St::A_BYTES;
        mbar_expect_tx(fb, STAGE);
        const int valid = min(BK, run.y - r0);
        if (valid == BK) {
          tma_load_2d(a, &x64, fb, k0, r0);
          tma_load_2d(a + SUB, &x64, fb, k0 + 64, r0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b + j * SUB, &dy64, fb, n0 + 64 * j, r0);
        } else {
          // 8-row boxes; the groups past the run read zeros past the end
          for (int g = 0; g < 8; ++g) {
            const int row = 8 * g < valid ? r0 + 8 * g : capacity;
            tma_load_2d(a + 1024 * g, &x8, fb, k0, row);
            tma_load_2d(a + SUB + 1024 * g, &x8, fb, k0 + 64, row);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(b + j * SUB + 1024 * g, &dy8, fb, n0 + 64 * j, row);
          }
        }
        p.advance<S>();
      }
    }
  } else {                                         // consumers
    reg_alloc<232>();
    PipeState p;
    unsigned char* epi = smem + St::R::EPI_OFF + wg * St::EPI_WG;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int2 run = runs[it / per_e];
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int r0 = run.x; r0 < run.y; r0 += BK) {
        mbar_wait(full + 8 * p.stage, p.phase);
        // this warpgroup's 64 K rows: x half wg, MN-major (atoms 8 KB
        // apart, 8-row groups 1 KB apart); dy MN-major likewise; each k16
        // step is 16 rows = 2 KB further
        const uint32_t a = ring + p.stage * STAGE + wg * SUB;
        const uint32_t b = ring + p.stage * STAGE + St::A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_m64n128k16<1, 1>(acc, make_desc(a + 2048 * ks, SUB, 1024),
                                 make_desc(b + 2048 * ks, SUB, 1024));
        wgmma_commit();
        wgmma_wait<1>();                 // the previous stage has been read
        fence_acc(acc);
        if (prev >= 0) mbar_arrive(empty + 8 * prev);
        prev = p.stage;
        p.advance<S>();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      store_dw<OT>(acc, it, per_e, n_nt, K, N, wg, epi, &omap);
    }
    if (threadIdx.x % 128 == 0) bulk_wait<false>();
  }
}

template <typename OT>
int launch_wgrad_hopper(const void* x, const void* dy, const int2* runs,
                        void* out, int capacity, int K, int N, int E,
                        cudaStream_t s) {
  CUtensorMap x64, x8, dy64, dy8, omap;
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)capacity};
  const uint64_t ddy[2] = {(uint64_t)N, (uint64_t)capacity};
  const uint64_t sx[1] = {(uint64_t)K * 2}, sdy[1] = {(uint64_t)N * 2};
  const uint32_t box64[2] = {64, 64}, box8[2] = {64, 8};
  constexpr bool F32 = sizeof(OT) == 4;
  const uint64_t dout[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t sout[2] = {(uint64_t)N * sizeof(OT),
                            (uint64_t)K * N * sizeof(OT)};
  const uint32_t bout[3] = {128 / sizeof(OT), 64, 1};
  if (!hopper::tensor_map(&x64, x, 2, dx, sx, box64)
      || !hopper::tensor_map(&x8, x, 2, dx, sx, box8)
      || !hopper::tensor_map(&dy64, dy, 2, ddy, sdy, box64)
      || !hopper::tensor_map(&dy8, dy, 2, ddy, sdy, box8)
      || !hopper::tensor_map(&omap, out, 3, dout, sout, bout, F32))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = WgradStage<OT>::R::SMEM;
  auto* kernel = wgrad_hopper_kernel<OT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal surfaces as the launch's error
  const int items = E * ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = items < moe_num_sms() ? items : moe_num_sms();
  kernel<<<grid, hopper::THREADS, smem, s>>>(x64, x8, dy64, dy8, omap,
                                             runs, K, N, E, capacity);
  return moe_last_error();
}

// ------------------------------------------------------------------ fp32
template <typename OT>
__global__ void __launch_bounds__(256)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ block_expert,
                 const int* __restrict__ block_active,
                 OT* __restrict__ out, int K, int N, int n_blocks,
                 int block_m) {
  constexpr int THREADS = 256, R = 16, LDF = 64 + 4;
  __shared__ __align__(16) float Xs[R * LDF];
  __shared__ __align__(16) float Ds[R * LDF];
  const int n0 = blockIdx.x * TN, k0 = blockIdx.y * TK, e = blockIdx.z;
  OT* dw = out + (size_t)e * K * N;
  const int2 rows = expert_rows<THREADS>(seg_start, block_expert,
                                         block_active, e, n_blocks, block_m);
  if (rows.y <= rows.x) {
    store_zero_tile<THREADS, OT>(dw, k0, n0, K, N);
    return;
  }
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = rows.x; r0 < rows.y; r0 += R) {
    {   // one float4 of x and one of dy per thread: R rows x 64 columns
      const int r = tid / 16, c = (tid % 16) * 4;
      const bool in = r0 + r < rows.y;
      *reinterpret_cast<float4*>(Xs + r * LDF + c) =
          in && k0 + c < K
              ? *reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * K + k0 + c)
              : z;
      *reinterpret_cast<float4*>(Ds + r * LDF + c) =
          in && n0 + c < N
              ? *reinterpret_cast<const float4*>(dy + (size_t)(r0 + r) * N + n0 + c)
              : z;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[r * LDF + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ds[r * LDF + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) dw[(size_t)k * N + n] = from_f32<OT>(acc[i][j]);
    }
  }
}

}  // namespace moe_wgrad

// x (capacity, K) and dy (capacity, N) of dtype `dtype` (MoeDtype), the
// schedule's (E,) seg_start and (capacity / block_m,) block arrays, the
// work lists' scratch (hopper_gemm.cuh work_lists) -> out (E, K, N) of
// out_dtype (MoeDtype), every element written.
MOE_API int moe_grouped_wgrad(const void* x, const void* dy,
                              const void* seg_start, const void* block_expert,
                              const void* block_active, void* scratch,
                              void* out, int capacity, int K, int N,
                              int n_experts, int block_m, int dtype,
                              int out_dtype, void* stream) {
  if (n_experts == 0 || K == 0 || N == 0) return moe_last_error();
  if (block_m <= 0 || capacity % block_m != 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_blocks = capacity / block_m;
  const int* ss = (const int*)seg_start;
  const int* be = (const int*)block_expert;
  const int* ba = (const int*)block_active;
  const bool bf16_out = out_dtype == kBF16;
  if (dtype == kBF16) {
    if (capacity == 0)
      return (int)cudaMemsetAsync(out, 0, (size_t)n_experts * K * N
                                  * (bf16_out ? 2 : 4), s);
    const hopper::WorkLists lists =
        hopper::work_lists(scratch, capacity, n_experts);
    const int err = hopper::launch_expert_tiles(
        ss, be, ba, n_blocks, block_m, n_experts, capacity, lists, false, s);
    if (err != 0) return err;
    return bf16_out
        ? moe_wgrad::launch_wgrad_hopper<__nv_bfloat16>(
              x, dy, lists.runs, out, capacity, K, N, n_experts, s)
        : moe_wgrad::launch_wgrad_hopper<float>(
              x, dy, lists.runs, out, capacity, K, N, n_experts, s);
  }
  const dim3 grid((N + moe_wgrad::TN - 1) / moe_wgrad::TN,
                  (K + moe_wgrad::TK - 1) / moe_wgrad::TK, n_experts);
  if (bf16_out)
    moe_wgrad::wgrad_f32_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const float*)x, (const float*)dy, ss, be, ba, (__nv_bfloat16*)out,
        K, N, n_blocks, block_m);
  else
    moe_wgrad::wgrad_f32_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)x, (const float*)dy, ss, be, ba, (float*)out, K, N,
        n_blocks, block_m);
  return moe_last_error();
}
