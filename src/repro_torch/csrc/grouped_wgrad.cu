// Grouped weight gradient of the block-scheduled GEMM (the transposed
// grouped GEMM of training's backward):
//
//   dW[e] = sum over the rows r of expert e's active blocks of x[r]^T dy[r]
//
// x (capacity, K), dy (capacity, N) in the schedule's padded layout -> dW
// (E, K, N) fp32.  Experts with no rows get exact zeros.
//
// Replaces: src/repro/kernels/grouped_wgrad.py, grouped_wgrad (its Pallas
// _kernel), with the zeroing of experts with counts == 0 that the
// reference's ops wrapper adds.
//
// What bounds it on the H100: at moonshot's training shape (T = 4096,
// k = 6, E = 64, K x N = 2048 x 1408) the fp32 output, 738 MB per matrix,
// outweighs the 2 x 24,576 useful rows of bf16 input (about 170 MB) and
// the 142 GFLOP (0.14 ms on the tensor cores): bytes, about 0.27 ms.
//
// Design.  The TPU kernel walks the M-blocks in order and carries an fp32
// accumulator from one grid step to the next, flushing at each expert
// boundary; Hopper's blocks run in no order, so here one thread block owns
// one (expert, 64-row K tile, 64-column N tile) of dW and walks that
// expert's rows itself.  Each expert's blocks are consecutive and start at
// block seg_start[e] / block_m under both ported policies (fixed: segments
// in expert order; dynamic: in load order, on 8-row sub-blocks), and the
// active blocks are a prefix of the schedule.  So the block's threads test
// the schedule blocks from there, THREADS at a time, for "active and owned
// by e" (__syncthreads_count gives the length of the run, which is
// contiguous), and the rows [start, end) are reduced in fp32 in one fixed
// order and stored once: deterministic, no atomics, no second pass.  The
// trailing inactive blocks that the schedule clamps onto an expert end the
// walk; an expert whose first block belongs to another expert (or lies
// past the active prefix) writes zeros.  Padding rows inside a segment are
// zero in x (permute writes them so) and add nothing.
//
// bf16: a 4-deep cp.async ring of 32-row stages of x and dy (64 columns
// each), nvcuda::wmma 16x16x16 with fp32 accumulators; the x tile is read
// as a col_major matrix_a, so x^T is never built.  fp32: the same walk with
// CUDA-core fmaf (never TF32), each of 256 threads owning a 4 x 4
// micro-tile.
#include "grouped_gemm.cuh"

namespace moe_wgrad {

using bf16 = __nv_bfloat16;
using moe_gemm::cp_async16;
using moe_gemm::cp_async_commit;
using moe_gemm::cp_async_wait;

constexpr int TK = 64, TN = 64;        // dW tile: TK rows (of K) x TN columns

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

template <int THREADS>
__device__ __forceinline__ void store_zero_tile(float* out, int k0, int n0,
                                                int K, int N) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int v = threadIdx.x; v < TK * (TN / 4); v += THREADS) {
    const int r = v / (TN / 4), c = (v % (TN / 4)) * 4;
    if (k0 + r < K && n0 + c < N)
      *reinterpret_cast<float4*>(out + (size_t)(k0 + r) * N + n0 + c) = z;
  }
}

// ------------------------------------------------------------------ bf16
constexpr int BR = 32, STAGES = 4;     // rows per ring stage, ring depth
constexpr int LD = 64 + 8;             // shared pitch of the x and dy tiles
constexpr int LDC = TN + 4;
constexpr int TILE_BYTES = BR * LD * 2;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int SMEM_BF16 = STAGES * STAGE_BYTES;    // 36,864 bytes
static_assert(TK * LDC * 4 <= SMEM_BF16, "the C tile reuses the ring");

__global__ void __launch_bounds__(128)
wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const int* __restrict__ seg_start,
                  const int* __restrict__ block_expert,
                  const int* __restrict__ block_active,
                  float* __restrict__ out, int K, int N, int n_blocks,
                  int block_m) {
  using namespace nvcuda;
  constexpr int THREADS = 128;
  __shared__ __align__(128) unsigned char smem[SMEM_BF16];
  const int n0 = blockIdx.x * TN, k0 = blockIdx.y * TK, e = blockIdx.z;
  float* dw = out + (size_t)e * K * N;
  const int2 rows = expert_rows<THREADS>(seg_start, block_expert,
                                         block_active, e, n_blocks, block_m);
  if (rows.y <= rows.x) {
    store_zero_tile<THREADS>(dw, k0, n0, K, N);
    return;
  }
  const int tid = threadIdx.x, wid = tid / 32;
  const int wm = wid / 2, wn = wid % 2;          // 2 x 2 warps of 32 x 32

  auto load_stage = [&](int slot, int r0) {
    bf16* Xs = reinterpret_cast<bf16*>(smem + slot * STAGE_BYTES);
    bf16* Ds = reinterpret_cast<bf16*>(smem + slot * STAGE_BYTES + TILE_BYTES);
    for (int v = tid; v < BR * 8; v += THREADS) {
      const int r = v / 8, c = (v % 8) * 8;
      const bool in = r0 + r < rows.y;           // rows past the run: zeros
      const bool okx = in && k0 + c < K, oky = in && n0 + c < N;
      cp_async16(Xs + r * LD + c,
                 okx ? x + (size_t)(r0 + r) * K + k0 + c : x, okx);
      cp_async16(Ds + r * LD + c,
                 oky ? dy + (size_t)(r0 + r) * N + n0 + c : dy, oky);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nc = (rows.y - rows.x + BR - 1) / BR;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc) load_stage(s, rows.x + s * BR);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<STAGES - 2>();       // chunk c has landed
    __syncthreads();                   // ... for every thread; slot c-1 free
    const int slot = c % STAGES;
    const bf16* Xs = reinterpret_cast<const bf16*>(smem + slot * STAGE_BYTES);
    const bf16* Ds = reinterpret_cast<const bf16*>(smem + slot * STAGE_BYTES
                                                   + TILE_BYTES);
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // x^T tile: element (k, r) at Xs[r * LD + k], a col_major matrix_a
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Xs + kk * LD + wm * 32 + i * 16, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Ds + kk * LD + wn * 32 + j * 16, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    const int nxt = c + STAGES - 1;
    if (nxt < nc) load_stage(nxt % STAGES, rows.x + nxt * BR);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free: reuse it as Cs
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < TK * (TN / 4); v += THREADS) {
    const int r = v / (TN / 4), cc = (v % (TN / 4)) * 4;
    if (k0 + r < K && n0 + cc < N)
      *reinterpret_cast<float4*>(dw + (size_t)(k0 + r) * N + n0 + cc) =
          *reinterpret_cast<const float4*>(Cs + r * LDC + cc);
  }
}

// ------------------------------------------------------------------ fp32
__global__ void __launch_bounds__(256)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ block_expert,
                 const int* __restrict__ block_active,
                 float* __restrict__ out, int K, int N, int n_blocks,
                 int block_m) {
  constexpr int THREADS = 256, R = 16, LDF = 64 + 4;
  __shared__ __align__(16) float Xs[R * LDF];
  __shared__ __align__(16) float Ds[R * LDF];
  const int n0 = blockIdx.x * TN, k0 = blockIdx.y * TK, e = blockIdx.z;
  float* dw = out + (size_t)e * K * N;
  const int2 rows = expert_rows<THREADS>(seg_start, block_expert,
                                         block_active, e, n_blocks, block_m);
  if (rows.y <= rows.x) {
    store_zero_tile<THREADS>(dw, k0, n0, K, N);
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
      if (n < N) dw[(size_t)k * N + n] = acc[i][j];
    }
  }
}

}  // namespace moe_wgrad

// x (capacity, K) and dy (capacity, N) of dtype `dtype` (MoeDtype), the
// schedule's (E,) seg_start and (capacity / block_m,) block arrays -> out
// (E, K, N) fp32, every element written.
MOE_API int moe_grouped_wgrad(const void* x, const void* dy,
                              const void* seg_start, const void* block_expert,
                              const void* block_active, void* out,
                              int capacity, int K, int N, int n_experts,
                              int block_m, int dtype, void* stream) {
  if (n_experts == 0 || K == 0 || N == 0) return moe_last_error();
  if (block_m <= 0 || capacity % block_m != 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + moe_wgrad::TN - 1) / moe_wgrad::TN,
                  (K + moe_wgrad::TK - 1) / moe_wgrad::TK, n_experts);
  const int n_blocks = capacity / block_m;
  const int* ss = (const int*)seg_start;
  const int* be = (const int*)block_expert;
  const int* ba = (const int*)block_active;
  if (dtype == kBF16)
    moe_wgrad::wgrad_bf16_kernel<<<grid, 128, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, ss, be, ba,
        (float*)out, K, N, n_blocks, block_m);
  else
    moe_wgrad::wgrad_f32_kernel<<<grid, 256, 0, s>>>(
        (const float*)x, (const float*)dy, ss, be, ba, (float*)out, K, N,
        n_blocks, block_m);
  return moe_last_error();
}
