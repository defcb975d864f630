// Block-scheduled grouped GEMM template shared by grouped_gemm.cu (one B
// operand, optional row_scale epilogue) and fused_gate_up.cu (two B
// operands, SiLU(g) * u epilogue).
//
// out[rows of schedule block m] = x[rows] @ W[block_expert[m]], (capacity, K)
// x (E, K, N) -> (capacity, N), fp32 accumulation.
//
// Grid: one thread block per (ROWS-row tile, 64-column tile).  The tile
// height ROWS always divides block_m, so a tile never spans two schedule
// blocks: its schedule block is m = row0 / block_m, and the block reads
// block_expert[m] and block_active[m] from device memory itself, the Hopper
// form of the TPU's scalar prefetch.  An inactive block writes zeros and
// returns without touching the weights.  ROWS = 128 when block_m is a
// multiple of 128 (the fixed policy: each weight tile is then read once per
// schedule block), 16 when it is a multiple of 16, else 8 (the dynamic
// policy's 8-row sub-blocks).  An 8-row tile runs the 16-row kernel (BM =
// 16) with rows 8-15 zero-filled in shared memory and never stored; with
// 8-row blocks a heavy expert's weights are read once per 8-row block.
// block_m must be a multiple of 8, K and N multiples of 16 (checked by the
// wrapper).
//
// bf16: a 4-deep cp.async ring of shared-memory A and B tiles over K
// (BK = 32), nvcuda::wmma 16x16x16 __nv_bfloat16 fragments with fp32
// accumulators.  The fused variant keeps
// two accumulator sets fed by the same A fragment, and forms g*sigmoid(g)*u
// element-wise on the accumulator fragments (both sets share one layout)
// before staging through shared memory for the store.
// fp32: the same tiling with CUDA-core fmaf (never TF32), each thread owning
// a (BM/16) x 4 micro-tile (rows past ROWS are zero and never stored), so
// the result keeps full fp32 precision.
// Epilogue in fp32 (row_scale multiply or SiLU product), one cast, one
// store.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace moe_gemm {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.0f / (1.0f + expf(-g))) * u;
}

// ---------------------------------------------------------------- zeros
template <typename T, int BM, int THREADS>
__device__ __forceinline__ void store_zero_tile(T* out, int m0, int n0, int N) {
  constexpr int EPV = 16 / sizeof(T);           // elements per 16-byte vector
  constexpr int VPR = BN / EPV;                 // vectors per tile row
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int v = threadIdx.x; v < BM * VPR; v += THREADS) {
    const int r = v / VPR, c = n0 + (v % VPR) * EPV;
    if (c < N) *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + c) = z;
  }
}

// ------------------------------------------------------------------ bf16
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  // 16-byte global -> shared copy that bypasses the registers; a false
  // predicate copies nothing and zero-fills the destination
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int BM, bool FUSED>
struct Bf16Tiles {
  static constexpr int BK = 32, STAGES = 4;
  static constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  static constexpr int A_BYTES = BM * LDA * 2, B_BYTES = BK * LDB * 2;
  static constexpr int STAGE_BYTES = A_BYTES + (FUSED ? 2 : 1) * B_BYTES;
  static constexpr int PIPE_BYTES = STAGES * STAGE_BYTES;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

// bf16 GEMM with a STAGES-deep cp.async ring of (A, B[, B2]) K tiles: the
// loads of the next STAGES-1 tiles are in flight while the tensor cores
// work on the current one, so each block keeps several weight tiles of
// device-memory traffic outstanding (the decode regime is weight-bandwidth
// bound with few active blocks per SM).  Shared memory is dynamic.  The
// launch bound asks for two blocks per SM: it holds the fused variant at
// 128 registers (167 unbounded), so the active blocks of a decode step fit
// in one wave.
template <int BM, int WARPS_M, int WARPS_N, bool FUSED, int ROWS>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N, 2)
gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                 const bf16* __restrict__ w1, const int* __restrict__ block_expert,
                 const int* __restrict__ block_active,
                 const float* __restrict__ row_scale, bf16* __restrict__ out,
                 int K, int N, int block_m) {
  using namespace nvcuda;
  using C = Bf16Tiles<BM, FUSED>;
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  constexpr int LDA = C::LDA, LDB = C::LDB, LDC = C::LDC;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(ROWS <= BM && BM % 16 == 0, "tile rows");
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * ROWS;
  const int mb = m0 / block_m;
  if (block_active[mb] == 0) {
    store_zero_tile<bf16, ROWS, THREADS>(out, m0, n0, N);
    return;
  }
  const size_t e = (size_t)block_expert[mb];
  const bf16* W0 = w0 + e * K * N;
  const bf16* W1 = FUSED ? w1 + e * K * N : nullptr;

  const int tid = threadIdx.x, wid = tid / 32;
  const int wm = wid / WARPS_N, wn = wid % WARPS_N;

  auto load_stage = [&](int slot, int k0) {
    bf16* As = reinterpret_cast<bf16*>(smem + slot * C::STAGE_BYTES);
    bf16* Bs0 = reinterpret_cast<bf16*>(smem + slot * C::STAGE_BYTES + C::A_BYTES);
    bf16* Bs1 = Bs0 + C::B_BYTES / 2;
    for (int v = tid; v < BM * (BK / 8); v += THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const bool ok = r < ROWS && k0 + c < K;   // rows past ROWS: zeros
      cp_async16(As + r * LDA + c,
                 ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok);
    }
    for (int v = tid; v < BK * (BN / 8); v += THREADS) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const bool ok = (k0 + r < K) && (n0 + c < N);
      const size_t off = ok ? (size_t)(k0 + r) * N + n0 + c : 0;
      cp_async16(Bs0 + r * LDB + c, W0 + off, ok);
      if (FUSED) cp_async16(Bs1 + r * LDB + c, W1 + off, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0[FM][FN];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[FM][FN];  // unused unless FUSED
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc0[i][j], 0.f);
      if (FUSED) wmma::fill_fragment(acc1[i][j], 0.f);
    }

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();     // tile kt has landed
    __syncthreads();                 // ... for every thread; slot kt-1 is free
    const int slot = kt % STAGES;
    const bf16* As = reinterpret_cast<const bf16*>(smem + slot * C::STAGE_BYTES);
    const bf16* Bs0 = reinterpret_cast<const bf16*>(smem + slot * C::STAGE_BYTES + C::A_BYTES);
    const bf16* Bs1 = Bs0 + C::B_BYTES / 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs0 + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc0[i][j], a[i], b, acc0[i][j]);
        if (FUSED) {
          wmma::load_matrix_sync(b, Bs1 + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(acc1[i][j], a[i], b, acc1[i][j]);
        }
      }
    }
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free: reuse it as Cs

  // epilogue: (SiLU product,) stage fp32 through shared memory, scale, cast
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if (FUSED) {
#pragma unroll
        for (int q = 0; q < acc0[i][j].num_elements; ++q)
          acc0[i][j].x[q] = silu_mul(acc0[i][j].x[q], acc1[i][j].x[q]);
      }
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                              acc0[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int v = tid; v < ROWS * (BN / 8); v += THREADS) {
    const int r = v / (BN / 8), cc = (v % (BN / 8)) * 8;
    if (n0 + cc >= N) continue;
    const float s = (row_scale != nullptr) ? row_scale[m0 + r] : 1.0f;
    alignas(16) bf16 res[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float val = Cs[r * LDC + cc + q];
      if (row_scale != nullptr) val = val * s;
      res[q] = __float2bfloat16_rn(val);
    }
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + cc) =
        *reinterpret_cast<const uint4*>(res);
  }
}

template <int BM, int WARPS_M, int WARPS_N, bool FUSED, int ROWS>
inline void launch_bf16(dim3 grid, cudaStream_t s, const bf16* x,
                        const bf16* w0, const bf16* w1, const int* be,
                        const int* ba, const float* rs, bf16* out, int K,
                        int N, int block_m) {
  constexpr int smem = Bf16Tiles<BM, FUSED>::SMEM;
  auto* kernel = gemm_bf16_kernel<BM, WARPS_M, WARPS_N, FUSED, ROWS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal surfaces as the launch's error
  kernel<<<grid, 32 * WARPS_M * WARPS_N, smem, s>>>(x, w0, w1, be, ba, rs,
                                                     out, K, N, block_m);
}

// ------------------------------------------------------------------ fp32
template <int BM, bool FUSED, int ROWS>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ w1, const int* __restrict__ block_expert,
                const int* __restrict__ block_active,
                const float* __restrict__ row_scale, float* __restrict__ out,
                int K, int N, int block_m) {
  constexpr int THREADS = 256, BK = 16;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = BK + 4, LDB = BN + 4;
  static_assert(ROWS <= BM && BM % 16 == 0, "tile rows");
  __shared__ __align__(16) float As[BM * LDA];
  __shared__ __align__(16) float Bs0[BK * LDB];
  __shared__ __align__(16) float Bs1[FUSED ? BK * LDB : 4];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * ROWS;
  const int mb = m0 / block_m;
  if (block_active[mb] == 0) {
    store_zero_tile<float, ROWS, THREADS>(out, m0, n0, N);
    return;
  }
  const size_t e = (size_t)block_expert[mb];
  const float* W0 = w0 + e * K * N;
  const float* W1 = FUSED ? w1 + e * K * N : nullptr;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc0[TM][TN], acc1[TM][TN];  // acc1 unused unless FUSED
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc0[i][j] = 0.f;
      if (FUSED) acc1[i][j] = 0.f;
    }

  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int v = tid; v < BM * (BK / 4); v += THREADS) {
      const int r = v / (BK / 4), c = (v % (BK / 4)) * 4;
      *reinterpret_cast<float4*>(As + r * LDA + c) =
          r < ROWS ? *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + k0 + c)
                   : z;
    }
    for (int v = tid; v < BK * (BN / 4); v += THREADS) {
      const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
      const bool ok = n0 + c < N;
      const size_t off = (size_t)(k0 + r) * N + n0 + c;
      *reinterpret_cast<float4*>(Bs0 + r * LDB + c) =
          ok ? *reinterpret_cast<const float4*>(W0 + off) : z;
      if (FUSED)
        *reinterpret_cast<float4*>(Bs1 + r * LDB + c) =
            ok ? *reinterpret_cast<const float4*>(W1 + off) : z;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float b0 = Bs0[kk * LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc0[i][j] = fmaf(a[i], b0, acc0[i][j]);
        if (FUSED) {
          const float b1 = Bs1[kk * LDB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc1[i][j] = fmaf(a[i], b1, acc1[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (ty + 16 * i >= ROWS) continue;
    const int r = m0 + ty + 16 * i;
    const float s = (row_scale != nullptr) ? row_scale[r] : 1.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= N) continue;
      float val = FUSED ? silu_mul(acc0[i][j], acc1[i][j]) : acc0[i][j];
      if (row_scale != nullptr) val = val * s;
      out[(size_t)r * N + c] = val;
    }
  }
}

// ---------------------------------------------------------------- launch
template <bool FUSED>
inline int launch(const void* x, const void* w0, const void* w1,
                  const void* block_expert, const void* block_active,
                  const void* row_scale, void* out, int capacity, int K, int N,
                  int block_m, int dtype, void* stream) {
  if (capacity == 0 || N == 0) return moe_last_error();
  if (block_m % 8 != 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // tile height: the largest of 128, 16, 8 that divides block_m
  const int rows = block_m % 128 == 0 ? 128 : (block_m % 16 == 0 ? 16 : 8);
  dim3 grid((N + BN - 1) / BN, capacity / rows);
  const int* be = (const int*)block_expert;
  const int* ba = (const int*)block_active;
  const float* rs = (const float*)row_scale;
  if (dtype == kBF16) {
    const bf16 *xb = (const bf16*)x, *a = (const bf16*)w0, *b = (const bf16*)w1;
    bf16* o = (bf16*)out;
    if (rows == 128)
      launch_bf16<128, 4, 2, FUSED, 128>(grid, s, xb, a, b, be, ba, rs, o, K, N, block_m);
    else if (rows == 16)
      launch_bf16<16, 1, 4, FUSED, 16>(grid, s, xb, a, b, be, ba, rs, o, K, N, block_m);
    else
      launch_bf16<16, 1, 4, FUSED, 8>(grid, s, xb, a, b, be, ba, rs, o, K, N, block_m);
  } else {
    const float *xf = (const float*)x, *a = (const float*)w0, *b = (const float*)w1;
    float* o = (float*)out;
    if (rows == 128)
      gemm_f32_kernel<128, FUSED, 128><<<grid, 256, 0, s>>>(xf, a, b, be, ba, rs, o, K, N, block_m);
    else if (rows == 16)
      gemm_f32_kernel<16, FUSED, 16><<<grid, 256, 0, s>>>(xf, a, b, be, ba, rs, o, K, N, block_m);
    else
      gemm_f32_kernel<16, FUSED, 8><<<grid, 256, 0, s>>>(xf, a, b, be, ba, rs, o, K, N, block_m);
  }
  return moe_last_error();
}

}  // namespace moe_gemm
