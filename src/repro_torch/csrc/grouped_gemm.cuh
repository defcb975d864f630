// Block-scheduled grouped GEMM template shared by grouped_gemm.cu (one B
// operand, optional row_scale epilogue) and fused_gate_up.cu (two B
// operands, SiLU(g) * u epilogue), for fp32 inputs and for bf16 inputs on
// int8/int4 weights.  bf16 on dense weights is the Hopper kernel of
// grouped_gemm_hopper.cuh, which launch() at the end of this file calls.
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
// 16) with rows 8-15 zero-filled in shared memory and never stored.
// block_m must be a multiple of 8, K and N multiples of 16 (checked by the
// wrapper).
//
// bf16 (int8/int4 weights): a 4-deep cp.async ring of shared-memory A and
// compressed B tiles over K, nvcuda::wmma 16x16x16 __nv_bfloat16 fragments
// with fp32 accumulators.  The fused variant keeps two accumulator sets fed
// by the same A fragment, and forms g*sigmoid(g)*u element-wise on the
// accumulator fragments (both sets share one layout) before staging
// through shared memory for the store.
// fp32: the same tiling with CUDA-core fmaf (never TF32), each thread owning
// a (BM/16) x 4 micro-tile (rows past ROWS are zero and never stored), so
// the result keeps full fp32 precision.
// Epilogue in fp32 (row_scale multiply or SiLU product), one cast, one
// store.
//
// Weight formats (the compile-time parameter FMT; kDense in fp32 only):
// kInt8, an (E, K, N) int8 payload, and
// kInt4, an (E, K/2, N) int8 payload whose byte r holds logical K rows 2r
// (low nibble) and 2r+1 (high nibble), sign-extended; both with fp32 scales
// scale[e * s_e + n * s_n] (s_n = 0 for per-expert scales).  Each thread
// block dequantizes its own expert's weight tiles on chip, as the
// reference's dequant_weight_block does: float(q) * scale in fp32, rounded
// once to the compute dtype, then the same wmma (bf16) or fmaf (fp32)
// product.  bf16: the cp.async ring carries the compressed tile (per operand
// and stage of 64 K rows in the 16-row kernel: 4 KB int8 or 2 KB int4,
// against 4 KB for 32 dense rows); after the wait the block expands it into
// one bf16 (BK, BN) shared tile per operand, with the tile's 64 column
// scales staged in shared memory, behind one more __syncthreads.  Only the
// compressed bytes cross device memory; no dense stack exists.  Inactive
// tiles still get zeros, with neither weights nor scales read; the
// quantized 16-row kernel's blocks take several row tiles each
// (tiles_per_block).
//
// Weight layout (the compile-time parameter TRANS of the fp32 kernel,
// dense only; the instantiations with TRANS = false are the code above,
// unchanged): TRANS reads W[e] transposed in place, out[block m] = x[block
// m] @ W[e]^T, the backward's dX product in fp32 (grouped_gemm_t.cu; its
// bf16 form is a Hopper kernel of its own there).  Here K is the reduction
// (W's last axis) and N the output width (W's middle axis), so W[e] is (N,
// K) row-major: each thread loads 4 K values of one column and stores them
// down the (BK, BN) shared tile.  No transposed copy of the weights is ever
// built.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "grouped_gemm_hopper.cuh"

namespace moe_gemm {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;
enum WFormat { kDense = 0, kInt8 = 1, kInt4 = 2 };

// payload K rows per BK logical rows, and the payload's K extent
template <int FMT>
__host__ __device__ constexpr int payload_rows(int k) {
  return FMT == kInt4 ? k / 2 : k;
}

// the block's BN column scales of expert e into shared memory (zeros past
// N); read only by active blocks
template <int THREADS>
__device__ __forceinline__ void stage_scales(float* Ss, const float* s,
                                             size_t e, int n0, int N,
                                             int s_e, int s_n) {
  for (int c = threadIdx.x; c < BN; c += THREADS)
    Ss[c] = n0 + c < N ? s[e * s_e + (size_t)(n0 + c) * s_n] : 0.f;
}

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

// Shared-memory layout (int8/int4 only: the bf16 dense path is the Hopper
// kernel of grouped_gemm_hopper.cuh): STAGES ring stages of (A, W[, W2])
// tiles, where W is the compressed payload tile (Q_BYTES: QROWS rows of BN
// bytes); then the expanded bf16 tile(s) and the column scales.  The
// epilogue reuses the start as the fp32 C tile.
// K depth per stage: a compressed stage of 32 rows carries half (int8) or
// a quarter (int4) of a dense stage's bytes for the same count of ring
// steps, barriers and expand passes, so the 16-row (decode) kernel takes
// 64 rows per stage: twice the bytes in flight per step and half the
// steps.  The 128-row kernel keeps 32 (its A tile would grow to 18 KB per
// stage).
template <int BM, bool FUSED, int FMT>
struct Bf16Tiles {
  static_assert(FMT != kDense, "bf16 dense: grouped_gemm_hopper.cuh");
  static constexpr int BK = BM == 16 ? 64 : 32;
  static constexpr int STAGES = 4, NW = FUSED ? 2 : 1;
  static constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  static constexpr int A_BYTES = BM * LDA * 2;
  static constexpr int B_BYTES = BK * LDB * 2;
  static constexpr int QROWS = payload_rows<FMT>(BK), Q_BYTES = QROWS * BN;
  static constexpr int STAGE_BYTES = A_BYTES + NW * Q_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int X_OFF = RING_BYTES;                  // expanded tiles
  static constexpr int S_OFF = X_OFF + NW * B_BYTES;        // column scales
  static constexpr int PIPE_BYTES = S_OFF + NW * BN * 4;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

// float(v) of a byte or nibble without the conversion unit (which runs at
// a fraction of the ALU rate, and the decode kernel converts every weight
// it reads): v, biased into [0, 255], is placed in the mantissa of 2^23
// and the bias subtracted, exactly.
__device__ __forceinline__ float int8_value(unsigned word, int j) {
  // byte j of word: (b ^ 0x80) = b + 128
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u,
                                     0x7540 | j)) - 8388736.0f;
}
__device__ __forceinline__ float int4_value(unsigned word, int i) {
  // nibble i (0-7) of word: (n ^ 8) = v + 8
  return __uint_as_float(0x4B000000u | (((word ^ 0x88888888u) >> (4 * i))
                                        & 0xFu)) - 8388616.0f;
}
// two weights rounded to bf16 (nearest even) by one packed conversion
__device__ __forceinline__ unsigned bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Expand one compressed (QROWS, BN) payload tile into the bf16 (BK, BN)
// tile Xs: w = bf16(float(q) * scale[n]), the product in fp32 rounded once.
// Each thread takes 8 columns of one payload row (8 bytes: 8 weights in
// int8, 16 in int4).
template <int FMT, int THREADS, int LDB, int BK>
__device__ __forceinline__ void expand_tile_bf16(bf16* Xs,
                                                 const unsigned char* Qs,
                                                 const float* Ss) {
  constexpr int QROWS = payload_rows<FMT>(BK), GROUPS = BN / 8;
  for (int v = threadIdx.x; v < QROWS * GROUPS; v += THREADS) {
    const int r = v / GROUPS, c = (v % GROUPS) * 8;
    const uint2 q = *reinterpret_cast<const uint2*>(Qs + r * BN + c);
    const float4 s0 = *reinterpret_cast<const float4*>(Ss + c);
    const float4 s1 = *reinterpret_cast<const float4*>(Ss + c + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned word = j < 4 ? q.x : q.y;
      if (FMT == kInt8) {
        lo[j] = int8_value(word, j & 3) * s[j];
      } else {
        lo[j] = int4_value(word, 2 * (j & 3)) * s[j];
        hi[j] = int4_value(word, 2 * (j & 3) + 1) * s[j];
      }
    }
    const int row = FMT == kInt4 ? 2 * r : r;
    *reinterpret_cast<uint4*>(Xs + row * LDB + c) = make_uint4(
        bf16x2_bits(lo[0], lo[1]), bf16x2_bits(lo[2], lo[3]),
        bf16x2_bits(lo[4], lo[5]), bf16x2_bits(lo[6], lo[7]));
    if (FMT == kInt4)
      *reinterpret_cast<uint4*>(Xs + (row + 1) * LDB + c) = make_uint4(
          bf16x2_bits(hi[0], hi[1]), bf16x2_bits(hi[2], hi[3]),
          bf16x2_bits(hi[4], hi[5]), bf16x2_bits(hi[6], hi[7]));
  }
}

// bf16 GEMM on int8/int4 weights with a STAGES-deep cp.async ring of (A,
// Q[, Q2]) K tiles: the loads of the next STAGES-1 tiles are in flight
// while the tensor cores work on the current one, so each block keeps
// several weight tiles of device-memory traffic outstanding (the decode
// regime is weight-bandwidth bound with few active blocks per SM).  Shared
// memory is dynamic.  The launch bound asks for two blocks per SM, so the
// active blocks of a decode step fit in one wave.  The ring carries the
// compressed tiles and each is expanded into Xs before its products (see
// the header).  One active (ROWS, BN) output tile at (m0, n0) of expert e.
template <int BM, int WARPS_M, int WARPS_N, bool FUSED, int ROWS, int FMT>
__device__ __forceinline__ void
gemm_bf16_tile(const bf16* __restrict__ x, const void* __restrict__ w0,
               const void* __restrict__ w1, const float* __restrict__ s0,
               const float* __restrict__ s1,
               const float* __restrict__ row_scale, bf16* __restrict__ out,
               int K, int N, int s_e, int s_n, int m0, int n0, size_t e) {
  using namespace nvcuda;
  using C = Bf16Tiles<BM, FUSED, FMT>;
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  constexpr int LDA = C::LDA, LDB = C::LDB, LDC = C::LDC;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(ROWS <= BM && BM % 16 == 0, "tile rows");
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);

  const int KQ = payload_rows<FMT>(K);             // payload rows of W[e]
  using WT = unsigned char;
  const WT* W0 = reinterpret_cast<const WT*>(w0) + e * KQ * N;
  const WT* W1 = FUSED ? reinterpret_cast<const WT*>(w1) + e * KQ * N
                       : nullptr;
  bf16* Xs0 = reinterpret_cast<bf16*>(smem + C::X_OFF);
  bf16* Xs1 = Xs0 + C::B_BYTES / 2;
  float* Ss0 = reinterpret_cast<float*>(smem + C::S_OFF);
  float* Ss1 = Ss0 + BN;
  // visible after the main loop's first barrier
  stage_scales<THREADS>(Ss0, s0, e, n0, N, s_e, s_n);
  if (FUSED) stage_scales<THREADS>(Ss1, s1, e, n0, N, s_e, s_n);

  const int tid = threadIdx.x, wid = tid / 32;
  const int wm = wid / WARPS_N, wn = wid % WARPS_N;

  auto load_stage = [&](int slot, int k0) {
    bf16* As = reinterpret_cast<bf16*>(smem + slot * C::STAGE_BYTES);
    WT* Bs0 = reinterpret_cast<WT*>(smem + slot * C::STAGE_BYTES + C::A_BYTES);
    WT* Bs1 = reinterpret_cast<WT*>(smem + slot * C::STAGE_BYTES + C::A_BYTES
                                    + C::Q_BYTES);
    for (int v = tid; v < BM * (BK / 8); v += THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const bool ok = r < ROWS && k0 + c < K;   // rows past ROWS: zeros
      cp_async16(As + r * LDA + c,
                 ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok);
    }
    // the compressed tile: QROWS payload rows of BN bytes, 16 per copy
    const int kq0 = payload_rows<FMT>(k0);
    for (int v = tid; v < C::QROWS * (BN / 16); v += THREADS) {
      const int r = v / (BN / 16), c = (v % (BN / 16)) * 16;
      const bool ok = (kq0 + r < KQ) && (n0 + c < N);
      const size_t off = ok ? (size_t)(kq0 + r) * N + n0 + c : 0;
      cp_async16(Bs0 + r * BN + c, W0 + off, ok);
      if (FUSED) cp_async16(Bs1 + r * BN + c, W1 + off, ok);
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
    const int nxt = kt + STAGES - 1;
    // issue the next stage's loads before the expand pass, so their latency
    // overlaps it (slot nxt % STAGES was last read in kt-1)
    if (nxt < nk) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();
    const bf16* As = reinterpret_cast<const bf16*>(smem + slot * C::STAGE_BYTES);
    // expand the compressed tile(s) of this slot into Xs; the barrier at
    // the top of this iteration ended every read of Xs by the last one
    const unsigned char* Qs = smem + slot * C::STAGE_BYTES + C::A_BYTES;
    expand_tile_bf16<FMT, THREADS, LDB, BK>(Xs0, Qs, Ss0);
    if (FUSED)
      expand_tile_bf16<FMT, THREADS, LDB, BK>(Xs1, Qs + C::Q_BYTES, Ss1);
    __syncthreads();
    const bf16* Bs0 = Xs0;
    const bf16* Bs1 = Xs1;
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

// Row tiles per thread block: 1, except in the quantized 16-row (decode)
// kernel, whose blocks take TPC row tiles strided by gridDim.y.  At decode
// nearly every row tile is inactive (1,029 of 1,040 at T=2), and each
// inactive tile's block lives for one dependent load of its flag; the
// quantized kernel fits fewer blocks per SM than the dense one (shared
// memory and registers of the expand pass), so it loads the flags of TPC
// tiles together and writes their zeros in one block.  The stride keeps
// the schedule's leading (active) tiles in separate blocks.
template <int BM, int FMT>
__host__ __device__ constexpr int tiles_per_block() {
  return (FMT != kDense && BM == 16) ? 4 : 1;
}

template <int BM, int WARPS_M, int WARPS_N, bool FUSED, int ROWS, int FMT>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N, 2)
gemm_bf16_kernel(const bf16* __restrict__ x, const void* __restrict__ w0,
                 const void* __restrict__ w1, const float* __restrict__ s0,
                 const float* __restrict__ s1,
                 const int* __restrict__ block_expert,
                 const int* __restrict__ block_active,
                 const float* __restrict__ row_scale, bf16* __restrict__ out,
                 int K, int N, int block_m, int s_e, int s_n, int n_tiles) {
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int TPC = tiles_per_block<BM, FMT>();
  const int n0 = blockIdx.x * BN;
  if constexpr (TPC == 1) {
    const int m0 = blockIdx.y * ROWS;
    const int mb = m0 / block_m;
    if (block_active[mb] == 0) {
      store_zero_tile<bf16, ROWS, THREADS>(out, m0, n0, N);
      return;
    }
    gemm_bf16_tile<BM, WARPS_M, WARPS_N, FUSED, ROWS, FMT>(
        x, w0, w1, s0, s1, row_scale, out, K, N, s_e, s_n, m0, n0,
        (size_t)block_expert[mb]);
  } else {
    int act[TPC], ex[TPC];
#pragma unroll
    for (int t = 0; t < TPC; ++t) {       // independent loads, one latency
      const int tile = blockIdx.y + t * gridDim.y;
      const int mb = tile < n_tiles ? tile * ROWS / block_m : 0;
      act[t] = tile < n_tiles ? block_active[mb] : -1;
      ex[t] = tile < n_tiles ? block_expert[mb] : 0;
    }
#pragma unroll
    for (int t = 0; t < TPC; ++t) {
      const int m0 = (blockIdx.y + t * gridDim.y) * ROWS;
      if (act[t] == 0) {
        store_zero_tile<bf16, ROWS, THREADS>(out, m0, n0, N);
      } else if (act[t] > 0) {
        gemm_bf16_tile<BM, WARPS_M, WARPS_N, FUSED, ROWS, FMT>(
            x, w0, w1, s0, s1, row_scale, out, K, N, s_e, s_n, m0, n0,
            (size_t)ex[t]);
        __syncthreads();                  // shared memory is reused
      }
    }
  }
}

template <int BM, int WARPS_M, int WARPS_N, bool FUSED, int ROWS, int FMT>
inline void launch_bf16(dim3 grid, cudaStream_t s, const bf16* x,
                        const void* w0, const void* w1, const float* s0,
                        const float* s1, const int* be, const int* ba,
                        const float* rs, bf16* out, int K, int N, int block_m,
                        int s_e, int s_n) {
  constexpr int smem = Bf16Tiles<BM, FUSED, FMT>::SMEM;
  auto* kernel = gemm_bf16_kernel<BM, WARPS_M, WARPS_N, FUSED, ROWS, FMT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal surfaces as the launch's error
  constexpr int tpc = tiles_per_block<BM, FMT>();
  const int n_tiles = (int)grid.y;
  const dim3 g(grid.x, (n_tiles + tpc - 1) / tpc);
  kernel<<<g, 32 * WARPS_M * WARPS_N, smem, s>>>(
      x, w0, w1, s0, s1, be, ba, rs, out, K, N, block_m, s_e, s_n, n_tiles);
}

// ------------------------------------------------------------------ fp32
// int8/int4: the B tile is loaded from the compressed payload (4 bytes per
// thread and load) and dequantized to fp32 on its way into shared memory.
template <int BM, bool FUSED, int ROWS, int FMT, bool TRANS>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ x, const void* __restrict__ w0,
                const void* __restrict__ w1, const float* __restrict__ s0,
                const float* __restrict__ s1,
                const int* __restrict__ block_expert,
                const int* __restrict__ block_active,
                const float* __restrict__ row_scale, float* __restrict__ out,
                int K, int N, int block_m, int s_e, int s_n) {
  constexpr int THREADS = 256, BK = 16;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = BK + 4, LDB = BN + 4;
  constexpr bool QUANT = FMT != kDense;
  static_assert(ROWS <= BM && BM % 16 == 0, "tile rows");
  static_assert(!(TRANS && (QUANT || FUSED)), "TRANS: dense, one operand");
  __shared__ __align__(16) float As[BM * LDA];
  __shared__ __align__(16) float Bs0[BK * LDB];
  __shared__ __align__(16) float Bs1[FUSED ? BK * LDB : 4];
  __shared__ __align__(16) float Ss[QUANT ? (FUSED ? 2 : 1) * BN : 4];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * ROWS;
  const int mb = m0 / block_m;
  if (block_active[mb] == 0) {
    store_zero_tile<float, ROWS, THREADS>(out, m0, n0, N);
    return;
  }
  const size_t e = (size_t)block_expert[mb];
  const int KQ = payload_rows<FMT>(K);
  using WT = typename std::conditional<QUANT, unsigned char, float>::type;
  const WT* W0 = reinterpret_cast<const WT*>(w0) + e * KQ * N;
  const WT* W1 = FUSED ? reinterpret_cast<const WT*>(w1) + e * KQ * N
                       : nullptr;
  if constexpr (QUANT) {
    stage_scales<THREADS>(Ss, s0, e, n0, N, s_e, s_n);
    if (FUSED) stage_scales<THREADS>(Ss + BN, s1, e, n0, N, s_e, s_n);
    __syncthreads();
  }
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // dequantize 4 columns (c..c+3) of payload row pr of W into Bs: int8 one
  // row, int4 rows 2pr and 2pr+1
  auto load_quant = [&](float* Bs, const WT* W, const float* S, int k0,
                        int pr, int c) {
    const bool ok = n0 + c < N;
    const unsigned word =
        ok ? *reinterpret_cast<const unsigned*>(
                 W + (size_t)(payload_rows<FMT>(k0) + pr) * N + n0 + c)
           : 0u;
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (FMT == kInt8) {
        lo[j] = int8_value(word, j) * S[c + j];
      } else {
        lo[j] = int4_value(word, 2 * j) * S[c + j];
        hi[j] = int4_value(word, 2 * j + 1) * S[c + j];
      }
    }
    const int row = FMT == kInt4 ? 2 * pr : pr;
    *reinterpret_cast<float4*>(Bs + row * LDB + c) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
    if (FMT == kInt4)
      *reinterpret_cast<float4*>(Bs + (row + 1) * LDB + c) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
  };

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
    if constexpr (TRANS) {
      // W[e] is (N, K): 4 K values of column c, stored down the tile
      for (int v = tid; v < BN * (BK / 4); v += THREADS) {
        const int c = v / (BK / 4), r = (v % (BK / 4)) * 4;
        const float4 b = n0 + c < N
            ? *reinterpret_cast<const float4*>(W0 + (size_t)(n0 + c) * K
                                               + k0 + r)
            : z;
        Bs0[r * LDB + c] = b.x;
        Bs0[(r + 1) * LDB + c] = b.y;
        Bs0[(r + 2) * LDB + c] = b.z;
        Bs0[(r + 3) * LDB + c] = b.w;
      }
    } else if constexpr (!QUANT) {
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
    } else {
      for (int v = tid; v < payload_rows<FMT>(BK) * (BN / 4); v += THREADS) {
        const int pr = v / (BN / 4), c = (v % (BN / 4)) * 4;
        load_quant(Bs0, W0, Ss, k0, pr, c);
        if (FUSED) load_quant(Bs1, W1, Ss + BN, k0, pr, c);
      }
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
// fp32 in any weight format, and bf16 on int8/int4 weights (the bf16 dense
// path is launch() below, on the Hopper kernel)
template <bool FUSED, int FMT>
inline void launch_fmt(dim3 grid, cudaStream_t s, int rows, const void* x,
                       const void* w0, const void* w1, const float* s0,
                       const float* s1, const int* be, const int* ba,
                       const float* rs, void* out, int K, int N, int block_m,
                       int dtype, int s_e, int s_n) {
  if (dtype == kBF16) {
    if constexpr (FMT != kDense) {
      const bf16* xb = (const bf16*)x;
      bf16* o = (bf16*)out;
      if (rows == 128)
        launch_bf16<128, 4, 2, FUSED, 128, FMT>(grid, s, xb, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
      else if (rows == 16)
        launch_bf16<16, 1, 4, FUSED, 16, FMT>(grid, s, xb, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
      else
        launch_bf16<16, 1, 4, FUSED, 8, FMT>(grid, s, xb, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
    }
  } else {
    const float* xf = (const float*)x;
    float* o = (float*)out;
    if (rows == 128)
      gemm_f32_kernel<128, FUSED, 128, FMT, false><<<grid, 256, 0, s>>>(xf, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
    else if (rows == 16)
      gemm_f32_kernel<16, FUSED, 16, FMT, false><<<grid, 256, 0, s>>>(xf, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
    else
      gemm_f32_kernel<16, FUSED, 8, FMT, false><<<grid, 256, 0, s>>>(xf, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
  }
}

// w_format: 0 dense, 1 int8, 2 int4 (WFormat); the scales (int8/int4 only)
// are read at scale[e * s_e + n * s_n].  bf16 with dense weights runs the
// Hopper kernel (grouped_gemm_hopper.cuh) over the work lists that
// expert_tiles.cu builds into `scratch` from seg_start and the block
// arrays: both must be given; the other paths read neither.
template <bool FUSED>
inline int launch(const void* x, const void* w0, const void* w1,
                  const void* scale0, const void* scale1,
                  const void* seg_start, const void* block_expert,
                  const void* block_active, const void* row_scale,
                  void* scratch, void* out, int capacity, int K, int N,
                  int n_experts, int block_m, int dtype, int w_format,
                  int s_e, int s_n, void* stream) {
  if (capacity == 0 || N == 0) return moe_last_error();
  if (block_m <= 0 || block_m % 8 != 0 || capacity % block_m != 0
      || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (w_format != kDense && (scale0 == nullptr || (FUSED && scale1 == nullptr)
                             || s_e < 0 || s_n < 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* be = (const int*)block_expert;
  const int* ba = (const int*)block_active;
  const float* rs = (const float*)row_scale;
  if (dtype == kBF16 && w_format == kDense) {
    if (seg_start == nullptr || scratch == nullptr || n_experts <= 0)
      return (int)cudaErrorInvalidValue;
    if (K == 0)
      return (int)cudaMemsetAsync(out, 0, (size_t)capacity * N * 2, s);
    const hopper::WorkLists lists =
        hopper::work_lists(scratch, capacity, n_experts);
    const int err = hopper::launch_expert_tiles(
        (const int*)seg_start, be, ba, capacity / block_m, block_m,
        n_experts, capacity, lists, true, s);
    if (err != 0) return err;
    return moe_fwd::launch_hopper<FUSED>(x, w0, w1, rs, lists, out,
                                         capacity, K, N, n_experts, s);
  }
  // tile height: the largest of 128, 16, 8 that divides block_m
  const int rows = block_m % 128 == 0 ? 128 : (block_m % 16 == 0 ? 16 : 8);
  dim3 grid((N + BN - 1) / BN, capacity / rows);
  const float* s0 = (const float*)scale0;
  const float* s1 = (const float*)scale1;
  if (w_format == kDense)
    launch_fmt<FUSED, kDense>(grid, s, rows, x, w0, w1, s0, s1, be, ba, rs, out, K, N, block_m, dtype, s_e, s_n);
  else if (w_format == kInt8)
    launch_fmt<FUSED, kInt8>(grid, s, rows, x, w0, w1, s0, s1, be, ba, rs, out, K, N, block_m, dtype, s_e, s_n);
  else if (w_format == kInt4)
    launch_fmt<FUSED, kInt4>(grid, s, rows, x, w0, w1, s0, s1, be, ba, rs, out, K, N, block_m, dtype, s_e, s_n);
  else
    return (int)cudaErrorInvalidValue;
  return moe_last_error();
}

}  // namespace moe_gemm
