// Block-scheduled grouped GEMM template shared by grouped_gemm.cu (one B
// operand, optional row_scale epilogue) and fused_gate_up.cu (two B
// operands, SiLU(g) * u epilogue) for fp32 inputs, in every weight format;
// and launch() at the end of this file, which sends bf16 inputs to the
// Hopper kernels over per-expert work lists: grouped_gemm_hopper.cuh on
// dense weights, grouped_gemm_hopper_quant.cuh on int8/int4 ones.
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
// multiple of 128 (the fixed policy), 16 when it is a multiple of 16, else
// 8 (the dynamic policy's 8-row sub-blocks; the 16-row kernel with rows
// 8-15 zero and never stored).  block_m must be a multiple of 8, K and N
// multiples of 16 (checked by the wrapper).
//
// CUDA-core fmaf (never TF32), each thread owning a (BM/16) x 4 micro-tile,
// so the result keeps full fp32 precision.  Epilogue in fp32 (row_scale
// multiply or SiLU product), one store.
//
// Weight formats (the compile-time parameter FMT, common.cuh's WFormat):
// kDense, kInt8, an (E, K, N) int8 payload, and kInt4, an (E, K/2, N) int8
// payload whose byte r holds logical K rows 2r (low nibble) and 2r+1 (high
// nibble), sign-extended; both with fp32 scales scale[e * s_e + n * s_n]
// (s_n = 0 for per-expert scales).  Each thread block dequantizes its own
// expert's weight tiles on chip, as the reference's dequant_weight_block
// does: float(q) * scale, on the tile's way into shared memory.  Inactive
// tiles get zeros, with neither weights nor scales read.
//
// Weight layout (the compile-time parameter TRANS, dense only; the
// instantiations with TRANS = false are the code above, unchanged): TRANS
// reads W[e] transposed in place, out[block m] = x[block m] @ W[e]^T, the
// backward's dX product in fp32 (grouped_gemm_t.cu; its bf16 form is a
// Hopper kernel of its own there).  Here K is the reduction (W's last
// axis) and N the output width (W's middle axis), so W[e] is (N, K)
// row-major: each thread loads 4 K values of one column and stores them
// down the (BK, BN) shared tile.  No transposed copy of the weights is ever
// built.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "grouped_gemm_hopper_quant.cuh"

namespace moe_gemm {

constexpr int BN = 64;

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

// float(v) of a byte or nibble without the conversion unit (which runs at
// a fraction of the ALU rate): v, biased into [0, 255], is placed in the
// mantissa of 2^23 and the bias subtracted, exactly.
__device__ __forceinline__ float int8_value(unsigned word, int j) {
  // byte j of word: (b ^ 0x80) = b + 128
  return moe_fwd::byte_value<128>(word ^ 0x80808080u, j);
}
__device__ __forceinline__ float int4_value(unsigned word, int i) {
  // nibble i (0-7) of word: (n ^ 8) = v + 8
  return __uint_as_float(0x4B000000u | (((word ^ 0x88888888u) >> (4 * i))
                                        & 0xFu)) - 8388616.0f;
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
// fp32 in any weight format (the bf16 paths are launch() below, on the
// Hopper kernels)
template <bool FUSED, int FMT>
inline void launch_f32(dim3 grid, cudaStream_t s, int rows, const float* x,
                       const void* w0, const void* w1, const float* s0,
                       const float* s1, const int* be, const int* ba,
                       const float* rs, float* out, int K, int N, int block_m,
                       int s_e, int s_n) {
  if (rows == 128)
    gemm_f32_kernel<128, FUSED, 128, FMT, false><<<grid, 256, 0, s>>>(x, w0, w1, s0, s1, be, ba, rs, out, K, N, block_m, s_e, s_n);
  else if (rows == 16)
    gemm_f32_kernel<16, FUSED, 16, FMT, false><<<grid, 256, 0, s>>>(x, w0, w1, s0, s1, be, ba, rs, out, K, N, block_m, s_e, s_n);
  else
    gemm_f32_kernel<16, FUSED, 8, FMT, false><<<grid, 256, 0, s>>>(x, w0, w1, s0, s1, be, ba, rs, out, K, N, block_m, s_e, s_n);
}

// w_format: 0 dense, 1 int8, 2 int4 (WFormat); the scales (int8/int4 only)
// are read at scale[e * s_e + n * s_n].  bf16 runs the Hopper kernels
// (grouped_gemm_hopper.cuh on dense weights, grouped_gemm_hopper_quant.cuh
// on int8/int4 ones) over the work lists that expert_tiles.cu builds into
// `scratch` from seg_start and the block arrays: both must be given; fp32
// reads neither.  (tile_rows, block_n) is the Hopper kernels' tile shape:
// on dense weights one of launch_hopper_shape's set, on int8/int4 ones
// (256 or 128, QBN); any other is refused.  fp32's one tile reads neither.
template <bool FUSED>
inline int launch(const void* x, const void* w0, const void* w1,
                  const void* scale0, const void* scale1,
                  const void* seg_start, const void* block_expert,
                  const void* block_active, const void* row_scale,
                  void* scratch, void* out, int capacity, int K, int N,
                  int n_experts, int block_m, int dtype, int w_format,
                  int s_e, int s_n, void* stream, int tile_rows,
                  int block_n) {
  if (capacity == 0 || N == 0) return moe_last_error();
  if (block_m <= 0 || block_m % 8 != 0 || capacity % block_m != 0
      || K % 16 != 0 || N % 16 != 0
      || (w_format != kDense && w_format != kInt8 && w_format != kInt4))
    return (int)cudaErrorInvalidValue;
  if (w_format != kDense && (scale0 == nullptr || (FUSED && scale1 == nullptr)
                             || s_e < 0 || s_n < 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* be = (const int*)block_expert;
  const int* ba = (const int*)block_active;
  const float* rs = (const float*)row_scale;
  const float* s0 = (const float*)scale0;
  const float* s1 = (const float*)scale1;
  if (dtype == kBF16) {
    if (seg_start == nullptr || scratch == nullptr || n_experts <= 0
        || (tile_rows != 256 && tile_rows != 128)
        || (w_format != kDense && block_n != moe_fwd::QBN))
      return (int)cudaErrorInvalidValue;
    if (K == 0)
      return (int)cudaMemsetAsync(out, 0, (size_t)capacity * N * 2, s);
    const hopper::WorkLists lists =
        hopper::work_lists(scratch, capacity, n_experts, tile_rows);
    const int err = hopper::launch_expert_tiles(
        (const int*)seg_start, be, ba, capacity / block_m, block_m,
        n_experts, capacity, lists, true, s, tile_rows);
    if (err != 0) return err;
    if (w_format == kInt8)
      return moe_fwd::launch_quant<FUSED, kInt8>(
          x, w0, w1, s0, s1, s_e, s_n, rs, lists, out, capacity, K, N,
          n_experts, tile_rows, s);
    if (w_format == kInt4)
      return moe_fwd::launch_quant<FUSED, kInt4>(
          x, w0, w1, s0, s1, s_e, s_n, rs, lists, out, capacity, K, N,
          n_experts, tile_rows, s);
    return moe_fwd::launch_hopper_shape<FUSED>(x, w0, w1, rs, lists, out,
                                               capacity, K, N, n_experts,
                                               tile_rows, block_n, s);
  }
  // tile height: the largest of 128, 16, 8 that divides block_m
  const int rows = block_m % 128 == 0 ? 128 : (block_m % 16 == 0 ? 16 : 8);
  const dim3 grid((N + BN - 1) / BN, capacity / rows);
  const float* xf = (const float*)x;
  float* o = (float*)out;
  if (w_format == kDense)
    launch_f32<FUSED, kDense>(grid, s, rows, xf, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
  else if (w_format == kInt8)
    launch_f32<FUSED, kInt8>(grid, s, rows, xf, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
  else
    launch_f32<FUSED, kInt4>(grid, s, rows, xf, w0, w1, s0, s1, be, ba, rs, o, K, N, block_m, s_e, s_n);
  return moe_last_error();
}

}  // namespace moe_gemm
