// The forward's two grouped GEMMs in bf16 on int8 and int4 weights, on
// Hopper: B1 (grouped_gemm.cu, the row_scale epilogue) and B2
// (fused_gate_up.cu, the SiLU product epilogue), one kernel template over
// FUSED and the weight format FMT (kInt8, kInt4), over the dense kernel's
// work lists and with its TMA-store epilogue (grouped_gemm_hopper.cuh).
//
//   B1: out[rows of e] = (x[rows] @ deq(W[e])) * row_scale[rows]
//   B2: out[rows of e] = silu(x[rows] @ deq(Wg[e])) * (x[rows] @ deq(Wu[e]))
//   deq(W[e])[k, n] = bf16(float(q[e, k, n]) * scale[e * s_e + n * s_n])
//
// as the reference's dequant_weight_block: the product in fp32, rounded
// once to bf16 (s_n = 0 for per-expert scales).  Payloads: int8 (E, K, N);
// int4 (E, K/2, N), byte r holding K rows 2r (low nibble) and 2r + 1 (high
// nibble), sign-extended.  Only the compressed bytes cross device memory,
// and no expanded weight tile is ever written to shared memory.
//
// The product is computed transposed, out^T = W^T x^T, so that the weights
// are wgmma's A operand and can come from registers: each consumer thread
// reads its share of the compressed tile from shared memory (ldmatrix,
// transposed), expands it in registers to the bf16 A fragment, and issues
// wgmma m64nNk16 with x's rows as the N side (N = 16, 32, 64 or 128, the
// slice's rows rounded up).  So decode's few rows an expert cost a 64 x 16
// product, not a 64 x 64 one, and the expand needs no extra warpgroup,
// shared-memory round trip or barrier.  A fragment row m of a warp's 16 is
// weight column 2 (m % 8) + m / 8 of the warp's 16 (a permutation of the
// output columns, undone by the epilogue), so that a thread's two columns
// are adjacent bytes and one transposed ldmatrix of 16-bit elements hands
// each thread exactly the bytes its fragment needs.
//
// Work items: (expert tile of up to tile_rows rows, 128 output columns),
// walked as the dense kernel walks them, each in passes of at most 128
// rows (a tile past 128 rows reads its weights once per pass).  The row
// tile, 256 (the default) or 128, is the work lists' (expert_tiles.cu): it
// changes how the passes are dealt to the persistent blocks, never a
// pass, so the output is the same at either.  Consumer
// warpgroup wg takes output columns [64 wg, 64 wg + 64) of the item, of
// both weights for B2 (so gate and up of a column meet in one thread).  A
// stage (one 64-deep K slice) holds x's rows (K-major, by TMA with the
// 128-byte swizzle, a box of N rows) and the compressed tiles (by TMA with
// the 128-byte swizzle: 128 columns x 64 int8 or 32 int4 payload rows a
// weight, so that ldmatrix reads them without bank conflicts).  Past K or
// N, TMA reads zeros, which decode to 0.  One thread of warpgroup 2
// issues the loads; the ring is as deep as 227 KB allows beside the
// epilogue tiles (at most 6 stages).  setmaxnreg moves registers from
// warpgroup 2 (40) to the consumers (232): B2 at 128 rows holds two
// 64 x 128 accumulators and two buffers of fragments, so that a stage's
// expand runs while the stage before is multiplied.
#pragma once

#include "grouped_gemm_hopper.cuh"

namespace moe_fwd {

constexpr int QBN = 128;                 // output columns a work item

template <bool FUSED, int FMT>
struct QuantStage {
  static_assert(FMT == kInt8 || FMT == kInt4, "int8 or int4 payloads");
  static constexpr int NW = FUSED ? 2 : 1;           // weights an item
  static constexpr int BKQ = FMT == kInt4 ? BK / 2 : BK;  // payload rows
  static constexpr int QBOX = BKQ * QBN;             // one weight's tile
  static constexpr int X_BYTES = 2 * SUB;            // up to 128 rows x 64 K
  static constexpr int BYTES = X_BYTES + NW * QBOX;
  static constexpr int EPI_WG = 2 * hopper::BOX;     // 128 rows x 64 cols
  using R = hopper::Ring<BYTES, 2 * EPI_WG>;
};

// Byte m of `word`, less BIAS, as a float: the byte goes into the mantissa
// of 2^23 and 2^23 + BIAS is subtracted, exactly, without the conversion
// unit (which runs at a fraction of the ALU rate)
template <int BIAS>
__device__ __forceinline__ float byte_value(unsigned word, int m) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 | m))
         - (8388608.0f + BIAS);
}
// two weights rounded to bf16 (nearest even) by one packed conversion, a
// in the low half
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four transposed 8 x 8 matrices of 16-bit elements; lane i gives the
// address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (64 x N fp32, a warpgroup's fragment) += A (64 x 16 bf16, from
// registers) B (16 x N, K-major in shared memory)
template <int N>
struct WgmmaRS;
template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// The A fragments of one weight for the stage's four k16 steps, a[ks][4],
// for this thread's weight columns c and c + 1 (c = 16 w + 2 g of the
// warpgroup's 64, w the warp, g = lane / 4, t = lane % 4), from the
// stage's swizzled 128 x BKQ payload tile at `tile`; sc0, sc1 their
// scales.  Register j of step ks holds fragment row g + 8 (j % 2) (column
// c + j % 2) and K rows k, k + 1 (k = 16 ks + 2 t + 8 (j / 2)), the lower
// K row in the low half.
//   int8: an 8 x 8 matrix of 16-bit elements (two adjacent columns) over
// 8 K rows; transposed, lane (g, t) receives rows 2 t and 2 t + 1 of
// element g: the bytes (k, c), (k, c + 1), (k + 1, c), (k + 1, c + 1).
// Two ldmatrix x4 cover the 4 steps x 2 halves of 8 rows.
//   int4: one matrix a step over its 8 payload rows, ldmatrix row j taking
// payload row j / 2 + 4 (j % 2), so that lane (g, t) receives payload rows
// t and t + 4: bytes (k, c), (k, c + 1), (k + 8, c), (k + 8, c + 1), each
// holding K rows k and k + 1 (k = 16 ks + 2 t) in its two nibbles.
template <int FMT>
__device__ __forceinline__ void load_fragments(uint32_t (&a)[4][4],
                                               uint32_t tile, int wg,
                                               float sc0, float sc1) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
  const int chunk = 4 * wg + w;          // the warp's 16 columns
  const int j = lane % 8, mi = lane / 8;
  if constexpr (FMT == kInt8) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t r[4];
      // matrix mi: step 2 half + mi / 2, K rows 8 (mi % 2) + j of it
      const int k = 16 * (2 * half + mi / 2) + 8 * (mi % 2) + j;
      ldsm_x4_trans(r, tile + k * 128 + ((chunk ^ (k & 7)) << 4));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ks = 2 * half + m / 2, hi = m % 2;
        // r[m]: bytes (k, c), (k, c + 1), (k + 1, c), (k + 1, c + 1)
        const uint32_t v = r[m] ^ 0x80808080u;
        a[ks][2 * hi] = bf16x2_bits(byte_value<128>(v, 0) * sc0,
                                    byte_value<128>(v, 2) * sc0);
        a[ks][2 * hi + 1] = bf16x2_bits(byte_value<128>(v, 1) * sc1,
                                        byte_value<128>(v, 3) * sc1);
      }
    }
  } else {
    uint32_t r[4];
    const int p = 8 * mi + j / 2 + 4 * (j % 2);      // payload row
    ldsm_x4_trans(r, tile + p * 128 + ((chunk ^ (p & 7)) << 4));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // r[ks]: bytes (k, c), (k, c + 1), (k + 8, c), (k + 8, c + 1); low
      // nibbles K row k (k + 8), high k + 1 (k + 9)
      const uint32_t x = r[ks] ^ 0x88888888u;
      const uint32_t lo = x & 0x0F0F0F0Fu, hi = (x >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float s = m % 2 ? sc1 : sc0;
        a[ks][m] = bf16x2_bits(byte_value<8>(lo, m) * s,
                               byte_value<8>(hi, m) * s);
      }
    }
  }
}

// One transposed accumulator (64 columns x N rows; this thread's rows n
// = 8 i + 2 t and n + 1 of columns c and c + 1) into epi as the output's
// 64-row x 128-byte boxes (TMA's 128-byte swizzle), the row scale (B1) on
// each row; bf16x2 stores of the two adjacent columns.
template <int N>
__device__ __forceinline__ void stage_tile_t(const float (&d)[N / 2],
                                             unsigned char* epi,
                                             const float* rs) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
  const int c = 16 * w + 2 * (lane / 4), t = lane % 4;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 8 * i + 2 * t + h, r = n % 64;
      const float s = rs != nullptr ? rs[n] : 1.f;
      *reinterpret_cast<uint32_t*>(
          epi + (n / 64) * hopper::BOX + r * 128
          + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2) =
          bf16x2_bits(d[4 * i + h] * s, d[4 * i + 2 + h] * s);
    }
  }
}

// One stage's products: wait for it, expand this thread's fragments of
// each weight into `a` (while the products of the stage before, on the
// other buffer, run), issue the products, and once the stage before has
// been read (wgmma_wait<1>) release it
template <int N, bool FUSED, int FMT>
__device__ __forceinline__ void quant_stage(
    float (&acc)[QuantStage<FUSED, FMT>::NW][N / 2],
    uint32_t (&a)[QuantStage<FUSED, FMT>::NW][4][4], hopper::PipeState& p,
    int& prev, uint32_t ring, uint32_t full, uint32_t empty, int wg,
    const float (&sc)[2][2]) {
  using namespace hopper;
  using St = QuantStage<FUSED, FMT>;
  mbar_wait(full + 8 * p.stage, p.phase);
  const uint32_t st = ring + p.stage * St::BYTES;
#pragma unroll
  for (int m = 0; m < St::NW; ++m)
    load_fragments<FMT>(a[m], st + St::X_BYTES + m * St::QBOX, wg, sc[m][0],
                        sc[m][1]);
#pragma unroll
  for (int m = 0; m < St::NW; ++m) fence_acc(acc[m]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    const uint64_t db = make_desc(st + 32 * ks, 16, 1024);    // x, K-major
#pragma unroll
    for (int m = 0; m < St::NW; ++m) WgmmaRS<N>::run(acc[m], a[m][ks], db);
  }
  wgmma_commit();
  wgmma_wait<1>();                // the stage before and its fragments done
#pragma unroll
  for (int m = 0; m < St::NW; ++m) fence_acc(acc[m]);
  if (prev >= 0) mbar_arrive(empty + 8 * prev);
  prev = p.stage;
  p.advance<St::R::STAGES>();
}

// One pass of an item over x's rows [row0, row0 + rows) (rows <= N), this
// warpgroup's 64 output columns from n0: the k-loop over two fragment
// buffers, then the epilogue
template <int N, bool FUSED, int FMT>
__device__ __forceinline__ void quant_pass(
    hopper::PipeState& p, uint32_t ring, uint32_t full, uint32_t empty,
    int n_k, int wg, const float (&sc)[2][2], const float* row_scale,
    const CUtensorMap* out64, const CUtensorMap* out8, unsigned char* epi,
    float* rs_smem, int n0, int row0, int rows) {
  using namespace hopper;
  using St = QuantStage<FUSED, FMT>;
  float acc[St::NW][N / 2];
#pragma unroll
  for (int m = 0; m < St::NW; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
  uint32_t a0[St::NW][4][4], a1[St::NW][4][4];
  int prev = -1;
  for (int kt = 0; kt < n_k; kt += 2) {
    quant_stage<N, FUSED, FMT>(acc, a0, p, prev, ring, full, empty, wg, sc);
    if (kt + 1 < n_k)
      quant_stage<N, FUSED, FMT>(acc, a1, p, prev, ring, full, empty, wg,
                                 sc);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < St::NW; ++m) fence_acc(acc[m]);
  mbar_arrive(empty + 8 * prev);
  // the epilogue: B2's silu(g) * u, B1's row scale, one rounding to bf16
  epilogue_begin(wg);
  const float* rs = nullptr;
  if (!FUSED && row_scale != nullptr) {
    // the pass's row scales, zero past its rows, through shared memory
    const int t = threadIdx.x % 128;
    if (t < N) rs_smem[wg * 128 + t] = t < rows ? row_scale[row0 + t] : 0.f;
    wg_sync(1 + wg);
    rs = rs_smem + wg * 128;
  }
  if constexpr (FUSED) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      acc[0][i] = silu_mul_sfu(acc[0][i], acc[1][i]);
  }
  stage_tile_t<N>(acc[0], epi, rs);
  epilogue_staged(wg);
  if (threadIdx.x % 128 == 0) {
    for (int h = 0; 64 * h < rows; ++h)
      store_staged<64>(out64, out8, epi + h * BOX, n0 + 64 * wg,
                       row0 + 64 * h, min(64, rows - 64 * h));
    bulk_commit();
  }
}

// A block's walk over its (work item, 128-row pass, k stage) sequence,
// skipping zero tiles (the TMA thread's; the consumers walk the same
// sequence in their own loop)
struct Walk {
  int it, pass = 0, kt = 0;
  int4 tile;
  __device__ __forceinline__ void seek(const int4* tiles, int items,
                                       int n_nt) {
    for (; it < items; it += gridDim.x) {
      tile = tiles[it / n_nt];
      if (tile.x >= 0) return;
    }
  }
  __device__ __forceinline__ void next(const int4* tiles, int items,
                                       int n_nt, int n_k) {
    if (++kt < n_k) return;
    kt = 0;
    if (128 * ++pass < tile.z) return;
    pass = 0;
    it += gridDim.x;
    seek(tiles, items, n_nt);
  }
};

// The N of a pass of `rows` rows (16, 32, 64 or 128): x's box rows and
// the products' width (rows past the pass are loaded or read as zeros,
// computed and never stored: the product's columns are independent)
__device__ __forceinline__ int quant_n(int rows) {
  return rows > 64 ? 128 : (rows > 32 ? 64 : (rows > 16 ? 32 : 16));
}

// The kernel of B1 (FUSED false: q1 and s1 unused, row_scale or nullptr)
// and B2 (FUSED true: q0/s0 the gate, q1/s1 the up weight, no row_scale)
template <bool FUSED, int FMT>
__global__ void __launch_bounds__(hopper::THREADS, 1)
fwd_quant_kernel(const __grid_constant__ CUtensorMap x128,
                 const __grid_constant__ CUtensorMap x64,
                 const __grid_constant__ CUtensorMap x32,
                 const __grid_constant__ CUtensorMap x16,
                 const __grid_constant__ CUtensorMap q0,
                 const __grid_constant__ CUtensorMap q1,
                 const __grid_constant__ CUtensorMap out64,
                 const __grid_constant__ CUtensorMap out8,
                 const int4* __restrict__ tiles,
                 const int* __restrict__ n_tiles,
                 const float* __restrict__ s0, const float* __restrict__ s1,
                 const float* __restrict__ row_scale, int s_e, int s_n,
                 int K, int N) {
  using namespace hopper;
  using St = QuantStage<FUSED, FMT>;
  constexpr int S = St::R::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + St::R::BAR_OFF, empty = full + 8 * S;
  float* rs_smem = reinterpret_cast<float*>(smem + St::R::BAR_OFF + 16 * S);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_nt = (N + QBN - 1) / QBN, n_k = (K + BK - 1) / BK;
  const int items = *n_tiles * n_nt;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                                   // the TMA thread
    reg_dealloc<40>();
    if (threadIdx.x != 2 * 128) return;
    tma_prefetch(&x128); tma_prefetch(&x64); tma_prefetch(&x32);
    tma_prefetch(&x16); tma_prefetch(&q0);
    if (FUSED) tma_prefetch(&q1);
    PipeState p;
    Walk ld{(int)blockIdx.x};
    for (ld.seek(tiles, items, n_nt); ld.it < items;
         ld.next(tiles, items, n_nt, n_k)) {
      const int n0 = (ld.it % n_nt) * QBN, r = 128 * ld.pass;
      const int xn = quant_n(min(128, ld.tile.z - r));
      const CUtensorMap* xmap = xn == 128 ? &x128 : xn == 64 ? &x64
                                : xn == 32 ? &x32 : &x16;
      mbar_wait(empty + 8 * p.stage, p.phase ^ 1u);
      const uint32_t fb = full + 8 * p.stage;
      const uint32_t st = ring + p.stage * St::BYTES;
      mbar_expect_tx(fb, xn * 128 + St::NW * St::QBOX);
      tma_load_2d(st, xmap, fb, ld.kt * BK, ld.tile.y + r);
      tma_load_3d(st + St::X_BYTES, &q0, fb, n0, ld.kt * St::BKQ,
                  ld.tile.x);
      if (FUSED)
        tma_load_3d(st + St::X_BYTES + St::QBOX, &q1, fb, n0,
                    ld.kt * St::BKQ, ld.tile.x);
      p.advance<S>();
    }
  } else {                                         // consumers
    reg_alloc<232>();
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
    const int c = 64 * wg + 16 * w + 2 * (lane / 4);   // in the item
    PipeState p;
    unsigned char* epi = smem + St::R::EPI_OFF + wg * St::EPI_WG;
    bool zeros_staged = false;          // epi holds a zero slab already
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int4 tile = tiles[it / n_nt];
      const int n0 = (it % n_nt) * QBN;
      if (tile.x < 0) {
        store_zeros<QBN>(&out64, &out8, epi, wg, n0, tile, zeros_staged);
        continue;
      }
      zeros_staged = false;
      float sc[2][2];                 // the item's scales of columns c, c+1
#pragma unroll
      for (int m = 0; m < St::NW; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + c + h;
          sc[m][h] = col < N ? (m ? s1 : s0)[(size_t)tile.x * s_e
                                            + (size_t)col * s_n] : 0.f;
        }
      for (int r = 0; r < tile.z; r += 128) {
        const int rows = min(128, tile.z - r);
        const int row0 = tile.y + r;
        switch (quant_n(rows)) {
          case 16:
            quant_pass<16, FUSED, FMT>(p, ring, full, empty, n_k, wg, sc,
                                       row_scale, &out64, &out8, epi,
                                       rs_smem, n0, row0, rows);
            break;
          case 32:
            quant_pass<32, FUSED, FMT>(p, ring, full, empty, n_k, wg, sc,
                                       row_scale, &out64, &out8, epi,
                                       rs_smem, n0, row0, rows);
            break;
          case 64:
            quant_pass<64, FUSED, FMT>(p, ring, full, empty, n_k, wg, sc,
                                       row_scale, &out64, &out8, epi,
                                       rs_smem, n0, row0, rows);
            break;
          default:
            quant_pass<128, FUSED, FMT>(p, ring, full, empty, n_k, wg, sc,
                                        row_scale, &out64, &out8, epi,
                                        rs_smem, n0, row0, rows);
        }
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait<false>();
  }
}

// x (capacity, K) bf16, the payload(s) q0 (and q1 when FUSED) with their
// scales, the work lists (built for tiles of tile_rows rows) -> out
// (capacity, N), every element written
template <bool FUSED, int FMT>
int launch_quant(const void* x, const void* q0, const void* q1,
                 const float* s0, const float* s1, int s_e, int s_n,
                 const float* row_scale, hopper::WorkLists lists, void* out,
                 int capacity, int K, int N, int E, int tile_rows,
                 cudaStream_t s) {
  using St = QuantStage<FUSED, FMT>;
  CUtensorMap x128, x64, x32, x16, qm0, qm1, out64, out8;
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)capacity};
  const uint64_t sx[1] = {(uint64_t)K * 2};
  const uint32_t bx128[2] = {64, 128}, bx64[2] = {64, 64}, bx32[2] = {64, 32},
                 bx16[2] = {64, 16};
  const uint64_t KQ = FMT == kInt4 ? K / 2 : K;
  const uint64_t dq[3] = {(uint64_t)N, KQ, (uint64_t)E};
  const uint64_t sq[2] = {(uint64_t)N, KQ * N};
  const uint32_t bq[3] = {QBN, (uint32_t)St::BKQ, 1};
  const uint64_t dout[2] = {(uint64_t)N, (uint64_t)capacity};
  const uint64_t sout[1] = {(uint64_t)N * 2};
  const uint32_t bout64[2] = {64, 64}, bout8[2] = {64, 8};
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto swz = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hopper::tensor_map(&x128, x, 2, dx, sx, bx128)
      || !hopper::tensor_map(&x64, x, 2, dx, sx, bx64)
      || !hopper::tensor_map(&x32, x, 2, dx, sx, bx32)
      || !hopper::tensor_map(&x16, x, 2, dx, sx, bx16)
      || !hopper::encode_map(&qm0, u8, swz, q0, 3, dq, sq, bq)
      || !hopper::encode_map(&qm1, u8, swz, FUSED ? q1 : q0, 3, dq, sq, bq)
      || !hopper::tensor_map(&out64, out, 2, dout, sout, bout64)
      || !hopper::tensor_map(&out8, out, 2, dout, sout, bout8))
    return (int)cudaErrorInvalidValue;
  // the ring, the epilogue tiles, the barriers, then 2 x 128 row scales
  constexpr int smem = St::R::SMEM + 2 * 128 * 4;
  static_assert(smem <= 232448, "shared memory");
  const int most =
      hopper::max_tiles(capacity, E, tile_rows) * ((N + QBN - 1) / QBN);
  const int grid = most < moe_num_sms() ? most : moe_num_sms();
  auto* kernel = fwd_quant_kernel<FUSED, FMT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal surfaces as the launch's error
  kernel<<<grid, hopper::THREADS, smem, s>>>(
      x128, x64, x32, x16, qm0, qm1, out64, out8, lists.tiles, lists.count,
      s0, FUSED ? s1 : s0, row_scale, s_e, s_n, K, N);
  return moe_last_error();
}

}  // namespace moe_fwd
