// The forward's two grouped GEMMs in bf16 with dense weights, on Hopper
// (hopper_gemm.cuh): B1 (grouped_gemm.cu, one weight, the row_scale
// epilogue) and B2 (fused_gate_up.cu, the gate and up weights, the SiLU
// product epilogue), one kernel body for both.
//
//   B1: out[rows of expert e] = (x[rows] @ W[e]) * row_scale[rows]
//   B2: out[rows of expert e] = silu(x[rows] @ Wg[e]) * (x[rows] @ Wu[e])
//
// x (capacity, K), W (E, K, N) as stored -> (capacity, N) bf16: fp32
// accumulation, the epilogue in fp32 on the accumulators, one rounding to
// bf16, exact zeros on every row past the active blocks.
//
// Work items (as grouped_gemm_t.cu's): from expert_tiles.cu's list, built
// on the device from the schedule, (expert e, a slice of at most TR rows
// of e's run of rows, one column tile of BN output columns), walked
// expert-major by persistent blocks, then the zero tiles past the active
// blocks.  A weight tile is read once for all of a slice's rows, so an
// expert's weights cross device memory once per TR rows on either policy,
// not once per schedule block (the dynamic policy's 8-row blocks).  Rows of a slice
// past its run belong to the next expert: they are loaded and computed,
// never stored (runs end on multiples of 8, so the last 64-row slab of a
// run is stored in 8-row boxes).  Zero tiles load nothing: each consumer
// warpgroup stages a zero tile once and stores it wherever one is due.
//
// Operands.  A is x, K-major (64 K values of each row per stage), in a
// TMA box of 256, 128 or 64 rows as the slice needs.  B is W[e] (K, N)
// read MN-major (N contiguous), as TMA brings in 64 K-rows x 64 N-columns
// through a 3-D tensor map over (N, K, E) (K rows past K and columns past N
// read zeros), with wgmma's transpose flag: no transposed copy of the
// weights.  B1's stage holds W's BN columns [n0, n0 + BN); B2's holds Wg's
// BN columns [n0, n0 + BN) then Wu's same BN, so one m64n(2 BN)k16 product
// computes gate and up of BN output columns together from one A stage (the
// paper's fusion, §3.3): in the fragment, gate's value of an output column
// sits BN / 2 registers before up's.
//
// Tile shapes (the template parameters TR, BN: rows a slice, output
// columns an item), chosen per call from the instantiated set below
// (kernels/grouped_gemm.py TILE_SHAPES; the tune cache picks one per shape
// key, repro_torch/tuning).  The product columns of an item, PC = BN (B1)
// or 2 BN (B2), are 64, 128 or 256: one wgmma m64nPCk16.  With TR = 256,
// over 128 rows each consumer warpgroup takes 128 rows with two m64nPC
// accumulators (PC <= 128: at most 128 registers a thread, within the 232
// setmaxnreg gives), otherwise one 64-row slab; with TR = 128 one slab of
// 64 rows and one accumulator (up to m64n256: 128 registers).  A
// warpgroup whose slab lies past the slice (a slice of at most 64 rows:
// decode) issues no products.  No shape splits K: each output element is
// the same sequence of k16 products in any of them.
#pragma once

#include "hopper_gemm.cuh"

namespace moe_fwd {

using hopper::BK;
using hopper::SUB;
using bf16 = __nv_bfloat16;

// The instantiated tile shapes (TR, BN); the first of each is the default
// (kernels/grouped_gemm.py TILE_SHAPES holds the same lists)
//   B1: (256, 128), (256, 64), (128, 128), (128, 256)
//   B2: (256, 64), (128, 64), (128, 128)
// B2 at (256, 128) would need two m64n256 accumulators: 256 registers.
template <bool FUSED, int TR_, int BN_>
struct FwdStage {
  static constexpr int TR = TR_;                     // rows a slice
  static constexpr int BN = BN_;                     // output columns an item
  static constexpr int PC = FUSED ? 2 * BN : BN;     // product columns
  static constexpr int NF = PC / 2;                  // accumulator registers
  static constexpr int A_BYTES = (TR / 64) * SUB;    // up to TR rows x 64 K
  static constexpr int B_BYTES = (PC / 64) * SUB;    // 64 K x PC columns
  static constexpr int BYTES = A_BYTES + B_BYTES;
  static constexpr int EPI_WG = 64 * BN * 2;         // one bf16 slab
  using R = hopper::Ring<BYTES, 2 * EPI_WG>;
  static_assert(TR == 256 || TR == 128, "slices of 256 or 128 rows");
  static_assert(PC == 64 || PC == 128 || PC == 256, "m64n64/128/256");
  static_assert(TR == 128 || PC <= 128, "two accumulators within 232 regs");
};

// d (64 x PC fp32) += A (64 x 16, K-major) B (16 x PC, MN-major)
template <int PC>
__device__ __forceinline__ void wgmma_fwd(float (&d)[PC / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (PC == 64) hopper::wgmma_m64n64k16<0, 1>(d, da, db);
  else if constexpr (PC == 128) hopper::wgmma_m64n128k16<0, 1>(d, da, db);
  else hopper::wgmma_m64n256k16<0, 1>(d, da, db);
}

// silu(g) * u with the special-function unit's exp and reciprocal: a few
// fp32 ulps from an IEEE expf and division, below bf16's rounding
// (B2's outputs differ from that form's by at most one bf16 ulp), and 7 %
// of B2 at moonshot's T = 4096, where the epilogue holds up both consumer
// warpgroups
__device__ __forceinline__ float silu_mul_sfu(float g, float u) {
  return __fdividef(g, 1.0f + __expf(-g)) * u;
}

// The x rows a slice of `rows` rows loads: a 256-, 128- or 64-row box
__device__ __forceinline__ int a_rows(int rows) {
  return rows > 128 ? 256 : (rows > 64 ? 128 : 64);
}

// The k-loop of one item: NACC = 2 (slices over 128 rows) reads A slabs
// 2 wg and 2 wg + 1 into acc0 and acc1, NACC = 1 slab wg into acc0; `on`
// false (the warpgroup's slab is past the slice) waits for and releases
// each stage without products
template <int NACC, int S, class St>
__device__ __forceinline__ void mainloop(float (&acc0)[St::NF],
                                         float (&acc1)[St::NF],
                                         hopper::PipeState& p, uint32_t ring,
                                         uint32_t full, uint32_t empty,
                                         int n_k, int wg, bool on) {
  using namespace hopper;
  if (!on) {
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(full + 8 * p.stage, p.phase);
      mbar_arrive(empty + 8 * p.stage);
      p.advance<S>();
    }
    return;
  }
  int prev = -1;
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(full + 8 * p.stage, p.phase);
    // A K-major: 8-row groups 1 KB apart, each k16 step 32 bytes along the
    // row; B MN-major: 64-column atoms 8 KB apart, each k16 step 16 K-rows
    // = 2 KB further
    const uint32_t st = ring + p.stage * St::BYTES;
    const uint32_t a = st + (NACC == 2 ? 2 * wg : wg) * SUB;
    const uint32_t b = st + St::A_BYTES;
    fence_acc(acc0);
    if constexpr (NACC == 2) fence_acc(acc1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t db = make_desc(b + 2048 * ks, SUB, 1024);
      wgmma_fwd<St::PC>(acc0, make_desc(a + 32 * ks, 16, 1024), db);
      if constexpr (NACC == 2)
        wgmma_fwd<St::PC>(acc1, make_desc(a + SUB + 32 * ks, 16, 1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();                     // the previous stage has been read
    fence_acc(acc0);
    if constexpr (NACC == 2) fence_acc(acc1);
    if (prev >= 0) mbar_arrive(empty + 8 * prev);
    prev = p.stage;
    p.advance<S>();
  }
  wgmma_wait<0>();
  fence_acc(acc0);
  if constexpr (NACC == 2) fence_acc(acc1);
  if (prev >= 0) mbar_arrive(empty + 8 * prev);
}

// One staged 64-row slab stored from epi: rows from r0, `rows` of them (a
// whole 64-row box, or the 8-row groups inside the run); columns past N
// are clipped by the tensor map.  Issued by the warpgroup's first thread.
template <int BN>
__device__ __forceinline__ void store_staged(const CUtensorMap* out64,
                                             const CUtensorMap* out8,
                                             unsigned char* epi, int n0,
                                             int r0, int rows) {
  using namespace hopper;
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) {
    const uint32_t src = smem_addr(epi) + j * BOX;
    if (rows >= 64)
      tma_store_2d(out64, src, n0 + 64 * j, r0);
    else
      for (int g = 0; 8 * g < rows; ++g)
        tma_store_2d(out8, src + 1024 * g, n0 + 64 * j, r0 + 8 * g);
  }
}

// The epilogue of one 64-row slab of an expert's item (rows r0 .. r0 +
// rows of the output, rows > 0; uniform in the warpgroup): B1 scales each
// row by row_scale (read for the stored rows only), B2 forms silu(g) * u;
// then one rounding to bf16 into epi and the slab's stores.
template <bool FUSED, class St>
__device__ __forceinline__ void store_slab(float (&d)[St::NF],
                                           const float* __restrict__ row_scale,
                                           const CUtensorMap* out64,
                                           const CUtensorMap* out8,
                                           unsigned char* epi, int wg, int n0,
                                           int r0, int rows) {
  using namespace hopper;
  constexpr int BN = St::BN;
  epilogue_begin(wg);
  if constexpr (FUSED) {
    float h[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) h[j] = silu_mul_sfu(d[j], d[j + BN / 2]);
    stage_tile<bf16>(h, epi);
  } else {
    if (row_scale != nullptr) {
      const int t = threadIdx.x % 128;
      const int r = (t / 32) * 16 + (t % 32) / 4;
      const float s0 = r < rows ? row_scale[r0 + r] : 0.f;
      const float s1 = r + 8 < rows ? row_scale[r0 + r + 8] : 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        d[4 * i] *= s0;
        d[4 * i + 1] *= s0;
        d[4 * i + 2] *= s1;
        d[4 * i + 3] *= s1;
      }
    }
    stage_tile<bf16>(d, epi);
  }
  epilogue_staged(wg);
  if (threadIdx.x % 128 == 0) {
    store_staged<BN>(out64, out8, epi, n0, r0, rows);
    bulk_commit();
  }
}

// A zero tile (past the active blocks): this warpgroup's 64-row slabs
// are 2 s + wg.  It stages a zero slab in epi once (`staged` says epi holds
// one already) and stores it wherever one is due; nothing is loaded.
template <int BN>
__device__ __forceinline__ void store_zeros(const CUtensorMap* out64,
                                            const CUtensorMap* out8,
                                            unsigned char* epi, int wg,
                                            int n0, int4 tile, bool& staged) {
  using namespace hopper;
  if (!staged) {
    float z[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) z[i] = 0.f;
    epilogue_begin(wg);
    stage_tile<bf16>(z, epi);
    epilogue_staged(wg);
    staged = true;
  }
  if (threadIdx.x % 128 == 0) {
    for (int r0 = 64 * wg; r0 < tile.z; r0 += 128)
      store_staged<BN>(out64, out8, epi, n0, tile.y + r0,
                       min(64, tile.z - r0));
    bulk_commit();
  }
}

// The kernel of B1 (FUSED false: w1 unused, row_scale or nullptr) and B2
// (FUSED true: w0 the gate, w1 the up weight, no row_scale), at tile shape
// (TR, BN)
template <bool FUSED, int TR, int BN_>
__global__ void __launch_bounds__(hopper::THREADS, 1)
fwd_hopper_kernel(const __grid_constant__ CUtensorMap x256,
                  const __grid_constant__ CUtensorMap x128,
                  const __grid_constant__ CUtensorMap x64,
                  const __grid_constant__ CUtensorMap w0,
                  const __grid_constant__ CUtensorMap w1,
                  const __grid_constant__ CUtensorMap out64,
                  const __grid_constant__ CUtensorMap out8,
                  const int4* __restrict__ tiles,
                  const int* __restrict__ n_tiles,
                  const float* __restrict__ row_scale, int K, int N) {
  using namespace hopper;
  using St = FwdStage<FUSED, TR, BN_>;
  constexpr int S = St::R::STAGES, STAGE = St::BYTES, BN = St::BN;
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
  const int n_nt = (N + BN - 1) / BN, n_k = (K + BK - 1) / BK;
  const int items = *n_tiles * n_nt;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                                   // producer
    reg_dealloc<40>();
    if (threadIdx.x != 2 * 128) return;
    if (TR > 128) tma_prefetch(&x256);
    tma_prefetch(&x128); tma_prefetch(&x64);
    tma_prefetch(&w0);
    if (FUSED) tma_prefetch(&w1);
    PipeState p;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int4 tile = tiles[it / n_nt];
      if (tile.x < 0) continue;                    // a zero tile
      const int n0 = (it % n_nt) * BN;
      const int ar = a_rows(tile.z);
      const CUtensorMap* amap = ar == 256 ? &x256 : (ar == 128 ? &x128 : &x64);
      const uint32_t bytes = (ar / 64) * SUB + St::B_BYTES;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(empty + 8 * p.stage, p.phase ^ 1u);
        const uint32_t fb = full + 8 * p.stage;
        const uint32_t a = ring + p.stage * STAGE, b = a + St::A_BYTES;
        mbar_expect_tx(fb, bytes);
        tma_load_2d(a, amap, fb, kt * BK, tile.y);
        // B1: W's columns n0, n0 + 64, ...; B2: Wg's, then Wu's
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load_3d(b + j * SUB, &w0, fb, n0 + 64 * j, kt * BK, tile.x);
          if (FUSED)
            tma_load_3d(b + (BN / 64 + j) * SUB, &w1, fb, n0 + 64 * j,
                        kt * BK, tile.x);
        }
        p.advance<S>();
      }
    }
  } else {                                         // consumers
    reg_alloc<232>();
    PipeState p;
    unsigned char* epi = smem + St::R::EPI_OFF + wg * St::EPI_WG;
    bool zeros_staged = false;          // epi holds a zero slab already
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int4 tile = tiles[it / n_nt];
      const int n0 = (it % n_nt) * BN;
      if (tile.x < 0) {
        store_zeros<BN>(&out64, &out8, epi, wg, n0, tile, zeros_staged);
        continue;
      }
      zeros_staged = false;
      const bool two = TR > 128 && tile.z > 128;
      // this warpgroup's rows: 128 w + [0, 128) of the tile, or 64 w + [0, 64)
      const int r0 = (two ? 128 : 64) * wg;
      float acc0[St::NF], acc1[TR > 128 ? St::NF : 1];
#pragma unroll
      for (int i = 0; i < St::NF; ++i) acc0[i] = 0.f;
      if constexpr (TR > 128) {
#pragma unroll
        for (int i = 0; i < St::NF; ++i) acc1[i] = 0.f;
        if (two)
          mainloop<2, S, St>(acc0, acc1, p, ring, full, empty, n_k, wg, true);
        else
          mainloop<1, S, St>(acc0, acc1, p, ring, full, empty, n_k, wg,
                             r0 < tile.z);
      } else {
        mainloop<1, S, St>(acc0, acc0, p, ring, full, empty, n_k, wg,
                           r0 < tile.z);
      }
      if (r0 < tile.z)
        store_slab<FUSED, St>(acc0, row_scale, &out64, &out8, epi, wg, n0,
                              tile.y + r0, min(64, tile.z - r0));
      if constexpr (TR > 128) {
        if (two && r0 + 64 < tile.z)
          store_slab<FUSED, St>(acc1, row_scale, &out64, &out8, epi, wg, n0,
                                tile.y + r0 + 64, min(64, tile.z - r0 - 64));
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait<false>();
  }
}

// x (capacity, K), the (E, K, N) weight(s) w0 (and w1 when FUSED), the
// work lists (built for tiles of TR rows) -> out (capacity, N), every
// element written
template <bool FUSED, int TR, int BN>
int launch_hopper(const void* x, const void* w0, const void* w1,
                  const float* row_scale, hopper::WorkLists lists, void* out,
                  int capacity, int K, int N, int E, cudaStream_t s) {
  using St = FwdStage<FUSED, TR, BN>;
  CUtensorMap x256, x128, x64, wm0, wm1, out64, out8;
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)capacity};
  const uint64_t sx[1] = {(uint64_t)K * 2};
  const uint32_t bx256[2] = {64, 256}, bx128[2] = {64, 128},
                 bx64[2] = {64, 64};
  const uint64_t dw[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t sw[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t bw[3] = {64, 64, 1};
  const uint64_t dout[2] = {(uint64_t)N, (uint64_t)capacity};
  const uint64_t sout[1] = {(uint64_t)N * 2};
  const uint32_t bout64[2] = {64, 64}, bout8[2] = {64, 8};
  if (!hopper::tensor_map(&x256, x, 2, dx, sx, bx256)
      || !hopper::tensor_map(&x128, x, 2, dx, sx, bx128)
      || !hopper::tensor_map(&x64, x, 2, dx, sx, bx64)
      || !hopper::tensor_map(&wm0, w0, 3, dw, sw, bw)
      || !hopper::tensor_map(&wm1, FUSED ? w1 : w0, 3, dw, sw, bw)
      || !hopper::tensor_map(&out64, out, 2, dout, sout, bout64)
      || !hopper::tensor_map(&out8, out, 2, dout, sout, bout8))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = St::R::SMEM;
  const int most =
      hopper::max_tiles(capacity, E, TR) * ((N + St::BN - 1) / St::BN);
  const int grid = most < moe_num_sms() ? most : moe_num_sms();
  auto* kernel = fwd_hopper_kernel<FUSED, TR, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal surfaces as the launch's error
  kernel<<<grid, hopper::THREADS, smem, s>>>(x256, x128, x64, wm0, wm1, out64,
                                             out8, lists.tiles, lists.count,
                                             row_scale, K, N);
  return moe_last_error();
}

// The Hopper kernel at tile shape (tile_rows, block_n), one of the
// instantiated set; any other shape is refused (cudaErrorInvalidValue)
template <bool FUSED>
int launch_hopper_shape(const void* x, const void* w0, const void* w1,
                        const float* row_scale, hopper::WorkLists lists,
                        void* out, int capacity, int K, int N, int E,
                        int tile_rows, int block_n, cudaStream_t s) {
#define MOE_FWD_SHAPE(TR, BN)                                                \
  if (tile_rows == TR && block_n == BN)                                      \
    return launch_hopper<FUSED, TR, BN>(x, w0, w1, row_scale, lists, out,    \
                                        capacity, K, N, E, s);
  if constexpr (FUSED) {
    MOE_FWD_SHAPE(256, 64)
    MOE_FWD_SHAPE(128, 64)
    MOE_FWD_SHAPE(128, 128)
  } else {
    MOE_FWD_SHAPE(256, 128)
    MOE_FWD_SHAPE(256, 64)
    MOE_FWD_SHAPE(128, 128)
    MOE_FWD_SHAPE(128, 256)
  }
#undef MOE_FWD_SHAPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace moe_fwd
