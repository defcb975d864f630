// Hopper (sm_90a) building blocks shared by the grouped GEMMs in bf16: the
// forward's B1 and B2 on dense weights (grouped_gemm_hopper.cuh) and on
// int8/int4 ones (grouped_gemm_hopper_quant.cuh), and the backward's B7,
// the grouped weight gradient (grouped_wgrad.cu), and B1 with its weight
// read transposed, the dX product (grouped_gemm_t.cu); the PTX helpers and
// the wgmma shapes also serve the bf16 MLA decode kernel
// (paged_attention.cu).
//
// The shape of the kernels (the "usual shape of a fast kernel" on this
// card): persistent thread blocks, one per SM, each walking a list of work
// items (one output tile each) strided by the grid; a ring of
// shared-memory stages, each one BK-deep slice of the reduction for both
// operands, filled by TMA (cp.async.bulk.tensor, 128-byte swizzle) from one
// producer thread and completed on an mbarrier (bytes counted by the
// hardware); two consumer warpgroups that run wgmma.mma_async
// (m64n128k16, bf16 in, fp32 accumulators in registers; the forward's B1
// and B2 also m64n64k16 and m64n256k16, by tile shape) on the stages that
// have arrived, each owning half the tile's rows (64, or 128 with two
// accumulators), and release each stage on a second mbarrier once the
// tensor cores have read it.
// setmaxnreg moves registers from the producer warpgroup (40) to the
// consumers (232).  The epilogue rounds each warpgroup's tile to the
// output dtype into swizzled shared memory, and one thread stores it with
// TMA (cp.async.bulk.tensor) asynchronously, in whole 128-byte lines: the
// warpgroup goes straight back to the next item's products, whose stages
// the producer, running ahead across items, has already loaded.
//
// Shared memory (Ring): the stages (each 1024-byte aligned, as the
// 128-byte swizzle requires), the epilogue tiles, then the full and empty
// barriers.  A stage holds 64 x 64 bf16 sub-tiles of 8 KB (SUB): a
// 128-byte row per tile row, 8-row groups of 1024 bytes, swizzled as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes them and wgmma's 128-byte-swizzle
// descriptor reads them.
//
// The work lists come from expert_tiles.cu: per expert, the run of rows
// of its active schedule blocks, and for B1, B2 and B1^T the (expert,
// row0, rows) tiles over those runs plus the zero tiles past the active
// blocks.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace hopper {

constexpr int BM = 128;          // B7's dW tile rows: 2 warpgroups x 64
constexpr int BK = 64;           // reduction rows per stage (128 bytes)
constexpr int THREADS = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
constexpr int SUB = 64 * 64 * 2; // one swizzled 64 x 64 bf16 sub-tile
constexpr int BOX = 64 * 128;    // one swizzled 64-row x 128-byte box

// The shared-memory layout of a kernel whose stage holds STAGE bytes and
// whose epilogue stages EPI bytes of output: as many stages (at most 6) as
// fit beside the epilogue tiles in the 227 KB a block may use, the
// epilogue tiles, the full and empty barriers; 1 KB of slack aligns it.
template <int STAGE, int EPI>
struct Ring {
  static constexpr int LIMIT = 232448 - 1024 - 256;
  static constexpr int FIT = (LIMIT - EPI) / STAGE;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int EPI_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = EPI_OFF + EPI;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(STAGES >= 3 && STAGE % 1024 == 0, "ring");
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the producer's arrival, announcing the bytes its loads will complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// wait until the barrier's phase of parity `parity` has completed; an
// arrival that never comes traps after about ten seconds (a launch error)
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (16ll << 30)) __trap();
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// one box of `map` at coordinates (c0 innermost, c1[, c2]) into shared
// memory at dst; coordinates past the tensor's extent read zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1) : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

// shared -> global copy of one box (coordinates as for the loads; the
// parts past the tensor's extent are not written), tracked by bulk groups
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the committed stores have read their shared memory (READ) or are
// complete
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// make this thread's shared-memory writes visible to TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier over one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading byte offset (K-major: unused; MN-major: the stride between
// 64-element atoms along M or N) and stride byte offset (between 8-row
// groups), all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 fp32, a warpgroup's fragment) += A (64 x 16) B (16 x 128);
// TA / TB = 1 reads that operand MN-major (its M or N index contiguous)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64 fp32) += A (64 x 16) B (16 x 64), both in shared memory;
// TA / TB as for wgmma_m64n128k16
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256 fp32) += A (64 x 16) B (16 x 256), both in shared memory;
// TA / TB as for wgmma_m64n128k16
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The same with N = 16 and 32 (d: 64 x N fp32), for the MLA decode
// kernel's scores (paged_attention.cu)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256 fp32) += A (64 x 16 bf16, from registers: this thread's
// fragment, as quant's WgmmaRS takes it) B (16 x 256 in shared memory;
// TB = 1 reads it MN-major), for the MLA kernel's PV product
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// the ring's position: stage index and the parity of its current round
struct PipeState {
  int stage = 0;
  uint32_t phase = 0;
  template <int S>
  __device__ __forceinline__ void advance() {
    if (++stage == S) { stage = 0; phase ^= 1u; }
  }
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogue: a warpgroup's 64 x 2 NF fp32 fragment (NF = 64: 128
// columns; NF = 32: 64), rounded to OT, into shared memory at epi as boxes
// of 64 rows x 128 bytes in TMA's 128-byte swizzle (the 16-byte chunk index
// XOR the row mod 8), ready for tma_store_*: box j holds columns [j W,
// (j + 1) W), W = 128 / sizeof(OT).  Thread t holds rows 16 (t / 32) +
// (t % 32) / 4 and 8 below it, columns 8 i + 2 (t % 4) and the next, i <
// NF / 4: a warp's pairs of one i fall on distinct banks.
template <typename OT, int NF>
__device__ __forceinline__ void stage_tile(const float (&d)[NF],
                                           unsigned char* epi) {
  constexpr int W = 128 / (int)sizeof(OT);
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int i = 0; i < NF / 4; ++i) {
    const int c = 8 * i + 2 * (t % 4);
    const int byte = (c % W) * (int)sizeof(OT);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      const int off = (c / W) * BOX + row * 128
                      + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
      store2(reinterpret_cast<OT*>(epi + off), d[4 * i + 2 * h],
             d[4 * i + 2 * h + 1]);
    }
  }
}

// Before a warpgroup stages its next tile: its store thread waits until
// the last tile's stores have read the shared memory, then the warpgroup
// meets.  After staging: fence, meet; then the store thread starts the
// stores.
__device__ __forceinline__ void epilogue_begin(int wg) {
  if (threadIdx.x % 128 == 0) bulk_wait<true>();
  wg_sync(1 + wg);
}
__device__ __forceinline__ void epilogue_staged(int wg) {
  fence_async_smem();
  wg_sync(1 + wg);
}

// ----------------------------------------------------------------- host
// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library links against the runtime alone
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` (2 or 3) dimensions, innermost first (dims in
// elements, the outer strides in bytes), moved in boxes of `box` elements
// of type `type` with swizzle `swizzle`; false if CUDA refuses it
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       CUtensorMapSwizzle swizzle, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) { d[i] = dims[i]; b[i] = box[i]; }
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, b,
            es, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
// the same with the 128-byte swizzle, bf16 unless `fp32`
inline bool tensor_map(CUtensorMap* map, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box, bool fp32 = false) {
  return encode_map(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides,
                    box);
}

// ----------------------------------------------------- the work lists
// Scratch of the work lists (int32 words, allocated by the wrapper as
// kernels/expert_tiles.py's scratch() sizes it): the tiles (int4 each:
// expert or -1 for a zero tile, row0, rows, 0; at most tile_rows rows),
// then the per-expert runs (int2: first row, end row), then the count.
// tile_rows is TILE_ROWS for B7 and B1^T, and the row tile that the caller
// chose for the forward's B1 and B2 (256 or 128).
// max_tiles: the runs and the uncovered spans between them are at most
// 2E + 1 spans (expert_tiles.cu derives the bound)
constexpr int TILE_ROWS = 256;
__host__ __device__ inline int max_tiles(int capacity, int n_experts,
                                         int tile_rows = TILE_ROWS) {
  return (capacity + tile_rows - 1) / tile_rows + 2 * n_experts;
}
struct WorkLists {
  int4* tiles;
  int2* runs;
  int* count;
};
inline WorkLists work_lists(void* scratch, int capacity, int n_experts,
                            int tile_rows = TILE_ROWS) {
  int* w = static_cast<int*>(scratch);
  const int nt = max_tiles(capacity, n_experts, tile_rows);
  return {reinterpret_cast<int4*>(w), reinterpret_cast<int2*>(w + 4 * nt),
          w + 4 * nt + 2 * n_experts};
}
constexpr int MAX_EXPERTS = 1024;

// expert_tiles.cu: fill `lists` (laid out for tile_rows) from the schedule
// (runs always; the tiles of at most tile_rows rows and their count when
// with_tiles).  Returns cudaGetLastError().
int launch_expert_tiles(const int* seg_start, const int* block_expert,
                        const int* block_active, int n_blocks, int block_m,
                        int n_experts, int capacity, WorkLists lists,
                        bool with_tiles, cudaStream_t stream,
                        int tile_rows = TILE_ROWS);

}  // namespace hopper
