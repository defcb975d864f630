// Block-scheduled grouped GEMM with an optional per-row scale epilogue:
// out[rows of expert e] = (x[rows] @ W[e]) * row_scale[rows], zeros on the
// rows of inactive blocks.
//
// Replaces: src/repro/kernels/grouped_gemm.py, grouped_gemm (its Pallas
// _kernel and dequant_weight_block), in the dense, int8 and int4 weight
// formats.  On the main path it is the MoE down projection with the top-k
// combine weights folded into its epilogue (and, in training's backward,
// the recompute of the gate and up products).
//
// What bounds it on the H100: at decode, weight bytes (each used expert's
// 1408 x 2048 bf16 = 5.8 MB for moonshot, for a few rows each, far below
// the ~295 FLOP/byte the card needs to be compute bound) and the zeros of
// the rows past the active blocks.  At training's T = 4096 (moonshot:
// 28,672 active rows) the tensor cores and the bytes alike: 165 GFLOP, 0.17
// ms, against 0.17 ms for the rows, the weights and the output.
//
// What the design does about it.  bf16: the Hopper kernels (TMA, wgmma,
// persistent blocks) over tiles of one expert's run of rows
// (expert_tiles.cu, built on the device), so each weight tile crosses
// device memory once per slice of its expert's rows on either policy, not
// once per schedule block; the combine weight is applied to the fp32
// accumulators, so the unscaled product never reaches device memory; zero
// tiles load nothing.  Dense weights (grouped_gemm_hopper.cuh): read
// MN-major as stored, slices of up to 256 rows.  int8 and int4 weights
// (grouped_gemm_hopper_quant.cuh; 1/2 and 1/4 of the bytes): TMA brings the
// compressed tiles, and the consumer threads expand them in registers into
// wgmma's A operand of the transposed product (x's rows the N side: 16 at
// decode), each stage's expand under the products of the stage before;
// slices of up to 128 rows.  fp32 (CUDA-core fmaf, never TF32):
// the block-tiled template of grouped_gemm.cuh, one thread block per
// (schedule-block row tile, 64 columns), in every format.
#include "grouped_gemm.cuh"

// x (capacity, K) of dtype `dtype` (MoeDtype), w (E, K, N) in x's dtype or
// its int8/int4 payload with w_scale, the schedule's (E,) seg_start and
// (capacity / block_m,) block arrays, row_scale (capacity,) f32 or null,
// the work lists' scratch (hopper_gemm.cuh work_lists; bf16 only), the
// bf16 kernels' tile shape (tile_rows, block_n): dense (256, 128) by
// default, or (256, 64), (128, 128), (128, 256); int8/int4 (256 or 128,
// 128) -> out (capacity, N), every element written.
MOE_API int moe_grouped_gemm(const void* x, const void* w,
                             const void* w_scale, const void* seg_start,
                             const void* block_expert,
                             const void* block_active, const void* row_scale,
                             void* scratch, void* out, int capacity, int K,
                             int N, int n_experts, int block_m, int dtype,
                             int w_format, int s_e, int s_n, void* stream,
                             int tile_rows, int block_n) {
  return moe_gemm::launch<false>(x, w, nullptr, w_scale, nullptr, seg_start,
                                 block_expert, block_active, row_scale,
                                 scratch, out, capacity, K, N, n_experts,
                                 block_m, dtype, w_format, s_e, s_n, stream,
                                 tile_rows, block_n);
}
