// Fused gate+up grouped GEMM with the SiLU product in the epilogue:
// out[rows of expert e] = silu(x[rows] @ Wg[e]) * (x[rows] @ Wu[e]), zeros
// on the rows of inactive blocks.
//
// Replaces: src/repro/kernels/fused_gate_up.py, fused_gate_up (its Pallas
// _kernel), in the dense, int8 and int4 weight formats: the paper's key
// fusion (§3.3).
//
// What bounds it on the H100: at decode, weight bytes (two 2048 x 1408
// bf16 matrices, 11.5 MB, per used moonshot expert, for a few rows each).
// At training's T = 4096 (moonshot: 28,672 active rows) the tensor cores:
// 331 GFLOP, 0.33 ms, against 0.33 ms for the bytes.
//
// What the design does about it.  bf16: the Hopper kernels over tiles of
// one expert's run of rows, each weight tile read once per slice of its
// expert's rows on either policy (dense weights: grouped_gemm_hopper.cuh,
// up to 256 rows; int8/int4: grouped_gemm_hopper_quant.cuh, up to 128
// rows, the compressed tiles brought by TMA and expanded in registers under
// the products of the stage before).  Dense: a stage holds x's rows and
// the gate's and up's 64 columns of the same K slice, so one wgmma
// m64n128k16 computes both products from one A tile; int8/int4: each
// consumer thread expands the same columns of gate and up and multiplies
// both by the same x tile.  silu(g) * u is formed in fp32 registers and
// stored once in bf16: neither g nor u reaches device memory.  fp32
// (CUDA-core fmaf, every format): the block-tiled template of
// grouped_gemm.cuh, the same A tile feeding both products.
#include "grouped_gemm.cuh"

// x (capacity, K), w_gate and w_up (E, K, N) in x's dtype or their
// int8/int4 payloads with their scales, the schedule's (E,) seg_start and
// block arrays, the work lists' scratch (bf16 only), the bf16 kernels'
// tile shape (tile_rows, block_n): dense (256, 64) by default, or (128,
// 64), (128, 128); int8/int4 (256 or 128, 128) -> out (capacity, N), every
// element written.
MOE_API int moe_fused_gate_up(const void* x, const void* w_gate,
                              const void* w_up, const void* wg_scale,
                              const void* wu_scale, const void* seg_start,
                              const void* block_expert,
                              const void* block_active, void* scratch,
                              void* out, int capacity, int K, int N,
                              int n_experts, int block_m, int dtype,
                              int w_format, int s_e, int s_n, void* stream,
                              int tile_rows, int block_n) {
  return moe_gemm::launch<true>(x, w_gate, w_up, wg_scale, wu_scale,
                                seg_start, block_expert, block_active,
                                nullptr, scratch, out, capacity, K, N,
                                n_experts, block_m, dtype, w_format, s_e, s_n,
                                stream, tile_rows, block_n);
}
