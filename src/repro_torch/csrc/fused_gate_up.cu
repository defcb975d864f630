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
// What the design does about it.  bf16 with dense weights: the Hopper
// kernel of grouped_gemm_hopper.cuh over tiles of at most 256 rows of one
// expert's run, each weight tile read once per 256 rows on either policy.
// A stage holds x's rows and the gate's and up's 64 columns of the same K
// slice, so one wgmma m64n128k16 computes both products from one A tile;
// silu(g) * u is formed in fp32 registers and stored once in bf16: neither
// g nor u reaches device memory.  fp32 (CUDA-core fmaf) and int8/int4
// (read compressed, expanded tile by tile on chip): the block-tiled
// template of grouped_gemm.cuh, the same A tile feeding both products.
#include "grouped_gemm.cuh"

// x (capacity, K), w_gate and w_up (E, K, N) in x's dtype or their
// int8/int4 payloads with their scales, the schedule's (E,) seg_start and
// block arrays, the work lists' scratch (bf16 dense only) -> out
// (capacity, N), every element written.
MOE_API int moe_fused_gate_up(const void* x, const void* w_gate,
                              const void* w_up, const void* wg_scale,
                              const void* wu_scale, const void* seg_start,
                              const void* block_expert,
                              const void* block_active, void* scratch,
                              void* out, int capacity, int K, int N,
                              int n_experts, int block_m, int dtype,
                              int w_format, int s_e, int s_n, void* stream) {
  return moe_gemm::launch<true>(x, w_gate, w_up, wg_scale, wu_scale,
                                seg_start, block_expert, block_active,
                                nullptr, scratch, out, capacity, K, N,
                                n_experts, block_m, dtype, w_format, s_e, s_n,
                                stream);
}
