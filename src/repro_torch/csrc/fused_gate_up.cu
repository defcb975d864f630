// Fused gate+up grouped GEMM with the SiLU product in the epilogue:
// out[block m] = silu(x @ Wg[e]) * (x @ Wu[e]),  e = block_expert[m].
//
// Replaces: src/repro/kernels/fused_gate_up.py, fused_gate_up (its Pallas
// _kernel), in the dense, int8 and int4 weight formats: the paper's key
// fusion (§3.3).
//
// What bounds it on the H100: at decode, weight bytes.  Each active schedule
// block reads two (K, F) expert matrices (2 x 2048 x 1408 bf16 = 11.5 MB for
// moonshot) for at most 128 useful rows.  At prefill with full blocks
// (mixtral-8x7b, T=512) it is compute bound.
//
// What the design does about it: one A tile in shared memory feeds both
// products, each weight tile is read once per 128-row schedule block,
// inactive blocks skip the weights, and the gate and up products live only
// in fp32 registers: the SiLU product is formed there and stored once, so
// neither intermediate reaches device memory.  int8 and int4 weights are
// read compressed and expanded tile by tile on chip.  The template is in
// grouped_gemm.cuh.
#include "grouped_gemm.cuh"

MOE_API int moe_fused_gate_up(const void* x, const void* w_gate,
                              const void* w_up, const void* wg_scale,
                              const void* wu_scale, const void* block_expert,
                              const void* block_active, void* out,
                              int capacity, int K, int N, int block_m,
                              int dtype, int w_format, int s_e, int s_n,
                              void* stream) {
  return moe_gemm::launch<true>(x, w_gate, w_up, wg_scale, wu_scale,
                                block_expert, block_active, nullptr, out,
                                capacity, K, N, block_m, dtype, w_format, s_e,
                                s_n, stream);
}
