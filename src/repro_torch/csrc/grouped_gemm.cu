// Block-scheduled grouped GEMM with an optional per-row scale epilogue:
// out[block m] = (x[block m] @ W[block_expert[m]]) * row_scale[rows].
//
// Replaces: src/repro/kernels/grouped_gemm.py, grouped_gemm (its Pallas
// _kernel and dequant_weight_block), in the dense, int8 and int4 weight
// formats.  On the main path it is the MoE down projection with the top-k
// combine weights folded into its epilogue.
//
// What bounds it on the H100: at decode, weight bytes.  Each active schedule
// block reads one expert's whole (K, N) matrix (1408 x 2048 bf16 = 5.8 MB
// for moonshot) for at most 128 useful rows, far below the ~295 FLOP/byte
// the card needs to be compute bound.  At prefill with every block full
// (mixtral-8x7b, T=512) the product is compute bound.
//
// What the design does about it: a block's expert weights are read exactly
// once per 128-row schedule block (BM = block_m = 128), inactive blocks never
// touch the weights, and the combine weight is applied in the fp32 epilogue
// so the unscaled product never reaches device memory.  int8 and int4
// weights move 1/2 and 1/4 of the bytes: the compressed tiles are expanded
// on chip (grouped_gemm.cuh).  The template is in grouped_gemm.cuh.
#include "grouped_gemm.cuh"

MOE_API int moe_grouped_gemm(const void* x, const void* w,
                             const void* w_scale, const void* block_expert,
                             const void* block_active, const void* row_scale,
                             void* out, int capacity, int K, int N,
                             int block_m, int dtype, int w_format, int s_e,
                             int s_n, void* stream) {
  return moe_gemm::launch<false>(x, w, nullptr, w_scale, nullptr,
                                 block_expert, block_active, row_scale, out,
                                 capacity, K, N, block_m, dtype, w_format,
                                 s_e, s_n, stream);
}
