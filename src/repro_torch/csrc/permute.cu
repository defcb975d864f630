// Token permutation: out[i] = x[src_tok[i]], zeros where src_tok[i] < 0.
//
// Replaces: src/repro/kernels/permute.py, permute (its Pallas _kernel).
//
// What bounds it on the H100: activation bytes.  It reads each routed token
// row once per assignment and writes every one of the capacity rows once,
// padding included (the fixed schedule's capacity is the worst case, so at
// decode most of the rows written are zeros).
//
// Design: one thread block per output row; each thread moves 16 bytes per
// step (uint4), neighbouring threads on neighbouring addresses, so every
// warp issues 512-byte coalesced transactions.  The copy is of bytes, so one
// kernel serves bf16 and fp32; the wrapper checks that a row is a multiple
// of 16 bytes and that both tensors are contiguous.
#include "common.cuh"

namespace {

__global__ void permute_kernel(const uint4* __restrict__ x,
                               const int* __restrict__ src_tok,
                               uint4* __restrict__ out, int row_vecs) {
  const int i = blockIdx.x;
  const int src = src_tok[i];
  uint4* dst = out + (size_t)i * row_vecs;
  if (src < 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) dst[v] = z;
    return;
  }
  const uint4* s = x + (size_t)src * row_vecs;
  for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) dst[v] = s[v];
}

}  // namespace

MOE_API int moe_permute(const void* x, const void* src_tok, void* out,
                        int capacity, int row_bytes, void* stream) {
  if (capacity == 0) return moe_last_error();
  const int row_vecs = row_bytes / 16;
  const int threads = row_vecs >= 256 ? 256 : ((row_vecs + 31) / 32) * 32;
  permute_kernel<<<capacity, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (const int*)src_tok, (uint4*)out, row_vecs);
  return moe_last_error();
}
