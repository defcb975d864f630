// Unpermute + combine: out[t] = sum_c w[t,c] * y[pos[t,c]] (or the
// unweighted sum when the combine weights were folded into the down
// projection), summed in fp32 in c order, then cast to y's type.
//
// Replaces: src/repro/kernels/unpermute.py, unpermute (its Pallas _kernel).
//
// What bounds it on the H100: activation bytes, T*k rows of y read and T
// rows written; a few MB on the main path.
//
// Design: one thread block per token.  Each thread owns 8 consecutive
// elements of the row (one 16-byte bf16 vector, two fp32 vectors), keeps
// eight fp32 accumulators in registers across the k gathered rows, and
// stores once.  Blocks of 256 threads, several to an SM, once the tokens
// fill the card; with fewer tokens than SMs each block has a thread per
// vector (up to 1024), so that a row, deepseek-v2's 5120 columns too, is
// one pass.  The Pallas kernel revisits its output block k times
// through a VMEM scratch; here the k-loop lives inside the block and the
// sum never leaves registers.  Multiplies and adds are the rounded
// intrinsics (no fused multiply-add), so the result is the plain version's
// bit for bit.
//
// Tried and not kept (PERF.md, commit 27453a3): tiles of tokens x slices
// of columns gathered by 1-D bulk copies (cp.async.bulk) into a two-stage
// shared-memory ring, a producer warp issuing every row of a tile at once.
// It won where few tokens meet wide rows (deepseek-v2 T=2: 4.1 -> 2.4 us,
// which the one-pass blocks above now take too) but lost 1-3 % at
// T=4096, where this kernel already moves 2.85 TB/s, and 3-11 % at
// moonshot's T=64: the copy's round trip through shared memory lengthens
// the chain that small T is made of.
#include "common.cuh"

namespace {

template <typename T>
__global__ void unpermute_kernel(const T* __restrict__ y,
                                 const int* __restrict__ pos,
                                 const float* __restrict__ w,
                                 T* __restrict__ out, int k, int d) {
  const int t = blockIdx.x;
  for (int base = threadIdx.x * 8; base < d; base += blockDim.x * 8) {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    for (int c = 0; c < k; ++c) {
      const int p = pos[(size_t)t * k + c];
      const T* src = y + (size_t)p * d + base;
      alignas(16) T vals[8];
      if (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
      } else {
        reinterpret_cast<uint4*>(vals)[0] = reinterpret_cast<const uint4*>(src)[0];
        reinterpret_cast<uint4*>(vals)[1] = reinterpret_cast<const uint4*>(src)[1];
      }
      if (w != nullptr) {
        const float wc = w[(size_t)t * k + c];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(to_f32(vals[q]), wc));
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = __fadd_rn(acc[q], to_f32(vals[q]));
      }
    }
    alignas(16) T res[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) res[q] = from_f32<T>(acc[q]);
    T* dst = out + (size_t)t * d + base;
    if (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(res);
    } else {
      reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(res)[0];
      reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(res)[1];
    }
  }
}

}  // namespace

MOE_API int moe_unpermute(const void* y, const void* pos, const void* weights,
                          void* out, int T, int k, int d, int dtype,
                          void* stream) {
  if (T == 0) return moe_last_error();
  const int vecs = d / 8, most = T < moe_num_sms() ? 1024 : 256;
  const int threads = vecs >= most ? most : ((vecs + 31) / 32) * 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16) {
    unpermute_kernel<__nv_bfloat16><<<T, threads, 0, s>>>(
        (const __nv_bfloat16*)y, (const int*)pos, (const float*)weights,
        (__nv_bfloat16*)out, k, d);
  } else {
    unpermute_kernel<float><<<T, threads, 0, s>>>(
        (const float*)y, (const int*)pos, (const float*)weights, (float*)out,
        k, d);
  }
  return moe_last_error();
}
