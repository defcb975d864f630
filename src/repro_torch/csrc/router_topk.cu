// Fused gating + iterative top-k router.
//
// Replaces: src/repro/kernels/router_topk.py, router_topk (its Pallas _kernel).
//
// What bounds it on the H100: activation bytes.  It reads T*E fp32 logits
// once and writes T*k weights and indices: a few hundred KB at most on the
// main path, a few microseconds at 3.35 TB/s, so launch latency dominates.
//
// Design: one warp per token row, E <= 256, so each lane keeps up to eight
// scores in registers and the row is read from device memory exactly once.
// Softmax subtracts the row max (warp shuffle reductions); sigmoid is
// per element.  Top-k is k rounds of a warp argmax that breaks ties toward
// the lowest expert index, masking the winner to -inf, so indices equal the
// plain version's exactly (no torch.topk).  Renormalisation divides by the
// sequential sum of the k weights + 1e-20, then routed_scale multiplies
// only when it is not 1.0, as in router_topk.py:49-53.
#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 8;      // E <= 256
constexpr int kMaxTopK = 16;
constexpr int kWarpsPerBlock = 4;

__global__ void router_topk_kernel(const float* __restrict__ logits,
                                   float* __restrict__ w_out,
                                   int* __restrict__ i_out, int T, int E,
                                   int k, int gating_sigmoid, int norm_topk,
                                   float routed_scale) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;
  const float* row = logits + (size_t)t * E;
  const float NEG_INF = -__int_as_float(0x7f800000);

  float s[kMaxPerLane];
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    int e = lane + 32 * c;
    s[c] = (e < E) ? row[e] : NEG_INF;
  }

  if (gating_sigmoid) {
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c)
      if (lane + 32 * c < E) s[c] = 1.0f / (1.0f + expf(-s[c]));
  } else {
    float m = NEG_INF;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) m = fmaxf(m, s[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) {
      s[c] = (lane + 32 * c < E) ? expf(s[c] - m) : 0.f;
      sum += s[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c)
      s[c] = (lane + 32 * c < E) ? s[c] / sum : NEG_INF;
  }

  float masked[kMaxPerLane];
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) masked[c] = (lane + 32 * c < E) ? s[c] : NEG_INF;

  float wsel[kMaxTopK];
  for (int j = 0; j < k; ++j) {
    // lane-local best: largest value, lowest index among equals
    float bv = NEG_INF;
    int bi = E;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) {
      int e = lane + 32 * c;
      if (e < E && (masked[c] > bv || (masked[c] == bv && e < bi))) {
        bv = masked[c];
        bi = e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    // the owner lane reads the unmasked score and masks its entry
    float wv = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) {
      if (lane + 32 * c == bi) {
        wv = s[c];
        masked[c] = NEG_INF;
      }
    }
    const int owner = bi & 31;
    wv = __shfl_sync(0xffffffffu, wv, owner);
    wsel[j] = wv;
    if (lane == 0) i_out[(size_t)t * k + j] = bi;
  }

  if (lane == 0) {
    if (norm_topk) {
      float tot = 0.f;
      for (int j = 0; j < k; ++j) tot += wsel[j];
      tot += 1e-20f;
      for (int j = 0; j < k; ++j) wsel[j] = wsel[j] / tot;
    }
    if (routed_scale != 1.0f)
      for (int j = 0; j < k; ++j) wsel[j] = wsel[j] * routed_scale;
    for (int j = 0; j < k; ++j) w_out[(size_t)t * k + j] = wsel[j];
  }
}

}  // namespace

MOE_API int moe_router_topk(const void* logits, void* weights, void* indices,
                            int T, int E, int k, int gating_sigmoid,
                            int norm_topk, float routed_scale, void* stream) {
  if (T == 0) return moe_last_error();
  dim3 grid((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
  router_topk_kernel<<<grid, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (float*)weights, (int*)indices, T, E, k,
      gating_sigmoid, norm_topk, routed_scale);
  return moe_last_error();
}
