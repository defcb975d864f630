// Fused gating + top-k router: softmax or sigmoid of each row of (T, E)
// fp32 logits, then the k largest scores, ties to the lowest expert index
// (the order of the reference's k rounds of argmax), optionally
// renormalised by their sum + 1e-20, then times routed_scale when it is
// not 1.0, as in router_topk.py:49-53.
//
// Replaces: src/repro/kernels/router_topk.py, router_topk (its Pallas _kernel).
//
// What bounds it on the H100: not bytes (T*E*4 read, T*k*8 written: 0.37
// us at T=4096 E=64) but the chain of dependent steps in one row, on top of
// the launch.  The first port took the k picks as k rounds of a warp
// argmax, each a 5-step shuffle butterfly over (value, index) and a
// broadcast: about 70 shuffles in series at k=6.
//
// Design: all k picks in one pass, by ranking.  A score and its expert are
// one 64-bit key, the score's bits over ~expert: scores are never negative
// (softmax and sigmoid), so their bits order as unsigned integers, and
// among equal scores the lower expert has the larger key.  A key's rank,
// the number of larger keys in its row, is its pick slot: rank j is the
// reference's j-th argmax.  Every lane ranks its own keys at once and the
// pickers store in parallel; no round waits on another.
//   - E <= 32: a row takes L = next_pow2(E) lanes, one key each, and a warp
//     takes 32 / L rows (mixtral's E=8: 4 rows a warp).  Each lane counts
//     the larger keys among its row's L in shared memory.
//   - E > 32: a warp takes a row, a lane the keys of experts lane + 32c.
//     Ranking every key against the row costs E^2/32 compares a lane (2,048
//     at E=256); instead the k-th largest of the 32 lanes' largest keys,
//     tau, prunes the row: the k lane maxima at or above it outrank every
//     key below it, so only keys >= tau (about k of them) can be picked,
//     and a key's rank among those is its rank in the row.  The lane maxima
//     are ranked (32 compares), the n keys >= tau are compacted by ballot
//     into shared memory, and each lane ranks candidates lane, lane + 32,
//     ... against all n: 32 + ceil(n/32) * n compares a lane.  Only the k
//     lanes whose maxima reach tau hold candidates, and of the k-th only
//     tau itself, so n <= (k-1) * E/32 + 1 (57 at E=256 k=8, where every
//     key of the k-1 leading lanes outranks tau: 114 compares, not the 456
//     of ranking every key of a lane); on random logits n is about k + 1,
//     one pass of n compares (and exactly k on a row of equal scores, whose
//     keys order by expert).  The picks go to shared memory by rank, and
//     lane j < k stores pick j.  This replaces splitting a row across the
//     warps of a block, which would have cut the compares by the number of
//     warps at the cost of a block barrier and cross-warp reductions.
// Measured against the k argmax rounds (chip_gemm_ab.py --arms route, H100
// 80GB HBM3 at 700 W, device us at T=2 / 4096): E=8 k=2 2.6 / 4.6 -> 1.7 /
// 1.8; E=64 k=6 4.2 / 9.1 -> 2.1 / 3.8; E=160 k=6 4.2 / 9.0 -> 2.5 / 4.5;
// E=256 k=8 5.0 / 11.5 -> 2.7 / 5.7, and on the rows of most candidates
// 5.0 / 11.4 -> 4.0 / 9.2.  The ranking is faster at every E timed, so the
// rounds are gone.
// The gating arithmetic is the first port's, in the same order (a lane's
// scores summed in c order, then the xor butterfly; padding adds exact
// zeros): scores, picks and weights are its bits.  expf and IEEE division
// throughout.  Renormalisation sums the k picked weights in slot order,
// from shared memory, as the reference's rounds would have stored them.
// NaN logits are outside the contract (the plain version fails on them).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;           // warps a block
constexpr int kMaxE = 256;
constexpr int kMaxTopK = 16;
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long Key;

__device__ __forceinline__ Key make_key(float score, int e) {
  return ((Key)__float_as_uint(score) << 32) | (unsigned)(~e);
}
__device__ __forceinline__ float key_score(Key key) {
  return __uint_as_float((unsigned)(key >> 32));
}
__device__ __forceinline__ int key_expert(Key key) {
  return (int)(~(unsigned)key);
}

// the renormalising divisor: the k picked weights (in `slot`, by rank)
// summed in slot order, + 1e-20; the loads unrolled ahead of the adds
__device__ __forceinline__ float slot_sum(const float* slot, int k) {
  float v[kMaxTopK];
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) v[j] = j < k ? slot[j] : 0.f;
  float tot = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j)
    if (j < k) tot += v[j];
  return tot + 1e-20f;
}

__device__ __forceinline__ float finish_weight(float w, float tot,
                                               int norm_topk,
                                               float routed_scale) {
  if (norm_topk) w = w / tot;
  if (routed_scale != 1.0f) w = w * routed_scale;
  return w;
}

// E <= 32: L lanes a row (L = next_pow2(E)), 32 / L rows a warp
template <int L>
__global__ void router_rows_kernel(const float* __restrict__ logits,
                                   float* __restrict__ w_out,
                                   int* __restrict__ i_out, int T, int E,
                                   int k, int gating_sigmoid, int norm_topk,
                                   float routed_scale) {
  constexpr int R = 32 / L;
  __shared__ Key keys[kWarps][32];
  __shared__ float slot[kWarps][32];        // R rows x k <= 32 slots
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane / L, e = lane % L;
  const int t = (blockIdx.x * kWarps + warp) * R + seg;
  const bool live = t < T && e < E;
  const float NEG_INF = -__int_as_float(0x7f800000);

  float s = live ? logits[(size_t)t * E + e] : NEG_INF;
  if (gating_sigmoid) {
    if (live) s = 1.0f / (1.0f + expf(-s));
  } else {
    float m = s;
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    s = live ? expf(s - m) : 0.f;
    float sum = s;
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    s = s / sum;
  }
  const Key key = live ? make_key(s, e) : 0ull;
  keys[warp][lane] = key;
  __syncwarp();
  int rank = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) rank += keys[warp][seg * L + j] > key;
  const bool pick = live && rank < k;
  float* row_slot = &slot[warp][seg * k];
  if (pick) {
    i_out[(size_t)t * k + rank] = e;
    row_slot[rank] = s;
  }
  __syncwarp();
  const float tot = norm_topk ? slot_sum(row_slot, k) : 1.f;
  if (pick)
    w_out[(size_t)t * k + rank] = finish_weight(s, tot, norm_topk,
                                                routed_scale);
}

// E > 32: a warp a row, PER = ceil(E / 32) keys a lane (experts lane + 32c)
template <int PER>
__global__ void router_wide_kernel(const float* __restrict__ logits,
                                   float* __restrict__ w_out,
                                   int* __restrict__ i_out, int T, int E,
                                   int k, int gating_sigmoid, int norm_topk,
                                   float routed_scale) {
  __shared__ Key cand[kWarps][kMaxE];
  __shared__ Key lane_max[kWarps][32];
  __shared__ float slot[kWarps][kMaxTopK];
  __shared__ int slot_e[kWarps][kMaxTopK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= T) return;
  const float* row = logits + (size_t)t * E;
  const float NEG_INF = -__int_as_float(0x7f800000);

  float s[PER];
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int e = lane + 32 * c;
    s[c] = (e < E) ? row[e] : NEG_INF;
  }
  if (gating_sigmoid) {
#pragma unroll
    for (int c = 0; c < PER; ++c)
      if (lane + 32 * c < E) s[c] = 1.0f / (1.0f + expf(-s[c]));
  } else {
    float m = NEG_INF;
#pragma unroll
    for (int c = 0; c < PER; ++c) m = fmaxf(m, s[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      s[c] = (lane + 32 * c < E) ? expf(s[c] - m) : 0.f;
      sum += s[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
#pragma unroll
    for (int c = 0; c < PER; ++c) s[c] = s[c] / sum;
  }

  Key kk[PER];
  Key best = 0ull;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int e = lane + 32 * c;
    kk[c] = (e < E) ? make_key(s[c], e) : 0ull;    // padding ranks last
    best = kk[c] > best ? kk[c] : best;
  }
  // tau: the lane maximum of rank k-1 (every lane holds a real key: E > 32)
  lane_max[warp][lane] = best;
  __syncwarp();
  int r = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) r += lane_max[warp][j] > best;
  const unsigned at_k = __ballot_sync(kFull, r == k - 1);
  const Key tau = lane_max[warp][__ffs(at_k) - 1];
  // the candidates (keys >= tau) into shared memory, in any order
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const bool in = kk[c] >= tau;
    const unsigned ballot = __ballot_sync(kFull, in);
    if (in) cand[warp][n + __popc(ballot & below)] = kk[c];
    n += __popc(ballot);
  }
  __syncwarp();
  // each candidate's rank among the candidates, which is its rank in the
  // row; those ranked below k go to their slots
  for (int i = lane; i < n; i += 32) {
    const Key key = cand[warp][i];
    int rank = 0;
#pragma unroll 4
    for (int j = 0; j < n; ++j) rank += cand[warp][j] > key;
    if (rank < k) {
      slot[warp][rank] = key_score(key);
      slot_e[warp][rank] = key_expert(key);
    }
  }
  __syncwarp();
  // one divisor for the row; lane j < k stores pick j
  const float tot = norm_topk ? slot_sum(slot[warp], k) : 1.f;
  if (lane < k) {
    i_out[(size_t)t * k + lane] = slot_e[warp][lane];
    w_out[(size_t)t * k + lane] = finish_weight(slot[warp][lane], tot,
                                                norm_topk, routed_scale);
  }
}

template <int L>
void launch_rows(const float* logits, float* w, int* idx, int T, int E,
                 int k, int sig, int norm, float scale, cudaStream_t s) {
  const int rows = kWarps * (32 / L);
  router_rows_kernel<L><<<(T + rows - 1) / rows, 32 * kWarps, 0, s>>>(
      logits, w, idx, T, E, k, sig, norm, scale);
}

template <int PER>
void launch_wide(const float* logits, float* w, int* idx, int T, int E,
                 int k, int sig, int norm, float scale, cudaStream_t s) {
  router_wide_kernel<PER><<<(T + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
      logits, w, idx, T, E, k, sig, norm, scale);
}

}  // namespace

MOE_API int moe_router_topk(const void* logits, void* weights, void* indices,
                            int T, int E, int k, int gating_sigmoid,
                            int norm_topk, float routed_scale, void* stream) {
  if (T == 0) return moe_last_error();
  const float* x = (const float*)logits;
  float* w = (float*)weights;
  int* idx = (int*)indices;
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS x, w, idx, T, E, k, gating_sigmoid, norm_topk, routed_scale, s
  if (E <= 1) launch_rows<1>(ARGS);
  else if (E <= 2) launch_rows<2>(ARGS);
  else if (E <= 4) launch_rows<4>(ARGS);
  else if (E <= 8) launch_rows<8>(ARGS);
  else if (E <= 16) launch_rows<16>(ARGS);
  else if (E <= 32) launch_rows<32>(ARGS);
  else if (E <= 64) launch_wide<2>(ARGS);
  else if (E <= 96) launch_wide<3>(ARGS);
  else if (E <= 128) launch_wide<4>(ARGS);
  else if (E <= 160) launch_wide<5>(ARGS);
  else if (E <= 192) launch_wide<6>(ARGS);
  else if (E <= 224) launch_wide<7>(ARGS);
  else launch_wide<8>(ARGS);
#undef ARGS
  return moe_last_error();
}
