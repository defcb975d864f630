// Paged decode attention straight off the KV block pool.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (its Pallas _kernel).  The MLA second score operand is not ported.
//
// out[b, h, g, :] = softmax_k(q[b, h, g, :] . K[k, h, :]) V[k, h, :] over
// the positions k <= kv_limit[b] (and, when asked, k <= q_pos[b] and
// k > q_pos[b] - window) of row b, whose keys and values sit in the pool
// blocks tables[b, 0..nb) in logical order: position k lives in block
// tables[b, k / bs] at offset k % bs.  Pools are (n_blocks, bs, Hkv, D)
// and (n_blocks, bs, Hkv, Dv); q (B, Hkv, G, D) arrives already scaled in
// its own dtype; out is (B, Hkv, G, Dv) in q's dtype.
//
// What bounds it on the H100: bytes.  Each row reads its K and V up to
// kv_limit once (moonshot: 16 KV heads x 128 x 2 bytes x 2 = 8 KB per
// position in bf16) and does 4 * G * (D + Dv) flops per position: far
// below the card's ~295 flop/byte.  At decode the batch is a few rows, so
// the grid is small and the launch itself is a large part of the time.
//
// What the design does about it: one thread block per (row b, KV head h);
// a loop over the row's table entries takes the place of the TPU kernel's
// sequential grid axis.  Each (bs, D) K tile and (bs, Dv) V tile is loaded
// into shared memory once, with 16-byte vectors, and serves all G query
// heads of the group; the gathered view never exists in device memory.
// Scores (G x bs), the running max, sum and the (G, Dv) accumulator stay
// in fp32 in shared memory.  Blocks that start past kv_limit are skipped:
// they would contribute p = 0 and a correction of 1, so skipping is exact,
// and table entries past kv_limit may name any block.
//
// Semantics held from the reference, line for line: masked scores are
// -1e30 (not -inf) and p is re-masked to 0; p is cast to V's dtype before
// the PV product (bf16 rounding), while the running sum uses the unrounded
// p; the final divide is l > 0 ? acc / max(l, 1e-30) : 0.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float as_value_dtype(float p, float) { return p; }
__device__ __forceinline__ float as_value_dtype(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ bool attended(int kpos, int lim, int qp, int causal,
                                         int has_window, int window) {
  bool ok = kpos <= lim;
  if (causal) ok = ok && kpos <= qp;
  if (has_window) ok = ok && kpos > qp - window;
  return ok;
}

// Copy one (bs, width) tile of a pool block for head h into shared memory.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ pool,
                                          size_t blk, int h, int Hkv, int bs,
                                          int width) {
  constexpr int EPV = 16 / sizeof(T);
  const int vpr = width / EPV;                  // vectors per tile row
  for (int v = threadIdx.x; v < bs * vpr; v += THREADS) {
    const int kk = v / vpr, c = (v % vpr) * EPV;
    const T* src = pool + ((blk * bs + kk) * Hkv + h) * (size_t)width + c;
    *reinterpret_cast<uint4*>(dst + kk * width + c) =
        *reinterpret_cast<const uint4*>(src);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ kv_limit,
                       const int* __restrict__ q_pos, T* __restrict__ out,
                       int Hkv, int G, int D, int Dv, int bs, int nb,
                       int causal, int has_window, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                   // (bs, D)
  T* sV = sK + bs * D;                                  // (bs, Dv)
  float* sQ = reinterpret_cast<float*>(sV + bs * Dv);   // (G, D)
  float* sP = sQ + G * D;                               // (G, bs) scores, then p
  float* sAcc = sP + G * bs;                            // (G, Dv)
  float* sM = sAcc + G * Dv;                            // (G,) running max
  float* sL = sM + G;                                   // (G,) running sum
  float* sCorr = sL + G;                                // (G,) this block's correction

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lim = kv_limit[b];
  const int qp = (causal || has_window) ? q_pos[b] : 0;

  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += THREADS) sQ[i] = to_f32(qb[i]);
  for (int i = tid; i < G * Dv; i += THREADS) sAcc[i] = 0.f;
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  // blocks past the one holding kv_limit contribute nothing
  const int n_used = lim < 0 ? 0 : min(nb, lim / bs + 1);
  for (int j = 0; j < n_used; ++j) {
    const size_t blk = (size_t)tables[(size_t)b * nb + j];
    __syncthreads();                   // the previous block is consumed
    load_tile(sK, k_pool, blk, h, Hkv, bs, D);
    load_tile(sV, v_pool, blk, h, Hkv, bs, Dv);
    __syncthreads();

    // scores: one warp per (g, kk), the lanes split D, fp32 sums
    for (int pr = warp; pr < G * bs; pr += THREADS / 32) {
      const int g = pr / bs, kk = pr % bs;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(sQ[g * D + d], to_f32(sK[kk * D + d]), acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        float s = acc;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const bool ok = attended(j * bs + kk, lim, qp, causal, has_window,
                                 window);
        sP[pr] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics, one thread per query head of the group
    for (int g = tid; g < G; g += THREADS) {
      const float m_prev = sM[g];
      float m_new = m_prev;
      for (int kk = 0; kk < bs; ++kk) m_new = fmaxf(m_new, sP[g * bs + kk]);
      float sum = 0.f;
      for (int kk = 0; kk < bs; ++kk) {
        const bool ok = attended(j * bs + kk, lim, qp, causal, has_window,
                                 window);
        const float p = ok ? expf(sP[g * bs + kk] - m_new) : 0.f;
        sP[g * bs + kk] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      sCorr[g] = corr;
      sM[g] = m_new;
      sL[g] = corr * sL[g] + sum;
    }
    __syncthreads();

    // acc = corr * acc + p @ V, p rounded to V's dtype; each thread owns
    // the same accumulator entries in every iteration
    for (int i = tid; i < G * Dv; i += THREADS) {
      const int g = i / Dv, dv = i % Dv;
      float pv = 0.f;
      for (int kk = 0; kk < bs; ++kk)
        pv = fmaf(as_value_dtype(sP[g * bs + kk], T{}), to_f32(sV[kk * Dv + dv]),
                  pv);
      sAcc[i] = sCorr[g] * sAcc[i] + pv;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * Hkv + h) * G * Dv;
  for (int i = tid; i < G * Dv; i += THREADS) {
    const float l = sL[i / Dv];
    ob[i] = from_f32<T>(l > 0.f ? sAcc[i] / fmaxf(l, 1e-30f) : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_limit, const void* q_pos,
           void* out, int B, int Hkv, int G, int D, int Dv, int bs, int nb,
           int causal, int has_window, int window, float softcap,
           cudaStream_t s) {
  const size_t smem = (size_t)bs * (D + Dv) * sizeof(T) +
                      ((size_t)G * (D + bs + Dv) + 3 * G) * sizeof(float);
  auto* kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);   // a refusal surfaces as the launch's error
  kernel<<<dim3(B, Hkv), THREADS, smem, s>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)tables,
      (const int*)kv_limit, (const int*)q_pos, (T*)out, Hkv, G, D, Dv, bs, nb,
      causal, has_window, window, softcap);
  return moe_last_error();
}

}  // namespace

MOE_API int moe_paged_attention(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* kv_limit, const void* q_pos,
                                void* out, int B, int Hkv, int G, int D,
                                int Dv, int bs, int nb, int causal,
                                int has_window, int window, float softcap,
                                int dtype, void* stream) {
  if (B == 0 || Hkv == 0 || G == 0) return moe_last_error();
  if (D % 8 != 0 || Dv % 8 != 0 || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  if ((causal || has_window) && q_pos == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, kv_limit, q_pos,
                                 out, B, Hkv, G, D, Dv, bs, nb, causal,
                                 has_window, window, softcap, s);
  return launch<float>(q, k_pool, v_pool, tables, kv_limit, q_pos, out, B,
                       Hkv, G, D, Dv, bs, nb, causal, has_window, window,
                       softcap, s);
}
