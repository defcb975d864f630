// Paged decode attention straight off the KV block pool.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (its Pallas _kernel), with and without its second score operand: the
// GQA kernel below serves q alone, the MLA kernel further down q and q2.
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
//
// MLA (deepseek-v2's absorbed decode): s = q . ckv[k] + q2 . kr[k] and the
// value is ckv[k] itself.  Shapes: q (B, 1, 128, 512), q2 (B, 1, 128, 64),
// the latent pool (n_blocks, 16, 1, 512), the rope-key pool (n_blocks, 16,
// 1, 64), out (B, 1, 128, 512).  What bounds it: at decode (B = 2) bytes
// and the launch: about 0.8 MB (the rows' latent positions, q, q2, out),
// 0.2 us at 3.35 TB/s, while the grid has 16 blocks; at a 64-row chunk
// step the 17.8 MB of q and out (5 us), before the 0.86 GFLOP of the
// scores and PV (0.9 us on tensor cores, far longer on CUDA cores, which
// this kernel uses).  The GQA kernel's layout cannot hold it: a (G, D)
// fp32 query and accumulator for 128 heads of 512 are 256 KB each, beyond
// a block's shared memory.  So the MLA kernel tiles the query heads over
// a third grid axis (eight warps of two heads, 16 a block; or of one head
// where 16-head tiles would leave most SMs idle, as at decode) and keeps
// each head's query share and accumulator in registers: lane l holds the
// pairs 2(l + 32i) of [q | q2] and of the accumulator.  Shared memory
// holds (bs, D + D2) tiles, each position's latent row followed by its
// rope key, read as key and value; they are double-buffered, the next
// pool block's tile streaming in with cp.async (and the table entry after
// it read one block ahead) while this one is consumed.  Shared loads in
// the inner loops are clamped into the row and unconditional, so they
// issue back to back.  A lane keeps one position's score (bs <= 32), so
// the online softmax of a warp's heads runs in the warp, with no block
// barrier.  Sums are fp32 fmaf on CUDA cores, never TF32; tensor cores
// (mma over the 16 x 16 score tile) are left for later.
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


// ---------------------------------------------------------------------------
// MLA: the second score operand, the latent pool as key and value
// ---------------------------------------------------------------------------
constexpr int MLA_WARPS = 8;
constexpr int MLA_THREADS = MLA_WARPS * 32;
constexpr int MLA_QP = 9;    // pairs of [q | q2] per lane: D + D2 <= 576
constexpr int MLA_VP = 8;    // pairs of the accumulator per lane: D <= 512
constexpr int MLA_MAX_BS = 32;                  // one position per lane

template <typename T> struct Pair;
template <> struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a,
                                               float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global -> shared copy that bypasses the registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying pool block blk's (bs, D) latent rows and (bs, D2) rope keys
// for head h into one (bs, D + D2) shared tile, 16 bytes a copy; the
// caller commits the group and waits for it.
template <typename T>
__device__ __forceinline__ void issue_latent_tile(
    T* dst, const T* __restrict__ kv_pool, const T* __restrict__ k2_pool,
    size_t blk, int h, int Hkv, int bs, int D, int D2) {
  constexpr int EPV = 16 / sizeof(T);
  const int Dt = D + D2, vpr = Dt / EPV;
  for (int v = threadIdx.x; v < bs * vpr; v += MLA_THREADS) {
    const int kk = v / vpr, c = (v % vpr) * EPV;
    const size_t row = (blk * bs + kk) * Hkv + h;
    cp_async16(dst + kk * Dt + c, c < D ? kv_pool + row * D + c
                                        : k2_pool + row * D2 + (c - D));
  }
}

// The pair of tile row ``row`` at column c, with c clamped into the row so
// that every load is unconditional; zeros past ``width``
template <typename T>
__device__ __forceinline__ float2 row_pair(const T* row, int c, int width) {
  const float2 v = Pair<T>::load(row + min(c, width - 2));
  return c < width ? v : make_float2(0.f, 0.f);
}

// HPW query heads per warp, MLA_WARPS * HPW per thread block
template <typename T, int HPW>
__global__ void __launch_bounds__(MLA_THREADS, 1)
paged_attention_mla_kernel(const T* __restrict__ q, const T* __restrict__ q2,
                           const T* __restrict__ kv_pool,
                           const T* __restrict__ k2_pool,
                           const int* __restrict__ tables,
                           const int* __restrict__ kv_limit,
                           const int* __restrict__ q_pos, T* __restrict__ out,
                           int Hkv, int G, int D, int D2, int bs, int nb,
                           int causal, int has_window, int window,
                           float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dt = D + D2;
  T* sK = reinterpret_cast<T*>(smem);   // 2 x (bs, D + D2), double-buffered
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g0 = (blockIdx.z * MLA_WARPS + warp) * HPW;  // the warp's heads
  const int lim = kv_limit[b];
  const int qp = (causal || has_window) ? q_pos[b] : 0;
  const size_t row0 = ((size_t)b * Hkv + h) * G;
  const int* trow = tables + (size_t)b * nb;
  // blocks past the one holding kv_limit contribute nothing
  const int n_used = lim < 0 ? 0 : min(nb, lim / bs + 1);
  if (n_used > 0) {
    issue_latent_tile(sK, kv_pool, k2_pool, (size_t)trow[0], h, Hkv, bs, D,
                      D2);
    cp_async_commit();
  }
  int blk_next = n_used > 1 ? trow[1] : 0;

  // this lane's pairs of each head's [q | q2]; heads past G hold zeros.
  // Addresses are clamped in bounds so that every load is unconditional.
  float2 qr[HPW][MLA_QP];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = g0 + j;
    const size_t gr = row0 + min(g, G - 1);
#pragma unroll
    for (int i = 0; i < MLA_QP; ++i) {
      const int c = 2 * (lane + 32 * i);
      const float2 v = c < D ? Pair<T>::load(q + gr * D + c)
                             : Pair<T>::load(q2 + gr * D2 +
                                             min(c - D, D2 - 2));
      qr[j][i] = (g < G && c < Dt) ? v : make_float2(0.f, 0.f);
    }
  }
  float2 acc[HPW][MLA_VP];
  float m[HPW], l[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < MLA_VP; ++i) acc[j][i] = make_float2(0.f, 0.f);
  }

  for (int jb = 0; jb < n_used; ++jb) {
    const T* tile = sK + (jb & 1) * bs * Dt;
    // the next tile streams in while this one is consumed; the table
    // entry after it is read one block ahead
    if (jb + 1 < n_used) {
      issue_latent_tile(sK + ((jb + 1) & 1) * bs * Dt, kv_pool, k2_pool,
                        (size_t)blk_next, h, Hkv, bs, D, D2);
      cp_async_commit();
      blk_next = jb + 2 < n_used ? trow[jb + 2] : 0;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: lane kk keeps position kk's score of each of the warp's heads
    float s_pos[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) s_pos[j] = kNegInf;
#pragma unroll 2
    for (int kk = 0; kk < bs; ++kk) {
      const T* krow = tile + kk * Dt;
      float2 kv[MLA_QP];
#pragma unroll
      for (int i = 0; i < MLA_QP; ++i)
        kv[i] = row_pair(krow, 2 * (lane + 32 * i), Dt);
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        float ax = 0.f, ay = 0.f;           // two shorter dependent chains
#pragma unroll
        for (int i = 0; i < MLA_QP; ++i) {
          ax = fmaf(qr[j][i].x, kv[i].x, ax);
          ay = fmaf(qr[j][i].y, kv[i].y, ay);
        }
        const float sum = warp_sum(ax + ay);
        if (lane == kk) s_pos[j] = sum;
      }
    }

    // online softmax over this block, in the warp
    const bool ok = lane < bs && attended(jb * bs + lane, lim, qp, causal,
                                          has_window, window);
    float p_pos[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      float s = s_pos[j];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[j], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[j] - m_new);
      l[j] = corr * l[j] + warp_sum(p);
      m[j] = m_new;
      p_pos[j] = as_value_dtype(p, T{});
#pragma unroll
      for (int i = 0; i < MLA_VP; ++i) {
        acc[j][i].x *= corr;
        acc[j][i].y *= corr;
      }
    }

    // acc += p @ V, V the tile's latent rows; p rounded to V's dtype
#pragma unroll 2
    for (int kk = 0; kk < bs; ++kk) {
      const T* vrow = tile + kk * Dt;
      float2 v[MLA_VP];
#pragma unroll
      for (int i = 0; i < MLA_VP; ++i)
        v[i] = row_pair(vrow, 2 * (lane + 32 * i), D);
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const float pk = __shfl_sync(0xffffffffu, p_pos[j], kk);
#pragma unroll
        for (int i = 0; i < MLA_VP; ++i) {
          acc[j][i].x = fmaf(pk, v[i].x, acc[j][i].x);
          acc[j][i].y = fmaf(pk, v[i].y, acc[j][i].y);
        }
      }
    }
    __syncthreads();                   // this tile is consumed
  }

#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = g0 + j;
    if (g >= G) continue;
    const float lj = l[j], den = fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int i = 0; i < MLA_VP; ++i) {
      const int c = 2 * (lane + 32 * i);
      if (c < D)
        Pair<T>::store(out + (row0 + g) * D + c,
                       lj > 0.f ? acc[j][i].x / den : 0.f,
                       lj > 0.f ? acc[j][i].y / den : 0.f);
    }
  }
}

template <typename T, int HPW>
int launch_mla_tiles(const void* q, const void* q2, const void* kv_pool,
                     const void* k2_pool, const void* tables,
                     const void* kv_limit, const void* q_pos, void* out,
                     int B, int Hkv, int G, int D, int D2, int bs, int nb,
                     int causal, int has_window, int window, float softcap,
                     cudaStream_t s) {
  const size_t smem = 2 * (size_t)bs * (D + D2) * sizeof(T);
  auto* kernel = paged_attention_mla_kernel<T, HPW>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  constexpr int heads = MLA_WARPS * HPW;
  const dim3 grid(B, Hkv, (G + heads - 1) / heads);
  kernel<<<grid, MLA_THREADS, smem, s>>>(
      (const T*)q, (const T*)q2, (const T*)kv_pool, (const T*)k2_pool,
      (const int*)tables, (const int*)kv_limit, (const int*)q_pos, (T*)out,
      Hkv, G, D, D2, bs, nb, causal, has_window, window, softcap);
  return moe_last_error();
}

// Two heads a warp (16 a block) where that grid fills the card; one head a
// warp (8 a block) where it would leave most SMs idle, as at decode
template <typename T>
int launch_mla(const void* q, const void* q2, const void* kv_pool,
               const void* k2_pool, const void* tables, const void* kv_limit,
               const void* q_pos, void* out, int B, int Hkv, int G, int D,
               int D2, int bs, int nb, int causal, int has_window, int window,
               float softcap, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long blocks16 = (long)B * Hkv * ((G + 2 * MLA_WARPS - 1) /
                                         (2 * MLA_WARPS));
  if (blocks16 >= sms)
    return launch_mla_tiles<T, 2>(q, q2, kv_pool, k2_pool, tables, kv_limit,
                                  q_pos, out, B, Hkv, G, D, D2, bs, nb,
                                  causal, has_window, window, softcap, s);
  return launch_mla_tiles<T, 1>(q, q2, kv_pool, k2_pool, tables, kv_limit,
                                q_pos, out, B, Hkv, G, D, D2, bs, nb, causal,
                                has_window, window, softcap, s);
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

MOE_API int moe_paged_attention_mla(const void* q, const void* q2,
                                    const void* kv_pool, const void* k2_pool,
                                    const void* tables, const void* kv_limit,
                                    const void* q_pos, void* out, int B,
                                    int Hkv, int G, int D, int D2, int bs,
                                    int nb, int causal, int has_window,
                                    int window, float softcap, int dtype,
                                    void* stream) {
  if (B == 0 || Hkv == 0 || G == 0) return moe_last_error();
  if (D % 8 != 0 || D2 % 8 != 0 || D + D2 > 64 * MLA_QP ||
      D > 64 * MLA_VP || bs <= 0 || bs > MLA_MAX_BS || nb <= 0)
    return (int)cudaErrorInvalidValue;
  if ((causal || has_window) && q_pos == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch_mla<__nv_bfloat16>(q, q2, kv_pool, k2_pool, tables,
                                     kv_limit, q_pos, out, B, Hkv, G, D, D2,
                                     bs, nb, causal, has_window, window,
                                     softcap, s);
  return launch_mla<float>(q, q2, kv_pool, k2_pool, tables, kv_limit, q_pos,
                           out, B, Hkv, G, D, D2, bs, nb, causal, has_window,
                           window, softcap, s);
}
