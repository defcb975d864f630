// Paged decode attention straight off the KV block pool.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (its Pallas _kernel), with and without its second score operand: the
// GQA kernels below serve q alone, the MLA kernels further down q and q2.
//
// out[b, h, g, :] = softmax_k(q[b, h, g, :] . K[k, h, :]) V[k, h, :] over
// the positions k <= kv_limit[b] (and, when asked, k <= q_pos[b] and
// k > q_pos[b] - window) of row b, whose keys and values sit in the pool
// blocks tables[b, 0..nb) in logical order: position k lives in block
// tables[b, k / bs] at offset k % bs.  Pools are (n_blocks, bs, Hkv, D)
// and (n_blocks, bs, Hkv, Dv); out is (B, Hkv, G, Dv) in q's dtype.
//
// GQA.  What bounds it on the H100: bytes.  Each row reads its K and V up
// to kv_limit once (moonshot: 16 KV heads x 128 x 2 bytes x 2 = 8 KB per
// position in bf16) and does 4 * G * (D + Dv) flops per position: far
// below the card's ~295 flop/byte.  A row of 8,192 positions is 64 MB, 20
// us at 3.35 TB/s; at decode (two rows of about 100 positions) the 1.4 MB
// take 0.4 us and the time is the launch and a few dependent loads.
//
// What the design does about it: the work is cut across the card, not
// walked by one block per (row, KV head).  The host cuts each row's nb
// table entries into n_split contiguous ranges of per_split entries
// (split_plan in kernels/paged_attention.py: from B, Hkv, nb and the SM
// count, never from kv_limit, so the call stays free of host syncs), as
// many as fill the card's block slots in whole rounds.  The grid is (row
// b, group of four KV heads x head tile, split); each warp of a block
// takes one KV head of the group (fewer warps where four rings of a wide
// fp32 head would not fit in 227 KB), so the block reads each position's
// row of four heads, 1 KB at moonshot, together.  A split whose range
// starts past the block holding kv_limit exits at once, so blocks past
// kv_limit are never read.  A warp walks its split's entries on its own:
// a two-stage ring of (bs, D) K and (bs, Dv) V tiles in shared memory, the
// next pool block's tiles streaming in with cp.async (and the table entry
// after it read one block ahead) while this one is consumed, with
// __syncwarp and no block barrier anywhere.  A lane holds the pairs
// 2(l + 32i) of each of its warp's query heads (one, or four: a K/V tile
// serves all G heads of the group) and of their accumulators in
// registers; a warp scores 16 positions at once (each lane its fp32 fmaf
// share of the 16 dot products, then a transposing butterfly of 16
// shuffles that leaves position k's score in lanes 2k and 2k + 1), and the
// online softmax runs in the warp.  The warp writes its (m, l,
// acc) as the split's fp32 partial, or, where one split covers the row (a
// chunk step of many rows), the output directly.  A second small kernel
// merges the live splits of each (row, head, query) in split order, with
// the same rules, so the output is bitwise the same from call to call (no
// atomics anywhere).  q arrives unscaled: each lane rounds q * scale to
// q's dtype as it loads it, as the reference does.
//
// Semantics held from the reference, line for line: masked scores are
// -1e30 (not -inf) and p is re-masked to 0; p is cast to V's dtype before
// the PV product (bf16 rounding), while the running sum uses the unrounded
// p; the final divide is l > 0 ? acc / max(l, 1e-30) : 0.  Skipping a pool
// block (or a split) whose positions are all masked is exact: it would
// contribute p = 0 and a correction of 1.  A row whose positions are all
// masked has l = 0 in every split and comes out as exact zeros.
//
// MLA (deepseek-v2's absorbed decode): s = q . ckv[k] + q2 . kr[k] and the
// value is ckv[k] itself; q and q2 are multiplied by the scale and rounded
// to their dtype first.  Shapes: q (B, 1, 128, 512), q2 (B, 1, 128, 64),
// the latent pool (n_blocks, 16, 1, 512), the rope-key pool (n_blocks, 16,
// 1, 64), out (B, 1, 128, 512).  128 query heads share one latent head of
// 576, so each latent byte feeds 128 x 2 x 1,088 / 1,152 = 242 flops: near
// the card's ridge (295 flop/byte in bf16), on tensor cores; far past it on
// CUDA cores.  What bounds it, bf16 (chip_smoke.MLA_SHAPES): at decode (B =
// 2 at 100 / 77) bytes, 0.76 MB (0.23 us), and in practice the launch and
// one SM's loads; at a 64-row chunk step the bytes of q and out (18 MB,
// 5.4 us); at long context (B = 2 at 8,191 / 6,143) bytes, 17 MB (5.1 us)
// against 4.0 us of tensor-core operations; 32 rows of 2,048 bytes, 84 MB
// (25 us) against 18.5 us of operations.
//
// bf16 (the mla namespace below): a thread block takes 64 query heads of
// one (row, KV head) -- wgmma's M -- and one split of the row's table
// (mla_split_plan in kernels/paged_attention.py, from the shapes alone,
// never kv_limit, so the call stays free of host syncs), and walks it in
// tiles of 64 positions, a ring of two tiles in shared memory.  Warp 0
// fills the ring by TMA: each pool block's bs rows of each 64-column group
// are one box (3-D maps of the two pools; the block's row is tables[b, j]
// x bs), so any bs <= 64 tiles 64 positions (bs <= 32 where the tiles are
// of 32), and entries past the split
// load a box past the pool's end, which TMA fills with zeros.  The q tile
// (64 x 576) comes in once, and is scaled in shared memory.  The two
// warpgroups each compute the scores of half the tile's positions for all
// 64 heads on wgmma (m64n32k16, [q | q2] and [ckv | kr] both K-major from
// shared memory, 36 k16 steps, unrolled: a loop of them without a wait
// would be serialized), meet on the row maxima, and trade their P
// fragments (bf16, rounded as the reference rounds p) through shared
// memory; each then adds P V into its own 256 value columns (m64n256k16, P
// from registers, ckv read MN-major as stored): 128 accumulator registers
// a thread, and no score computed twice.  The block has no producer warp:
// a third warp on an SM sub-partition would cap every thread at 168
// registers, fewer than a consumer holds (ptxas then serialized the
// wgmma).  The split's fp32 partial (m, l, acc), or where one split covers
// the row the output, goes out through shared memory in whole rows;
// mla_combine_kernel merges the live splits in split order, as the GQA
// merge does, so the output is bitwise the same from call to call.
// Blocks past the one holding kv_limit are never read; a split that starts
// past it exits at once.  What the design does about the bound: every
// product on tensor cores, the table cut across the card, the latent read
// once per 64 heads.  Measured (PERF.md), the tiles' TMA loads, not the
// products, set the pace at long context.
//
// fp32 (paged_attention_mla_kernel): one pass over each row on CUDA cores,
// never TF32, q and q2 scaled by the caller.  The query heads are tiled
// over a third grid axis (eight warps of two heads, 16 a block; or of one
// head where 16-head tiles would leave most SMs idle, as at decode); each
// head's query share and accumulator stay in registers: lane l holds the
// pairs 2(l + 32i) of [q | q2] and of the accumulator.  Shared memory holds
// tiles of a pool block's positions, 32 at most (a block of bs > 32 is
// walked in chunks of 32), each position's latent row followed by its rope
// key, read as key and value; they are double-buffered, the next chunk's
// tile streaming in with cp.async while this one is consumed.  A lane keeps
// one position's score, so the online softmax of a warp's heads runs in the
// warp.
#include "hopper_gemm.cuh"

namespace {

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

// The pair of tile row ``row`` at column c, with c clamped into the row so
// that every load is unconditional; zeros past ``width``
template <typename T>
__device__ __forceinline__ float2 row_pair(const T* row, int c, int width) {
  const float2 v = Pair<T>::load(row + min(c, width - 2));
  return c < width ? v : make_float2(0.f, 0.f);
}

// ---------------------------------------------------------------------------
// GQA: split-KV over the block pool, then a merge of the splits in order
// ---------------------------------------------------------------------------
constexpr int GQA_WARPS = 4;       // KV heads a block (fewer: rings too big)
constexpr int GQA_THREADS = GQA_WARPS * 32;
constexpr int GQA_STAGES = 2;      // each warp's ring of (K, V) tiles
constexpr int GQA_MAX_WIDTH = 256; // D, Dv: 4 pairs a lane
constexpr int GQA_CHUNK = 16;      // positions a warp scores at once
constexpr int COMBINE_THREADS = 128;

// One step of transpose_sum: trade the upper or the lower HALF of v[0,
// 2 HALF) with the lane O apart, keeping the half this lane's bit O selects
template <int HALF, int O>
__device__ __forceinline__ void transpose_step(float (&v)[GQA_CHUNK],
                                               int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// v[k] is this lane's share of position k's dot product, k < 16.  Returns
// the warp's sum for position lane / 2: four steps halve the values a lane
// holds (lanes 16, 8, 4, 2 apart) and the last adds the neighbour's: 16
// shuffles where a reduction per position would take 80.
__device__ __forceinline__ float transpose_sum(float (&v)[GQA_CHUNK],
                                               int lane) {
  static_assert(GQA_CHUNK == 16, "four steps over lanes 16, 8, 4, 2");
  transpose_step<8, 16>(v, lane);
  transpose_step<4, 8>(v, lane);
  transpose_step<2, 4>(v, lane);
  transpose_step<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Start copying pool block blk's (bs, D) K rows and (bs, Dv) V rows for
// head h into one warp's (K | V) tile, 16 bytes a copy; the caller
// commits the group and waits for it.  A lane's copies step through the
// tile 32 vectors at a time, with no division in the loop.
template <typename T>
__device__ __forceinline__ void issue_kv_tile(T* dst,
                                              const T* __restrict__ pool,
                                              size_t blk, int h, int Hkv,
                                              int bs, int width, int lane) {
  constexpr int EPV = 16 / sizeof(T);
  const int vpr = width / EPV;                 // vectors per tile row
  const int d_row = 32 / vpr, d_col = 32 % vpr;
  int kk = lane / vpr, c = lane % vpr;
  const T* src = pool + (blk * bs * Hkv + h) * (size_t)width;
  const size_t stride = (size_t)Hkv * width;   // from one position to the next
  while (kk < bs) {
    cp_async16(dst + kk * width + c * EPV, src + kk * stride + c * EPV);
    kk += d_row;
    c += d_col;
    if (c >= vpr) {
      c -= vpr;
      ++kk;
    }
  }
}

// Grid (B, ceil(Hkv / warps) * head tiles, n_split), blockDim.x / 32
// warps: warp w of a block takes KV head (blockIdx.y / head tiles) * warps
// + w and walks every entry of the block's split.  QP pairs of q and of the
// accumulator a lane (D, Dv <= 64 * QP); HPW query heads a warp.
template <typename T, int QP, int HPW>
__global__ void __launch_bounds__(GQA_THREADS)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ kv_limit,
                             const int* __restrict__ q_pos,
                             T* __restrict__ out, float* __restrict__ part_ml,
                             float* __restrict__ part_acc, float scale,
                             int Hkv, int G, int D, int Dv, int bs, int nb,
                             int per_split, int n_split, int causal,
                             int has_window, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_gt = (G + HPW - 1) / HPW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int b = blockIdx.x, h = (blockIdx.y / n_gt) * n_warps + warp;
  const int g0 = (blockIdx.y % n_gt) * HPW, split = blockIdx.z;
  if (h >= Hkv) return;                  // past the last group's heads
  // the split's first table entries and this lane's pairs of each of the
  // warp's heads (q * scale rounded to q's dtype; heads past G and columns
  // past D hold zeros) are read before kv_limit is known: none depends on it
  const int j0 = split * per_split;      // < nb
  const int* trow = tables + (size_t)b * nb;
  int first[GQA_STAGES];
#pragma unroll
  for (int p = 0; p < GQA_STAGES; ++p)
    first[p] = j0 + p < nb ? trow[j0 + p] : 0;
  const size_t row0 = ((size_t)b * Hkv + h) * G;
  float2 qr[HPW][QP];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = g0 + j;
    const T* qg = q + (row0 + min(g, G - 1)) * D;
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const int c = 2 * (lane + 32 * i);
      const float2 v = Pair<T>::load(qg + min(c, D - 2));
      qr[j][i] = (g < G && c < D)
          ? make_float2(as_value_dtype(v.x * scale, T{}),
                        as_value_dtype(v.y * scale, T{}))
          : make_float2(0.f, 0.f);
    }
  }
  const int lim = kv_limit[b];
  // blocks past the one holding kv_limit contribute nothing
  const int n_used = lim < 0 ? 0 : min(nb, lim / bs + 1);
  const int j1 = min(n_used, j0 + per_split);
  if (j0 >= j1 && n_split > 1) return;   // the merge skips this split
  const int qp = (causal || has_window) ? q_pos[b] : 0;
  const int tile = bs * (D + Dv);
  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * GQA_STAGES * tile;
  // this warp's ring; the first GQA_STAGES - 1 tiles start streaming in,
  // and one (possibly empty) copy group is committed per tile
  const int n_mine = max(0, j1 - j0);
#pragma unroll
  for (int p = 0; p < GQA_STAGES - 1; ++p) {
    if (p < n_mine) {
      issue_kv_tile(ring + p * tile, k_pool, (size_t)first[p], h, Hkv, bs, D,
                    lane);
      issue_kv_tile(ring + p * tile + bs * D, v_pool, (size_t)first[p], h,
                    Hkv, bs, Dv, lane);
    }
    cp_async_commit();
  }
  int blk_next = first[GQA_STAGES - 1];

  float2 acc[HPW][QP];
  float m[HPW], l[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < QP; ++i) acc[j][i] = make_float2(0.f, 0.f);
  }

  for (int it = 0; it < n_mine; ++it) {
    const int jb = j0 + it;
    const T* tK = ring + (it % GQA_STAGES) * tile;
    const T* tV = tK + bs * D;
    // the tiles GQA_STAGES - 1 ahead stream in while these are consumed;
    // the table entry after them is read one block ahead
    if (it + GQA_STAGES - 1 < n_mine) {
      T* nxt = ring + ((it + GQA_STAGES - 1) % GQA_STAGES) * tile;
      issue_kv_tile(nxt, k_pool, (size_t)blk_next, h, Hkv, bs, D, lane);
      issue_kv_tile(nxt + bs * D, v_pool, (size_t)blk_next, h, Hkv, bs, Dv,
                    lane);
      blk_next = it + GQA_STAGES < n_mine ? trow[jb + GQA_STAGES] : 0;
    }
    cp_async_commit();
    cp_async_wait<GQA_STAGES - 1>();  // this tile's group has landed
    __syncwarp();                      // ... for every lane's copies

    for (int c0 = 0; c0 < bs; c0 += GQA_CHUNK) {
      const int nc = min(GQA_CHUNK, bs - c0);
      // scores: each lane forms its share of the chunk's dot products
      // (rows past the tile clamped to its last), then a transposing
      // butterfly leaves position lane / 2's score in lanes 2k and 2k + 1
      float part[HPW][GQA_CHUNK];
#pragma unroll
      for (int kk = 0; kk < GQA_CHUNK; ++kk) {
        const T* krow = tK + min(c0 + kk, bs - 1) * D;
        float2 kv[QP];
#pragma unroll
        for (int i = 0; i < QP; ++i)
          kv[i] = row_pair(krow, 2 * (lane + 32 * i), D);
#pragma unroll
        for (int j = 0; j < HPW; ++j) {
          float ax = 0.f, ay = 0.f;
#pragma unroll
          for (int i = 0; i < QP; ++i) {
            ax = fmaf(qr[j][i].x, kv[i].x, ax);
            ay = fmaf(qr[j][i].y, kv[i].y, ay);
          }
          part[j][kk] = ax + ay;
        }
      }
      float s_pos[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j) s_pos[j] = transpose_sum(part[j], lane);

      // online softmax over this chunk, in the warp
      const int pos = lane / 2;
      const bool ok = pos < nc && attended(jb * bs + c0 + pos, lim, qp,
                                           causal, has_window, window);
      float p_pos[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        float s = s_pos[j];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s = ok ? s : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[j] - m_new);
        l[j] = corr * l[j] + warp_sum(lane & 1 ? 0.f : p);   // once a position
        m[j] = m_new;
        p_pos[j] = as_value_dtype(p, T{});
#pragma unroll
        for (int i = 0; i < QP; ++i) {
          acc[j][i].x *= corr;
          acc[j][i].y *= corr;
        }
      }
      // acc += p @ V; p rounded to V's dtype
#pragma unroll 2
      for (int kk = 0; kk < nc; ++kk) {
        const T* vrow = tV + (c0 + kk) * Dv;
        float2 v[QP];
#pragma unroll
        for (int i = 0; i < QP; ++i)
          v[i] = row_pair(vrow, 2 * (lane + 32 * i), Dv);
#pragma unroll
        for (int j = 0; j < HPW; ++j) {
          const float pk = __shfl_sync(0xffffffffu, p_pos[j], 2 * kk);
#pragma unroll
          for (int i = 0; i < QP; ++i) {
            acc[j][i].x = fmaf(pk, v[i].x, acc[j][i].x);
            acc[j][i].y = fmaf(pk, v[i].y, acc[j][i].y);
          }
        }
      }
    }
    __syncwarp();                      // these tiles are consumed
  }

  // the split's partial, or the output where one split covers the row
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = g0 + j;
    if (g >= G) continue;
    const size_t row = row0 + g;
    const float den = fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const int c = 2 * (lane + 32 * i);
      if (c >= Dv) continue;
      if (n_split == 1) {
        Pair<T>::store(out + row * Dv + c,
                       l[j] > 0.f ? acc[j][i].x / den : 0.f,
                       l[j] > 0.f ? acc[j][i].y / den : 0.f);
      } else {
        const size_t pr = row * n_split + split;
        *reinterpret_cast<float2*>(part_acc + pr * Dv + c) = acc[j][i];
        if (c == 0) {
          part_ml[2 * pr] = m[j];
          part_ml[2 * pr + 1] = l[j];
        }
      }
    }
  }
}

// One block per (row, KV head): each (query head, column pair) merges the
// live splits -- those that start below the block holding kv_limit -- in
// split order; a row with none comes out as zeros.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_attention_combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               const int* __restrict__ kv_limit,
                               T* __restrict__ out, int Hkv, int G, int Dv,
                               int bs, int nb, int per_split, int n_split) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int lim = kv_limit[b];
  const int n_used = lim < 0 ? 0 : min(nb, lim / bs + 1);
  const int n_live = (n_used + per_split - 1) / per_split;
  const size_t row0 = ((size_t)b * Hkv + h) * G;
  const int pairs = Dv / 2;
  // every split's partial is loaded, without waiting for kv_limit; those
  // of dead splits (never written) are selected away, never multiplied
  for (int e = threadIdx.x; e < G * pairs; e += COMBINE_THREADS) {
    const int g = e / pairs, c = 2 * (e % pairs);
    const size_t pr = (row0 + g) * n_split;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) {
      const float m = part_ml[2 * (pr + s)];
      M = s < n_live ? fmaxf(M, m) : M;
    }
    float L = 0.f, ax = 0.f, ay = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float2 ml =
          *reinterpret_cast<const float2*>(part_ml + 2 * (pr + s));
      const float2 a = *reinterpret_cast<const float2*>(part_acc +
                                                        (pr + s) * Dv + c);
      if (s < n_live) {
        const float f = expf(ml.x - M);
        L += ml.y * f;
        ax += a.x * f;
        ay += a.y * f;
      }
    }
    const float den = fmaxf(L, 1e-30f);
    Pair<T>::store(out + (row0 + g) * Dv + c, L > 0.f ? ax / den : 0.f,
                   L > 0.f ? ay / den : 0.f);
  }
}

template <typename T, int QP, int HPW>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const void* tables, const void* kv_limit, const void* q_pos,
                 void* out, void* part_ml, void* part_acc, float scale, int B,
                 int Hkv, int G, int D, int Dv, int bs, int nb, int per_split,
                 int n_split, int warps, int causal, int has_window,
                 int window, float softcap, cudaStream_t s) {
  const size_t smem = (size_t)warps * GQA_STAGES * bs * (D + Dv) * sizeof(T);
  auto* kernel = paged_attention_split_kernel<T, QP, HPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return moe_last_error();
  }
  const dim3 grid(B, ((Hkv + warps - 1) / warps) * ((G + HPW - 1) / HPW),
                  n_split);
  kernel<<<grid, warps * 32, smem, s>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)tables,
      (const int*)kv_limit, (const int*)q_pos, (T*)out, (float*)part_ml,
      (float*)part_acc, scale, Hkv, G, D, Dv, bs, nb, per_split, n_split,
      causal, has_window, window, softcap);
  const int err = moe_last_error();
  if (err != 0 || n_split == 1) return err;
  paged_attention_combine_kernel<T><<<dim3(B, Hkv), COMBINE_THREADS, 0, s>>>(
      (const float*)part_ml, (const float*)part_acc, (const int*)kv_limit,
      (T*)out, Hkv, G, Dv, bs, nb, per_split, n_split);
  return moe_last_error();
}

// One head a warp where the group is one head (moonshot); four where it is
// larger (mixtral's G = 4), so that a K/V tile serves the whole group
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_limit, const void* q_pos,
           void* out, void* part_ml, void* part_acc, float scale, int B,
           int Hkv, int G, int D, int Dv, int bs, int nb, int per_split,
           int n_split, int warps, int causal, int has_window, int window,
           float softcap, cudaStream_t s) {
#define MOE_GQA_LAUNCH(QP, HPW)                                              \
  launch_split<T, QP, HPW>(q, k_pool, v_pool, tables, kv_limit, q_pos, out,  \
                           part_ml, part_acc, scale, B, Hkv, G, D, Dv, bs,   \
                           nb, per_split, n_split, warps, causal,            \
                           has_window, window, softcap, s)
  if (D <= 128 && Dv <= 128)
    return G == 1 ? MOE_GQA_LAUNCH(2, 1) : MOE_GQA_LAUNCH(2, 4);
  return G == 1 ? MOE_GQA_LAUNCH(4, 1) : MOE_GQA_LAUNCH(4, 4);
#undef MOE_GQA_LAUNCH
}

// ---------------------------------------------------------------------------
// MLA in fp32: the second score operand, the latent pool as key and value,
// on CUDA cores (fp32 never runs on TF32)
// ---------------------------------------------------------------------------
constexpr int MLA_WARPS = 8;
constexpr int MLA_THREADS = MLA_WARPS * 32;
constexpr int MLA_QP = 9;    // pairs of [q | q2] per lane: D + D2 <= 576
constexpr int MLA_VP = 8;    // pairs of the accumulator per lane: D <= 512
// pool blocks of up to 64 positions: the bf16 kernel's tile (where its
// row has at most nine 64-column groups, else 32); the fp32 kernel walks a
// block in chunks of at most MLA_CHUNK positions, one a lane
constexpr int MLA_MAX_BS = 64;
constexpr int MLA_CHUNK = 32;

// Start copying positions [c0, c0 + nc) of pool block blk's latent rows and
// rope keys for head h into one (nc, D + D2) shared tile, 16 bytes a copy;
// the caller commits the group and waits for it.
template <typename T>
__device__ __forceinline__ void issue_latent_tile(
    T* dst, const T* __restrict__ kv_pool, const T* __restrict__ k2_pool,
    size_t blk, int c0, int nc, int h, int Hkv, int bs, int D, int D2) {
  constexpr int EPV = 16 / sizeof(T);
  const int Dt = D + D2, vpr = Dt / EPV;
  for (int v = threadIdx.x; v < nc * vpr; v += MLA_THREADS) {
    const int kk = v / vpr, c = (v % vpr) * EPV;
    const size_t row = (blk * bs + c0 + kk) * Hkv + h;
    cp_async16(dst + kk * Dt + c, c < D ? kv_pool + row * D + c
                                        : k2_pool + row * D2 + (c - D));
  }
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
  T* sK = reinterpret_cast<T*>(smem);   // 2 x (chunk, D + D2), double-buffered
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g0 = (blockIdx.z * MLA_WARPS + warp) * HPW;  // the warp's heads
  const int lim = kv_limit[b];
  const int qp = (causal || has_window) ? q_pos[b] : 0;
  const size_t row0 = ((size_t)b * Hkv + h) * G;
  const int* trow = tables + (size_t)b * nb;
  // blocks past the one holding kv_limit contribute nothing; each block is
  // walked in cpb chunks of at most MLA_CHUNK positions
  const int n_used = lim < 0 ? 0 : min(nb, lim / bs + 1);
  const int chunk = min(bs, MLA_CHUNK), cpb = (bs + chunk - 1) / chunk;
  const int n_chunks = n_used * cpb;
  if (n_chunks > 0) {
    issue_latent_tile(sK, kv_pool, k2_pool, (size_t)trow[0], 0, chunk, h,
                      Hkv, bs, D, D2);
    cp_async_commit();
  }
  int blk_next = n_chunks > 1 ? trow[1 / cpb] : 0;

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

  for (int u = 0; u < n_chunks; ++u) {
    // chunk u: positions [c0, c0 + nc) of the table's block jb
    const int jb = u / cpb, c0 = (u % cpb) * chunk, nc = min(chunk, bs - c0);
    const T* tile = sK + (u & 1) * chunk * Dt;
    // the next tile streams in while this one is consumed; the table
    // entry after it is read one chunk ahead
    if (u + 1 < n_chunks) {
      const int c1 = ((u + 1) % cpb) * chunk;
      issue_latent_tile(sK + ((u + 1) & 1) * chunk * Dt, kv_pool, k2_pool,
                        (size_t)blk_next, c1, min(chunk, bs - c1), h, Hkv,
                        bs, D, D2);
      cp_async_commit();
      blk_next = u + 2 < n_chunks ? trow[(u + 2) / cpb] : 0;
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
    for (int kk = 0; kk < nc; ++kk) {
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
    const bool ok = lane < nc && attended(jb * bs + c0 + lane, lim, qp,
                                          causal, has_window, window);
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
    for (int kk = 0; kk < nc; ++kk) {
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
  const size_t smem = 2 * (size_t)min(bs, MLA_CHUNK) * (D + D2) * sizeof(T);
  auto* kernel = paged_attention_mla_kernel<T, HPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();
      return (int)e;
    }
  }
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
  const int sms = moe_num_sms();
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

// ---------------------------------------------------------------------------
// MLA in bf16 on Hopper: scores and PV on wgmma, the latent tiles by TMA
// from the block table, split-KV over each row's table, a merge in order
// ---------------------------------------------------------------------------
namespace mla {

using hopper::SUB;
constexpr int HEADS = 64;         // query heads a thread block: wgmma's M
constexpr int STAGES = 2;         // the ring of latent tiles
// two warpgroups, no producer warp: a thread holds 128 accumulators, 16
// scores and the pipeline's operands, which need more than the 168
// registers a third warp on an SM sub-partition would leave; warp 0 issues
// the TMA loads between its products
constexpr int THREADS = 256;
constexpr int VGROUPS = 8;        // 64-column groups of the value, 4 a
                                  // warpgroup
constexpr int SMEM_LIMIT = 232448;
// the epilogue's fp32 rows in shared memory: 512 columns and 8 more, so
// that rows r and r + 4 of a warp's stores fall on other banks
constexpr int STAGE_PITCH = 520;

// A kernel instance scores NG 64-column groups of [q | q2] against NG of
// [latent | rope key], unrolled: (TP, NG) = (64, 9) for every shape with
// at most nine (deepseek's 512 + 64 has nine), (32, 10) for ten.  A row of
// fewer groups is zero-padded in shared memory.
__host__ __device__ __forceinline__ int groups(int D, int D2) {
  return (D + 63) / 64 + (D2 + 63) / 64;
}

// The shared memory of a block: the 64-head [q | q2] tile (NG groups of 64
// rows x 128 bytes), STAGES tiles of TP positions (NG >= VGROUPS groups of
// TP rows x 128 bytes each), the two warpgroups' exchange of P fragments
// (TP x 128 bytes) and of row statistics (2 x 64 floats), the barriers;
// 1 KB aligns the groups for the 128-byte swizzle
template <int TP, int NG>
struct Smem {
  static_assert(NG >= VGROUPS, "the value product reads eight groups");
  static constexpr int GB = TP * 128;             // one group of a tile
  static constexpr int RING = NG * SUB;
  static constexpr int EXCHANGE = RING + STAGES * NG * GB;
  static constexpr int STATS = EXCHANGE + TP * 128;
  static constexpr int BARS = STATS + 2 * HEADS * 4;
  static constexpr int BYTES = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(BYTES <= SMEM_LIMIT, "227 KB a block");
  static_assert(HEADS * STAGE_PITCH * 4 <= EXCHANGE, "the epilogue's rows");
};

// Grid (ceil(G / 64) head tiles, n_split, B x Hkv): the block of head tile
// ht of row b, KV head h, takes the table entries [j0, j1) of split `split`
// (j1 clipped at the block holding kv_limit), TP positions (TP / bs pool
// blocks) a tile.  Consumer warpgroup wg scores positions [TP/2 wg,
// TP/2 (wg + 1)) of each tile for all 64 heads, the two meet on the row
// maxima and trade their P fragments through shared memory, and each adds
// P V into its own 256 value columns.
template <int TP, int NG>
__global__ void __launch_bounds__(THREADS, 1)
mla_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap q2map,
                  const __grid_constant__ CUtensorMap kvmap,
                  const __grid_constant__ CUtensorMap k2map,
                  const int* __restrict__ tables,
                  const int* __restrict__ kv_limit,
                  const int* __restrict__ q_pos,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_ml,
                  float* __restrict__ part_acc, float scale, int Hkv, int G,
                  int D, int D2, int bs, int nb, int n_blocks, int per_split,
                  int n_split, int causal, int has_window, int window,
                  float softcap) {
  using namespace hopper;
  using L = Smem<TP, NG>;
  constexpr int GB = L::GB;
  const int ht = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / Hkv, h = bh % Hkv;
  const int lane = threadIdx.x % 32;
  const int nbt = TP / bs, tpos = nbt * bs;   // pool blocks, positions a tile
  const int j0 = split * per_split, jend = min(nb, j0 + per_split);
  // warp 0 reads the first two tiles' table entries (lane l: entries l and
  // 32 + l of a tile) beside kv_limit, not after it
  const int* trow = tables + (size_t)b * nb;
  auto entries = [&](int t, int& c0, int& c1) {
    const int j = j0 + t * nbt + lane;
    c0 = lane < nbt && j < jend ? trow[j] : -1;
    c1 = lane + 32 < nbt && j + 32 < jend ? trow[j + 32] : -1;
  };
  int e00 = -1, e01 = -1, e10 = -1, e11 = -1;   // even tiles', odd tiles'
  if (threadIdx.x < 32) {
    entries(0, e00, e01);
    entries(1, e10, e11);
  }
  const int lim = kv_limit[b];
  // blocks past the one holding kv_limit contribute nothing
  const int n_used = lim < 0 ? 0 : min(nb, lim / bs + 1);
  const int j1 = min(n_used, jend);
  if (j0 >= j1 && n_split > 1) return;    // the merge skips this split
  const int n_tiles = j0 < j1 ? (j1 - j0 + nbt - 1) / nbt : 0;
  const int nck = (D + 63) / 64, ng = groups(D, D2);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sq = smem_addr(smem);
  const uint32_t ring = sq + L::RING;
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(smem + L::EXCHANGE);
  float* xbuf = reinterpret_cast<float*>(smem + L::STATS);
  const uint32_t qbar = sq + L::BARS;
  const uint32_t full = qbar + 8, empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS);
    }
    mbar_fence_init();
  }
  // what TMA never writes is zeros: the groups past ng of q and of the
  // tiles (their products add 0), and rows tpos .. TP of a tile (bs not
  // dividing TP), so that the value product multiplies p = 0 by 0, not by
  // stale bits
  if (ng < NG || tpos < TP) {
    for (int i = threadIdx.x; i < L::EXCHANGE / 16; i += THREADS) {
      const bool in_q = i < L::RING / 16;
      const int grp = in_q ? i / (SUB / 16)
                           : (i - L::RING / 16) / (GB / 16) % NG;
      const int r = in_q ? 0 : (i - L::RING / 16) % (GB / 16) / 8;
      if (grp >= ng || r >= tpos)
        reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  // warp 0: tile t's nbt x ng boxes into stage `stage`, lane l issuing
  // boxes l, l + 32, ...; an entry past j1 loads a box past the pool's end,
  // which TMA fills with zeros
  const uint32_t bytes = nbt * ng * bs * 128;
  auto issue = [&](int t, int c0, int c1, int stage) {
    const uint32_t fb = full + 8 * stage;
    const uint32_t st = ring + stage * NG * GB;
    if (lane == 0) mbar_expect_tx(fb, bytes);
    __syncwarp();
    for (int i0 = 0; i0 < nbt * ng; i0 += 32) {
      const int i = i0 + lane, k = i / ng, g = i % ng;
      const int x0 = __shfl_sync(0xffffffffu, c0, k % 32);
      const int x1 = __shfl_sync(0xffffffffu, c1, k % 32);
      const int e = j0 + t * nbt + k < j1 ? (k < 32 ? x0 : x1) : -1;
      if (i < nbt * ng) {
        const int row = e < 0 ? n_blocks * bs : e * bs;
        const uint32_t dst = st + g * GB + k * bs * 128;
        if (g < nck) tma_load_3d(dst, &kvmap, fb, 64 * g, h, row);
        else tma_load_3d(dst, &k2map, fb, 64 * (g - nck), h, row);
      }
    }
  };
  if (threadIdx.x < 32 && n_tiles > 0) {
    if (lane == 0) {
      const int q_row = bh * G + ht * HEADS;  // the tile's first row of q
      tma_prefetch(&qmap); tma_prefetch(&q2map);
      tma_prefetch(&kvmap); tma_prefetch(&k2map);
      mbar_expect_tx(qbar, ng * SUB);
      for (int g = 0; g < nck; ++g)
        tma_load_2d(sq + g * SUB, &qmap, qbar, 64 * g, q_row);
      for (int g = nck; g < ng; ++g)
        tma_load_2d(sq + g * SUB, &q2map, qbar, 64 * (g - nck), q_row);
    }
    issue(0, e00, e01, 0);
    if (n_tiles > 1) issue(1, e10, e11, 1);
    entries(2, e00, e01);                   // tile 2's, for later
  }

  // warpgroup wg owns value columns [256 wg, 256 wg + 256) of the 64
  // heads, and scores half of each tile's positions
  constexpr int HALF = TP / 2;              // positions a warpgroup scores
  constexpr int NS = HALF / 2;              // their score registers a thread
  constexpr int KH = HALF / 16;             // their k16 steps of P V
  const int t = threadIdx.x % 128;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);            // its columns in each group of 8
  const int qp = (causal || has_window) ? q_pos[b] : 0;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // m is the same in both warpgroups; l sums this warpgroup's positions
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if (n_tiles > 0) {
    // q and q2 arrive unscaled: each element becomes q * scale rounded to
    // bf16, as the reference scales them (the swizzle does not matter)
    mbar_wait(qbar, 0);
    for (int i = threadIdx.x; i < ng * SUB / 16; i += THREADS) {
      uint4* v = reinterpret_cast<uint4*>(smem) + i;
      uint4 u = *v;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h2[k]);
        h2[k] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *v = u;
    }
    fence_async_smem();
    __syncthreads();
  }
  PipeState p;
  for (int it = 0; it < n_tiles; ++it) {
    const int pos0 = (j0 + it * nbt) * bs + HALF * wg;  // first scored here
    const int pend = min(j1 * bs, (j0 + it * nbt) * bs + tpos);
    mbar_wait(full + 8 * p.stage, p.phase);
    const uint32_t st = ring + p.stage * NG * GB;
    // S = [q | q2] [ckv | kr]^T over this warpgroup's positions: both
    // operands K-major, 4 k16 steps a column group, all NG unrolled (a
    // loop of wgmma without a wait between its iterations is serialized)
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_acc(s);
    wgmma_fence();
    // (a descriptor's start address is its low bits, in 16-byte units)
    const uint64_t da = make_desc(sq, 16, 1024);
    const uint64_t db = make_desc(st + HALF * wg * 128, 16, 1024);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t oa = (g * SUB + 32 * ks) / 16;
        const uint64_t ob = (g * GB + 32 * ks) / 16;
        if constexpr (HALF == 32) wgmma_m64n32k16<0, 0>(s, da + oa, db + ob);
        else wgmma_m64n16k16<0, 0>(s, da + oa, db + ob);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // softcap, masks, and the row max over the quad of threads that share
    // a row; the two warpgroups' maxima meet in shared memory
    unsigned ok = 0;                        // bit 2i + c: column 8i + cq + c
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pos0 + 8 * i + cq + (e & 1);
        float v = s[4 * i + e];
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        const bool a = pos < pend
                       && attended(pos, lim, qp, causal, has_window, window);
        if (a && e < 2) ok |= 1u << (2 * i + e);
        v = a ? v : kNegInf;
        s[4 * i + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      if (lane % 4 == 0) xbuf[HEADS * wg + r0 + 8 * hh] = mx[hh];
    }
    __syncthreads();
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float other = xbuf[HEADS * (1 - wg) + r0 + 8 * hh];
      const float m_new = fmaxf(m[hh], fmaxf(mx[hh], other));
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
    // p in fp32 for l; rounded to bf16 into this warpgroup's A fragments of
    // the value product (k16 step ks: its positions 16 ks .. 16 ks + 15;
    // registers (r0; c, c + 1), (r0 + 8; c, c + 1), (r0; c + 8, c + 9),
    // (r0 + 8; c + 8, c + 9)), stored to shared memory in the tile's
    // position order (warpgroup 0's steps first), from where both read all
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool a = (ok >> (2 * i + c)) & 1u;
          pv[c] = a ? expf(s[4 * i + 2 * hh + c] - m[hh]) : 0.f;
          rs[hh] += pv[c];
        }
        const __nv_bfloat162 pb = __floats2bfloat162_rn(pv[0], pv[1]);
        const uint32_t bits = *reinterpret_cast<const uint32_t*>(&pb);
        const int j = 4 * (i / 2) + 2 * (i % 2) + hh;
        pbuf[(KH * 4 * wg + j) * 128 + t] = bits;
      }
    }
    __syncthreads();
    uint32_t pa[2 * KH][4];
#pragma unroll
    for (int k = 0; k < 2 * KH; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[k][j] = pbuf[(4 * k + j) * 128 + t];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l[hh] = corr[hh] * l[hh] + rs[hh];
    }
    if (corr[0] != 1.f || corr[1] != 1.f) {  // the row maxima moved
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= corr[(i >> 1) & 1];
    }
    // acc += P V over the tile's positions: V this warpgroup's four value
    // groups, read MN-major (64-column atoms GB apart, 16 positions = 2 KB
    // a k16 step)
    const uint64_t dv = make_desc(st + 4 * wg * GB, GB, 1024);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2 * KH; ++ks)
      wgmma_m64n256k16_rs<1>(acc, pa[ks], dv + 2048 * ks / 16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty + 8 * p.stage);
    // warp 0: once both warpgroups have read this stage, tile it + STAGES
    // goes into it, and the table entries of the tile after are read
    if (threadIdx.x < 32 && it + STAGES < n_tiles) {
      static_assert(STAGES == 2, "entries kept for even and odd tiles");
      const bool odd = it & 1;
      mbar_wait(empty + 8 * p.stage, p.phase);
      issue(it + STAGES, odd ? e10 : e00, odd ? e11 : e01, p.stage);
      int n0, n1;
      entries(it + STAGES + 1, n0, n1);
      e00 = odd ? n0 : e00;
      e01 = odd ? n1 : e01;
      e10 = odd ? e10 : n0;
      e11 = odd ? e11 : n1;
    }
    p.advance<STAGES>();
  }
  // l over the whole tile: the two warpgroups' sums (the other's maxima are
  // read before the last tile's second barrier, so xbuf is free)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (lane % 4 == 0) xbuf[HEADS * wg + r0 + 8 * hh] = l[hh];
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[hh] = xbuf[r0 + 8 * hh] + xbuf[HEADS + r0 + 8 * hh];

  // the split's partial (acc as it is), or the output where one split
  // covers the row (l > 0 ? acc / max(l, 1e-30) : 0), staged in fp32 in the
  // shared memory the q tile and the ring held (every load has been
  // consumed), rows STAGE_PITCH floats apart, then stored in whole 16-byte
  // pieces of rows, so that each warp writes contiguous bytes
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // one division a row (128 a thread cost more than the whole tile loop
    // at decode): acc * (1 / max(l, 1e-30)), within an fp32 ulp of acc / l
    const bool live = l[hh] > 0.f;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    float* srow = stage + (r0 + 8 * hh) * STAGE_PITCH + 256 * wg + cq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = acc[4 * i + 2 * hh], y = acc[4 * i + 2 * hh + 1];
      if (n_split == 1) {
        x = live ? x * inv : 0.f;
        y = live ? y * inv : 0.f;
      }
      *reinterpret_cast<float2*>(srow + 8 * i) = make_float2(x, y);
    }
    const int g = ht * HEADS + r0 + 8 * hh;
    if (n_split > 1 && g < G && wg == 0 && lane % 4 == 0) {
      const size_t pr = ((size_t)bh * G + g) * n_split + split;
      part_ml[2 * pr] = m[hh];
      part_ml[2 * pr + 1] = l[hh];
    }
  }
  __syncthreads();
  const int rows = min(HEADS, G - ht * HEADS);
  if (n_split == 1) {
    for (int i = threadIdx.x; i < rows * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = 8 * (i % (D / 8));
      const float4 u = *reinterpret_cast<const float4*>(
          stage + r * STAGE_PITCH + c);
      const float4 v = *reinterpret_cast<const float4*>(
          stage + r * STAGE_PITCH + c + 4);
      const __nv_bfloat162 o[4] = {__floats2bfloat162_rn(u.x, u.y),
                                   __floats2bfloat162_rn(u.z, u.w),
                                   __floats2bfloat162_rn(v.x, v.y),
                                   __floats2bfloat162_rn(v.z, v.w)};
      *reinterpret_cast<uint4*>(out + ((size_t)bh * G + ht * HEADS + r) * D
                                + c) = *reinterpret_cast<const uint4*>(o);
    }
  } else {
    for (int i = threadIdx.x; i < rows * (D / 4); i += THREADS) {
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      const size_t pr = ((size_t)bh * G + ht * HEADS + r) * n_split + split;
      *reinterpret_cast<float4*>(part_acc + pr * D + c) =
          *reinterpret_cast<const float4*>(stage + r * STAGE_PITCH + c);
    }
  }
}

// One block per (head g, row b x KV head): each column merges the live
// splits -- those that start below the block holding kv_limit -- in split
// order, as paged_attention_combine_kernel does; a row with none comes out
// as zeros.  A thread takes four columns, eight splits' loads in flight.
__global__ void __launch_bounds__(COMBINE_THREADS)
mla_combine_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc,
                   const int* __restrict__ kv_limit,
                   __nv_bfloat16* __restrict__ out, int Hkv, int G, int D,
                   int bs, int nb, int per_split, int n_split) {
  const int g = blockIdx.x, bh = blockIdx.y;
  const int lim = kv_limit[bh / Hkv];
  const int n_used = lim < 0 ? 0 : min(nb, lim / bs + 1);
  const int n_live = (n_used + per_split - 1) / per_split;
  const size_t row = (size_t)bh * G + g, pr = row * n_split;
  float M = kNegInf;
#pragma unroll 8
  for (int s = 0; s < n_live; ++s) M = fmaxf(M, part_ml[2 * (pr + s)]);
  for (int c = 4 * threadIdx.x; c < D; c += 4 * COMBINE_THREADS) {
    float L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) {
      const float2 ml =
          *reinterpret_cast<const float2*>(part_ml + 2 * (pr + s));
      const float4 x =
          *reinterpret_cast<const float4*>(part_acc + (pr + s) * D + c);
      const float f = expf(ml.x - M);
      L += ml.y * f;
      a.x += x.x * f;
      a.y += x.y * f;
      a.z += x.z * f;
      a.w += x.w * f;
    }
    const float den = fmaxf(L, 1e-30f);
    const bool any = L > 0.f;
    Pair<__nv_bfloat16>::store(out + row * D + c, any ? a.x / den : 0.f,
                               any ? a.y / den : 0.f);
    Pair<__nv_bfloat16>::store(out + row * D + c + 2, any ? a.z / den : 0.f,
                               any ? a.w / den : 0.f);
  }
}

template <int TP, int NG>
int launch_tiles(const CUtensorMap (&maps)[4], const void* tables,
                 const void* kv_limit, const void* q_pos, void* out,
                 void* part_ml, void* part_acc, float scale, int B, int Hkv,
                 int G, int D, int D2, int bs, int nb, int n_blocks,
                 int per_split, int n_split, int causal, int has_window,
                 int window, float softcap, cudaStream_t s) {
  auto* kernel = mla_hopper_kernel<TP, NG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int smem = Smem<TP, NG>::BYTES;
  const dim3 grid((G + HEADS - 1) / HEADS, n_split, B * Hkv);
  kernel<<<grid, THREADS, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const int*)tables,
      (const int*)kv_limit, (const int*)q_pos, (__nv_bfloat16*)out,
      (float*)part_ml, (float*)part_acc, scale, Hkv, G, D, D2, bs, nb,
      n_blocks, per_split, n_split, causal, has_window, window, softcap);
  const int err = moe_last_error();
  if (err != 0 || n_split == 1) return err;
  mla_combine_kernel<<<dim3(G, B * Hkv), COMBINE_THREADS, 0, s>>>(
      (const float*)part_ml, (const float*)part_acc, (const int*)kv_limit,
      (__nv_bfloat16*)out, Hkv, G, D, bs, nb, per_split, n_split);
  return moe_last_error();
}

// TMA maps of q (B Hkv G, D) and q2 in boxes of 64 rows x 64 columns, and
// of the pools (n_blocks bs, Hkv, D or D2) in boxes of one pool block's bs
// positions x 64 columns of one KV head; columns past D or D2 read zeros
int launch(const void* q, const void* q2, const void* kv_pool,
           const void* k2_pool, const void* tables, const void* kv_limit,
           const void* q_pos, void* out, void* part_ml, void* part_acc,
           float scale, int B, int Hkv, int G, int D, int D2, int bs, int nb,
           int n_blocks, int per_split, int n_split, int causal,
           int has_window, int window, float softcap, cudaStream_t s) {
  CUtensorMap maps[4];
  const uint64_t rows = (uint64_t)B * Hkv * G;
  const uint64_t dq[2] = {(uint64_t)D, rows}, sq_[1] = {(uint64_t)D * 2};
  const uint64_t dq2[2] = {(uint64_t)D2, rows}, sq2[1] = {(uint64_t)D2 * 2};
  const uint32_t bq[2] = {64, HEADS};
  const uint64_t pos = (uint64_t)n_blocks * bs;
  const uint64_t dkv[3] = {(uint64_t)D, (uint64_t)Hkv, pos};
  const uint64_t skv[2] = {(uint64_t)D * 2, (uint64_t)Hkv * D * 2};
  const uint64_t dk2[3] = {(uint64_t)D2, (uint64_t)Hkv, pos};
  const uint64_t sk2[2] = {(uint64_t)D2 * 2, (uint64_t)Hkv * D2 * 2};
  const uint32_t bkv[3] = {64, 1, (uint32_t)bs};
  if (!hopper::tensor_map(&maps[0], q, 2, dq, sq_, bq)
      || !hopper::tensor_map(&maps[2], kv_pool, 3, dkv, skv, bkv))
    return (int)cudaErrorInvalidValue;
  if (D2 == 0) {                  // no rope-key groups: maps 1, 3 unread
    maps[1] = maps[0];
    maps[3] = maps[2];
  } else if (!hopper::tensor_map(&maps[1], q2, 2, dq2, sq2, bq)
             || !hopper::tensor_map(&maps[3], k2_pool, 3, dk2, sk2, bkv)) {
    return (int)cudaErrorInvalidValue;
  }
#define MOE_MLA_LAUNCH(TP, NG)                                               \
  launch_tiles<TP, NG>(maps, tables, kv_limit, q_pos, out, part_ml,          \
                       part_acc, scale, B, Hkv, G, D, D2, bs, nb, n_blocks,  \
                       per_split, n_split, causal, has_window, window,       \
                       softcap, s)
  if (groups(D, D2) <= 9) return MOE_MLA_LAUNCH(64, 9);
  if (bs > 32) return (int)cudaErrorInvalidValue;   // a block a tile at most
  return MOE_MLA_LAUNCH(32, 10);
#undef MOE_MLA_LAUNCH
}

}  // namespace mla

}  // namespace

MOE_API int moe_paged_attention(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* kv_limit, const void* q_pos,
                                void* out, void* part_ml, void* part_acc,
                                float scale, int B, int Hkv, int G, int D,
                                int Dv, int bs, int nb, int per_split,
                                int n_split, int warps, int causal,
                                int has_window, int window, float softcap,
                                int dtype, void* stream) {
  if (B == 0 || Hkv == 0 || G == 0) return moe_last_error();
  if (D <= 0 || Dv <= 0 || D % 8 != 0 || Dv % 8 != 0 ||
      D > GQA_MAX_WIDTH || Dv > GQA_MAX_WIDTH || bs <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  // the splits cover the table entries, each split at least one of them
  if (per_split <= 0 || n_split <= 0 || n_split > 65535 ||
      (long)per_split * n_split < nb || (long)per_split * (n_split - 1) >= nb)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (part_ml == nullptr || part_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > GQA_WARPS) return (int)cudaErrorInvalidValue;
  if ((causal || has_window) && q_pos == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, kv_limit, q_pos,
                                 out, part_ml, part_acc, scale, B, Hkv, G, D,
                                 Dv, bs, nb, per_split, n_split, warps,
                                 causal, has_window, window, softcap, s);
  return launch<float>(q, k_pool, v_pool, tables, kv_limit, q_pos, out,
                       part_ml, part_acc, scale, B, Hkv, G, D, Dv, bs, nb,
                       per_split, n_split, warps, causal, has_window, window,
                       softcap, s);
}

MOE_API int moe_paged_attention_mla(
    const void* q, const void* q2, const void* kv_pool, const void* k2_pool,
    const void* tables, const void* kv_limit, const void* q_pos, void* out,
    void* part_ml, void* part_acc, float scale, int B, int Hkv, int G, int D,
    int D2, int bs, int nb, int n_blocks, int per_split, int n_split,
    int causal, int has_window, int window, float softcap, int dtype,
    void* stream) {
  if (B == 0 || Hkv == 0 || G == 0) return moe_last_error();
  if (D <= 0 || D2 < 0 || D % 8 != 0 || D2 % 8 != 0 ||
      D + D2 > 64 * MLA_QP || D > 64 * MLA_VP || bs <= 0 ||
      bs > MLA_MAX_BS || nb <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if ((causal || has_window) && q_pos == nullptr)
    return (int)cudaErrorInvalidValue;
  // the splits cover the table entries, each split at least one of them
  if (per_split <= 0 || n_split <= 0 || n_split > 65535 ||
      (long)per_split * n_split < nb || (long)per_split * (n_split - 1) >= nb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16) {
    if (n_split > 1 && (part_ml == nullptr || part_acc == nullptr))
      return (int)cudaErrorInvalidValue;
    return mla::launch(q, q2, kv_pool, k2_pool, tables, kv_limit, q_pos, out,
                       part_ml, part_acc, scale, B, Hkv, G, D, D2, bs, nb,
                       n_blocks, per_split, n_split, causal, has_window,
                       window, softcap, s);
  }
  // fp32: one pass over the whole table on CUDA cores, q and q2 scaled
  // by the caller (scale unused)
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  return launch_mla<float>(q, q2, kv_pool, k2_pool, tables, kv_limit, q_pos,
                           out, B, Hkv, G, D, D2, bs, nb, causal, has_window,
                           window, softcap, s);
}
