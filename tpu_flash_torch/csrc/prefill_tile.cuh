// prefill_tile.cuh: the tile engine shared by paged_prefill.cu (K5) and
// ragged_prefill.cu (K6).
//
// A thread block owns BQ = 64 query rows of one (batch row, kv head): the
// q_per_kv query heads of that kv head stacked over `qp = BQ / q_per_kv`
// chunk positions (GQA folding), so every K/V row a block reads serves all
// of its heads. It walks kv *blocks* in the order the TPU kernel walks
// them; a block is `width` kv columns, cut into sub-tiles of Geo<D>::BK
// rows staged in shared memory as f32: 128 rows at head widths up to 128,
// 64 at d 256 (Q, K and V rows of 256 floats: 128-row sub-tiles would
// need 365 KB, 64-row ones take 218 KB of the card's 227).
//
// The TPU kernels take one online-softmax step per block: the running max
// covers the whole block before P is rounded to the value dtype. A block
// wider than one sub-tile therefore takes two passes here: the first
// computes S for each sub-tile only to find the block's row max, the
// second recomputes S, forms P = exp(S - m) with that max, rounds it and
// accumulates P V. A block of one sub-tile keeps S, K and V from the first
// pass. Sub-tiles whose every column is masked for every row of the block
// are skipped (their P is exactly 0 after a real column, and a row whose
// whole block is masked is wiped by the next block's alpha = 0 either
// way), so are whole blocks with no live sub-tile.
//
// Loaders fetch K/V rows through a per-row source index (-1: a zero row),
// so garbage history columns never reach a sum. Values are rounded to the
// query dtype after dequantization (int8, int4 or e4m3 * per-token scale
// in f32), as the TPU kernel's `dequant` does; token-packed int4 pages
// hold token j of a page in the low nibble of byte row j and token
// j + ps/2 in the high nibble, both sign-extended; q is scaled in its
// own dtype; masked scores take MASK_VALUE; ALiBi adds slope * (kv_pos -
// q_pos); sinks join the denominator once at the end; a row with l == 0
// divides by 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace prefill {

constexpr int BQ = 64;    // query rows per block (heads x positions)
constexpr int THREADS = 256;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

// The tile geometry of head width D (64, 128 or 256; the builds serve
// 128 and 256).
template <int D>
struct Geo {
  static constexpr int BK = D > 128 ? 64 : 128;  // kv rows per sub-tile
  static constexpr int QS = D + 4;  // padded row strides (floats), 16-byte
  static constexpr int KS = D + 4;  // aligned
  static constexpr int SS = BK + 4;
  static constexpr int CW = BK / 4;  // score columns per softmax thread
  static constexpr size_t smem_bytes =
      sizeof(float) * (BQ * QS + BK * KS + BK * D + BQ * SS + 4 * BQ) +
      sizeof(long long) * BK;
  static_assert(smem_bytes <= 232448, "over the card's 227 KB a block");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// One byte of token-packed int4 pages (two tokens' nibbles).
struct Int4Tokens {
  int8_t bits;
};

template <typename T>
__device__ __forceinline__ float piece_elem(T x, bool) { return to_f(x); }
__device__ __forceinline__ float piece_elem(Int4Tokens x, bool hi) {
  const int b = x.bits;  // sign-extended byte
  return (float)(hi ? (b >> 4) : ((int)((unsigned)b << 28) >> 28));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to T and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// What every launch of either kernel shares.
struct RowParams {
  const void* q;       // [b, hq, q_len, d]
  void* o;             // like q
  const float* sinks;  // [hq] or nullptr
  const float* alibi;  // [hq] or nullptr
  int hq, hkv, g, qp, q_len;
  float scale;         // sm_scale, already rounded to the q dtype
  int window;          // <= 0: none
  float softcap, inv_softcap;  // softcap <= 0: none
  int page_size;       // tokens a page (read by int4 pages only)
};

// Shared memory of one block and the position of a row.
template <int D>
struct Smem {
  using G = Geo<D>;
  float* Qs;         // [BQ][QS] scaled q
  float* Ks;         // [BK][KS]
  float* Vs;         // [BK][D]
  float* Ss;         // [BQ][SS] scores, then P
  float* row_m;      // [BQ] running max
  float* row_l;      // [BQ] running sum
  float* row_alpha;  // [BQ] this block's rescale
  float* row_bmax;   // [BQ] this block's max
  long long* row_src;  // [BK] source row of each staged kv row, -1: zero

  __device__ explicit Smem(float* base) {
    Qs = base;
    Ks = Qs + BQ * G::QS;
    Vs = Ks + G::BK * G::KS;
    Ss = Vs + G::BK * D;
    row_m = Ss + BQ * G::SS;
    row_l = row_m + BQ;
    row_alpha = row_l + BQ;
    row_bmax = row_alpha + BQ;
    row_src = reinterpret_cast<long long*>(row_bmax + BQ);
  }
};

// Row r of a block: head kvh * g + r / qp at chunk position
// q_first + r % qp; inactive past the chunk or past g * qp rows.
struct Rows {
  int kvh, q_first, g, qp, q_len;
  __device__ int head_in_group(int r) const { return r / qp; }
  __device__ int pos(int r) const { return q_first + r % qp; }
  __device__ bool active(int r) const {
    return r / qp < g && q_first + r % qp < q_len;
  }
};

// What the mask needs of one of a thread's four score rows, computed once
// per block: the row's chunk position, whether it is live, its ALiBi slope.
struct RowInfo {
  int pos;
  bool active;
  float slope;
};

// The RowInfo of rows ty * 4 + i, i < 4, of this thread.
__device__ __forceinline__ void row_infos(const RowParams& p, const Rows& rows,
                                          RowInfo (&ri)[4]) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    ri[i].pos = rows.pos(r);
    ri[i].active = rows.active(r);
    ri[i].slope = 0.f;
    if (p.alibi != nullptr && ri[i].active)
      ri[i].slope = p.alibi[rows.kvh * rows.g + rows.head_in_group(r)];
  }
}

template <typename TQ, int D>
__device__ __forceinline__ void load_q(const RowParams& p, const Rows& rows,
                                       const Smem<D>& sm, int b) {
  constexpr int QS = Geo<D>::QS;
  const TQ* q = static_cast<const TQ*>(p.q);
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (rows.active(r)) {
      const int h = rows.kvh * rows.g + rows.head_in_group(r);
      const long long off =
          (((long long)b * p.hq + h) * p.q_len + rows.pos(r)) * D + c;
      x = round_to<TQ>(to_f(q[off]) * p.scale);
    }
    sm.Qs[r * QS + c] = x;
  }
  if (tid < BQ) {
    sm.row_m[tid] = -INFINITY;
    sm.row_l[tid] = 0.f;
  }
}

// Stage kv rows [t0, t0 + n) of a block: row t comes from source row
// src(t) of kbase/vbase (times its scale where scales are given), rounded
// to TQ; rows past n and rows with src -1 are zero. Rows are read in
// 16-byte pieces (the wrappers pass 16-byte aligned tensors). For int4
// pages the source row is the token's (page * ps + offset), its scale's
// index; its byte row is (page * ps/2 + offset % (ps/2)).
template <int D, typename TK>
__device__ __forceinline__ void load_piece(const TK* base, long long s,
                                           int c0, const float* scale,
                                           int ps, float* out) {
  constexpr int CE = 16 / sizeof(TK);
  const TK* row = base + s * D;
  bool hi = false;
  if constexpr (std::is_same<TK, Int4Tokens>::value) {
    const int half = ps / 2, off = (int)(s % ps);
    hi = off >= half;
    row = base + ((s / ps) * half + off % half) * D;
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(row + c0);
  const TK* vals = reinterpret_cast<const TK*>(&raw);
  const float sc = scale != nullptr ? scale[s] : 1.f;
#pragma unroll
  for (int e = 0; e < CE; ++e) {
    const float x = piece_elem(vals[e], hi);
    out[e] = scale != nullptr ? x * sc : x;
  }
}

template <typename TQ, int D, typename TK, typename Src>
__device__ __forceinline__ void stage(const Smem<D>& sm, int t0, int n,
                                      bool with_v, const TK* kbase,
                                      const TK* vbase, const float* kscale,
                                      const float* vscale, int ps, Src src) {
  constexpr int BK = Geo<D>::BK, KS = Geo<D>::KS;
  constexpr int CE = 16 / sizeof(TK);  // elements per 16-byte piece
  constexpr int PIECES = D / CE;       // pieces per row
  const int tid = threadIdx.x;
  if (tid < BK) sm.row_src[tid] = tid < n ? src(t0 + tid) : -1LL;
  __syncthreads();  // also: earlier readers of Ks/Vs/Ss are done
  for (int idx = tid; idx < BK * PIECES; idx += THREADS) {
    const int r = idx / PIECES, c0 = (idx % PIECES) * CE;
    const long long s = sm.row_src[r];
    float kx[CE], vx[CE];
    if (s >= 0) {
      load_piece<D>(kbase, s, c0, kscale, ps, kx);
      if (with_v) load_piece<D>(vbase, s, c0, vscale, ps, vx);
    } else {
#pragma unroll
      for (int e = 0; e < CE; ++e) kx[e] = vx[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      sm.Ks[r * KS + c0 + e] = round_to<TQ>(kx[e]);
      if (with_v) sm.Vs[r * D + c0 + e] = round_to<TQ>(vx[e]);
    }
  }
  __syncthreads();
}

// S = Qs Ks^T for the staged rows, softcapped and masked into Ss; columns
// past n are -inf (not part of the block). mask(row info, kv_col, s)
// returns the score with ALiBi added, or MASK_VALUE.
template <int D, typename Mask>
__device__ __forceinline__ void scores(const RowParams& p, const Smem<D>& sm,
                                       const RowInfo (&ri)[4], int t0, int n,
                                       Mask mask) {
  constexpr int BK = Geo<D>::BK, QS = Geo<D>::QS, KS = Geo<D>::KS,
                SS = Geo<D>::SS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float s[4][BK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) s[i][j] = 0.f;
  for (int kk = 0; kk < D; kk += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(&sm.Qs[(ty * 4 + i) * QS + kk]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(&sm.Ks[(tx + 16 * j) * KS + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv.x, a);
        a = fmaf(qv[i].y, kv.y, a);
        a = fmaf(qv[i].z, kv.z, a);
        a = fmaf(qv[i].w, kv.w, a);
        s[i][j] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const int t = tx + 16 * j;
      float x = s[i][j];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_softcap);
      sm.Ss[r * SS + t] = t < n ? mask(ri[i], t0 + t, x) : -INFINITY;
    }
  }
  __syncthreads();
}

// Fold the staged scores' row max into row_bmax (4 threads per row).
template <int D>
__device__ __forceinline__ void block_max(const Smem<D>& sm) {
  constexpr int SS = Geo<D>::SS, CW = Geo<D>::CW;
  const int tid = threadIdx.x, r = tid / 4, part = tid % 4;
  float mc = -INFINITY;
  for (int c = part * CW; c < part * CW + CW; ++c)
    mc = fmaxf(mc, sm.Ss[r * SS + c]);
  mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
  mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
  if (part == 0) sm.row_bmax[r] = fmaxf(sm.row_bmax[r], mc);
}

// P = exp(S - m) into Ss rounded to TQ (the value dtype), l += sum(P)
// unrounded, then acc += P V.
template <typename TQ, int D>
__device__ __forceinline__ void accumulate(const Smem<D>& sm,
                                           float (&acc)[4][D / 16]) {
  constexpr int BK = Geo<D>::BK, SS = Geo<D>::SS, CW = Geo<D>::CW;
  const int tid = threadIdx.x;
  {
    const int r = tid / 4, part = tid % 4;
    const float m = sm.row_m[r];
    float lsum = 0.f;
    for (int c = part * CW; c < part * CW + CW; ++c) {
      const float pp = expf(sm.Ss[r * SS + c] - m);
      lsum += pp;
      sm.Ss[r * SS + c] = round_to<TQ>(pp);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    if (part == 0) sm.row_l[r] += lsum;
  }
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;
  for (int t = 0; t < BK; t += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(&sm.Ss[(ty * 4 + i) * SS + t]);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const int c = tx + 16 * j;
      const float v0 = sm.Vs[(t + 0) * D + c], v1 = sm.Vs[(t + 1) * D + c];
      const float v2 = sm.Vs[(t + 2) * D + c], v3 = sm.Vs[(t + 3) * D + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = acc[i][j];
        a = fmaf(pv[i].x, v0, a);
        a = fmaf(pv[i].y, v1, a);
        a = fmaf(pv[i].z, v2, a);
        a = fmaf(pv[i].w, v3, a);
        acc[i][j] = a;
      }
    }
  }
}

// One online-softmax step over the kv block [blk0, blk0 + width).
// live(j0, j1): some column of [j0, j1) is visible to some row.
template <typename TQ, int D, typename TK, typename Src, typename Live,
          typename Mask>
__device__ __forceinline__ void attend_block(const RowParams& p,
                             const Smem<D>& sm,
                             const RowInfo (&ri)[4],
                             float (&acc)[4][D / 16], int blk0, int width,
                             const TK* kbase, const TK* vbase,
                             const float* kscale, const float* vscale,
                             Src src, Live live, Mask mask) {
  constexpr int BK = Geo<D>::BK;
  const int tid = threadIdx.x;
  const int nsub = (width + BK - 1) / BK;
  int n_live = 0;
  for (int sb = 0; sb < nsub; ++sb) {
    const int t0 = blk0 + sb * BK;
    if (live(t0, t0 + min(BK, blk0 + width - t0))) ++n_live;
  }
  if (n_live == 0) return;
  const bool single = n_live == 1;

  // Pass 1: the block's row max.
  if (tid < BQ) sm.row_bmax[tid] = -INFINITY;
  for (int sb = 0; sb < nsub; ++sb) {
    const int t0 = blk0 + sb * BK, n = min(BK, blk0 + width - t0);
    if (!live(t0, t0 + n)) continue;
    stage<TQ>(sm, t0, n, single, kbase, vbase, kscale, vscale, p.page_size,
              src);
    scores(p, sm, ri, t0, n, mask);
    block_max(sm);
  }
  __syncthreads();
  if (tid < BQ) {
    const float m_prev = sm.row_m[tid];
    const float m_next = fmaxf(m_prev, sm.row_bmax[tid]);
    const float alpha = expf(m_prev - m_next);
    sm.row_m[tid] = m_next;
    sm.row_l[tid] *= alpha;
    sm.row_alpha[tid] = alpha;
  }
  __syncthreads();
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = sm.row_alpha[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] *= a;
  }

  // Pass 2: P with the block's max, then P V.
  for (int sb = 0; sb < nsub; ++sb) {
    const int t0 = blk0 + sb * BK, n = min(BK, blk0 + width - t0);
    if (!live(t0, t0 + n)) continue;
    if (!single) {
      stage<TQ>(sm, t0, n, true, kbase, vbase, kscale, vscale, p.page_size,
                src);
      scores(p, sm, ri, t0, n, mask);
    }
    accumulate<TQ>(sm, acc);
  }
  __syncthreads();  // readers of Ss/Vs done before the next stage
}

// Deferred normalisation (the sink logit folded in once) and the store.
template <typename TQ, int D>
__device__ __forceinline__ void store_rows(const RowParams& p, const Rows& rows,
                           const Smem<D>& sm, const float (&acc)[4][D / 16],
                           int b) {
  __syncthreads();
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  TQ* o = static_cast<TQ*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (!rows.active(r)) continue;
    const int h = rows.kvh * rows.g + rows.head_in_group(r);
    const float m = sm.row_m[r], l = sm.row_l[r];
    float mult;
    if (p.sinks != nullptr) {
      const float sk = p.sinks[h];
      const float m2 = fmaxf(m, sk);
      const float scale_m = expf(m - m2);
      mult = scale_m / (l * scale_m + expf(sk - m2));
    } else {
      mult = (l == 0.f) ? 1.f : 1.f / l;
    }
    const long long off =
        (((long long)b * p.hq + h) * p.q_len + rows.pos(r)) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[off + tx + 16 * j] = from_f<TQ>(acc[i][j] * mult);
  }
}

}  // namespace prefill
