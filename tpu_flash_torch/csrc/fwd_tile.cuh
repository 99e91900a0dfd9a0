// fwd_tile.cuh: the bf16 attention forward's block body on the tensor
// cores (FlashAttention-2 on mma.sync), shared by flash_fwd.cu (K1, the
// product kernel) and variant_fwd.cu (K13, the harness that A/Bs its tile
// shapes, mask mode and exponential), so the harness times the code the
// product runs.
//
// A block owns BQ q rows; each of its BQ / 16 warps owns 16 of them. q is
// scaled and rounded to bf16 once (q' = bf16(q * scale), the TPU kernels'
// `q * sm_scale` in q's dtype) into padded shared memory, read as the A
// operand by ldmatrix. K and V are staged BKM kv rows at a time, bf16, by
// cp.async into one K and one V buffer: the next stage's K is in flight
// while this stage's softmax and P V run, its V while the next S runs.
// Every BKV kv rows (the online-softmax step, which fixes which running
// max each P element is rounded after) a warp computes S = q' K^T into f32
// accumulator registers, applies the caller's score transform and masks
// to each element at its (row, column), takes the running max and sum of
// its rows with quad shuffles, rounds P = exp(s - m_next) to bf16 in
// registers (the accumulator layout is the A operand's, so P goes into
// O += P V with no shared-memory round trip; V is the B operand by
// ldmatrix.trans) and keeps O in f32 registers. Normalisation is the
// caller's, after the walk.
//
// A step no row of a warp sees (the caller's `skip`: above the diagonal,
// below the window, past sq) would change none of its rows' outputs and
// is not computed; a step that needs no compare (`masked` false)
// skips them, and with no per-element option either (`plain`) its scores
// only change units (`unit`).

#pragma once

#include <math.h>

#include "tc.cuh"

namespace tc {

constexpr float FWD_MASK_VALUE = -0.7f * 3.4028234663852886e38f;

// The block geometry: BQ q rows (BQ / 16 warps), BKM kv rows staged a
// stage, BKV kv rows an online-softmax step; K, V and Q tiles of row
// stride D + 8 in shared memory.
template <int D_, int BQ_, int BKM_, int BKV_>
struct FwdTiles {
  static constexpr int D = D_, BQ = BQ_, BKM = BKM_, BKV = BKV_;
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 8;
  static constexpr size_t smem = sizeof(bf16) * (BQ + 2 * BKM) * LD;
  static_assert(BQ % 16 == 0 && BKV % 16 == 0 && BKM % BKV == 0 &&
                    D % 16 == 0,
                "unsupported tile shape");
  static_assert(smem <= 232448, "over the card's 227 KB a block");
};

template <bool EXP2>
__device__ __forceinline__ float fwd_exp(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

// A thread's share of its warp's 16 q rows (lane group gr = lane / 4, tq
// = lane % 4): O's accumulator for rows gr and gr + 8, columns
// 8 n + 2 tq + {0, 1}; each row's running max, and its running sum over
// the thread's own columns (the quad's sum after fwd_block returns).
template <int D>
struct FwdRows {
  float o[D / 8][4];
  float m[2], l[2];
};

// The block's walk: q rows [q0, q0 + BQ) of q ([sq, D], rows at or past
// sq as zeros) times `scale` into shared memory, then kv stages first..last
// of k and v ([>= kv_rows, D]; rows at or past kv_rows staged as zeros).
// `score` gives, per warp and step (k0: the step's first kv row),
// skip(k0) and masked(k0), warp-uniform; per element score(s, q row, kv
// row, masked) -> the score or FWD_MASK_VALUE; and plain(), true where an
// unmasked step's scores need only unit(s) (no per-element option).
// q, k and v are 16-byte aligned; smem holds G::smem bytes.
template <class G, bool EXP2, class Score>
__device__ __forceinline__ void fwd_block(const bf16* q, const bf16* k,
                                          const bf16* v, int q0, int sq,
                                          int kv_rows, float scale,
                                          int first, int last,
                                          const Score& score,
                                          FwdRows<G::D>& r,
                                          unsigned char* smem) {
  constexpr int D = G::D, BQ = G::BQ, BKM = G::BKM, BKV = G::BKV;
  constexpr int LD = G::LD, NT = G::THREADS;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                   // [BKM][LD]
  bf16* Vs = Ks + BKM * LD;                  // [BKM][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;  // the warp's rows in the tile

  if (first <= last) {
    load_rows<D, BKM, NT, LD>(Ks, k, first * BKM, kv_rows);
    cp_async_commit();
    load_rows<D, BKM, NT, LD>(Vs, v, first * BKM, kv_rows);
    cp_async_commit();
  }
  // q' = bf16(q * scale), 8 elements a thread at a time.
  for (int i = threadIdx.x; i < BQ * (D / 8); i += NT) {
    const int row = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + row < sq)
      raw = *reinterpret_cast<const uint4*>(q + (long long)(q0 + row) * D + c);
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 outv;
    uint32_t* out = reinterpret_cast<uint32_t*>(&outv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(in[e]);
      out[e] = pack(x.x * scale, x.y * scale);
    }
    *reinterpret_cast<uint4*>(Qs + row * LD + c) = outv;
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) r.o[n][e] = 0.f;
  r.m[0] = r.m[1] = -INFINITY;
  r.l[0] = r.l[1] = 0.f;
  const uint32_t qs = smem_addr(Qs), ks = smem_addr(Ks), vs = smem_addr(Vs);
  const int row0 = q0 + wr + gr;  // the thread's q rows: row0, row0 + 8

  for (int st = first; st <= last; ++st) {
#pragma unroll 1
    for (int t0 = 0; t0 < BKM; t0 += BKV) {
      const int k0 = st * BKM + t0;
      const bool last_step = t0 + BKV == BKM;
      if (t0 == 0) {  // this stage's K (and, the first time, q') is in
        cp_async_wait<1>();
        __syncthreads();
      }
      const bool live = !score.skip(k0);
      float s[BKV / 8][4];
      if (live) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t qa[4];
          ldsm(qa, qs + a_off<LD>(lane, wr, kk));
#pragma unroll
          for (int j = 0; j < BKV / 8; j += 2) {
            uint32_t kb[4];
            ldsm(kb, ks + b_off<LD>(lane, t0 + j * 8, kk));
            mma(s[j], qa, kb[0], kb[1]);
            mma(s[j + 1], qa, kb[2], kb[3]);
          }
        }
      }
      if (last_step) {  // every warp has its S: K's buffer takes the next
        __syncthreads();
        if (st < last)
          load_rows<D, BKM, NT, LD>(Ks, k, (st + 1) * BKM, kv_rows);
        cp_async_commit();
      }
      if (live) {
        const bool masked = score.masked(k0);
        if (masked || !score.plain()) {
#pragma unroll
          for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = score(s[j][e], row0 + 8 * (e >> 1),
                              k0 + j * 8 + 2 * tq + (e & 1), masked);
        } else {
#pragma unroll
          for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = score.unit(s[j][e]);
        }
        float mx[2] = {r.m[0], r.m[1]};
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          alpha[h] = fwd_exp<EXP2>(r.m[h] - mx[h]);
          r.m[h] = mx[h];
        }
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pp = fwd_exp<EXP2>(s[j][e] - mx[e >> 1]);
            sum[e >> 1] += pp;
            s[j][e] = pp;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) r.l[h] = r.l[h] * alpha[h] + sum[h];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) r.o[n][e] *= alpha[e >> 1];
      }
      if (t0 == 0) {  // this stage's V is in (the next K may be in flight)
        if (BKM == BKV)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();
      }
      if (live) {
#pragma unroll
        for (int c = 0; c < BKV / 16; ++c) {
          uint32_t pa[4];
          to_a(pa, s, c);  // P, rounded to bf16
#pragma unroll
          for (int n = 0; n < D; n += 16) {
            uint32_t vb[4];
            ldsm_t(vb, vs + a_off<LD>(lane, t0 + c * 16, n));
            mma(r.o[n / 8], pa, vb[0], vb[1]);
            mma(r.o[n / 8 + 1], pa, vb[2], vb[3]);
          }
        }
      }
      if (last_step) {  // every warp is past P V: V's buffer takes the next
        __syncthreads();
        if (st < last)
          load_rows<D, BKM, NT, LD>(Vs, v, (st + 1) * BKM, kv_rows);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.l[h] += __shfl_xor_sync(0xffffffffu, r.l[h], 1);
    r.l[h] += __shfl_xor_sync(0xffffffffu, r.l[h], 2);
  }
}

// Row h (0: gr, 1: gr + 8) of the thread's share of O, times `mult`, as
// bf16 pairs into out ([rows, D] at the row's start).
template <int D>
__device__ __forceinline__ void fwd_store_row(bf16* out, const FwdRows<D>& r,
                                              int h, float mult) {
  const int tq = (threadIdx.x & 31) & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * tq) =
        pack(r.o[n][2 * h] * mult, r.o[n][2 * h + 1] * mult);
}

}  // namespace tc
