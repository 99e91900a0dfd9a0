// paged_decode: single-token GQA decode over a paged KV cache, for Hopper
// (sm_90a), every page tier.
//
// Replaces the Pallas TPU kernel _paged_attn_kernel
// (tpu_flash/ops/decode/paged.py:122) together with its _MultiPageCopy
// page walk (:50): the TPU kernel DMAs the pages of each kv block into
// VMEM by hand; here each thread block walks the page table itself and
// reads the page rows straight from device memory (coalesced, 16-byte
// vector loads for K, one element per thread and row for V).
//
// Computes, per (batch row, kv head) -- one thread block holding all
// q_per_kv query rows of that kv head -- the TPU kernel's arithmetic:
//   q' = q * sm_scale in f32;
//   kv blocks of bk = pages_per_block * page_size tokens, walked in order
//   from the sliding window's first block to the last block holding
//   tokens (with an exact recent ring the pages cover [0, max(L - W, 1))
//   and the ring joins the same softmax state as a final block);
//   softcap, masks (length, window), ALiBi; online softmax; deferred
//   normalisation with optional sink logits; optional (m, l) out.
// K and V each have a tier (k8v4 pairs int8 K with int4 V):
//   f32: q' . k, p . v;  bf16: bf16(q') . k, bf16(p) . v;
//   int8 / int4 / fp8 exact: (q' . k) * k_scale, (p * v_scale) . v on
//     the stored values (int4 nibbles token-packed, sign-extended: byte
//     row j of a page holds token j low, token j + ps/2 high; fp8 e4m3);
//   int8 / int4 "mxu": q' quantized per row to int8 by absmax / 127,
//     integer dot, * q_scale * k_scale; p * v_scale quantized per row
//     over the WHOLE bk block to [0, 127], integer dot, * p_scale;
//   fp8 native: q' and p * v_scale rows renormalized into e4m3 (by
//     absmax / 448), dotted with the e4m3 pages (exact products), times
//     the row scales;
//   int4g32 (unsigned nibbles, per-token (scale, zero) for each of the
//     4 channel groups of 32): score = sum over g = 0..3 in order of
//     (bf16(q'_g) . k4_g) * s_g + sum(q'_g) * z_g; PV channel c of group
//     g = bf16(p * s_g) . v4_c + sum(p * z_g).
//   Rounding is half to even (rintf, and the e4m3 conversion's RNE), as
//   jnp.round and astype; divisions are IEEE (no fast math).
// Every dot and sum is order-free: the products (exact in f64: f32 times
// a bf16/f32/e4m3/integer value) are summed in f64 and rounded to f32
// once, and every other f32 step rounds on its own (__fmul_rn/__fadd_rn,
// no FMA contraction) in the order the plain version takes. So on the
// same inputs the kernel gives the plain version's output bit for bit
// whatever the thread layout (f64 sums of bf16, e4m3 and integer products
// are exact; of f32 products they round some 2^-29 of an f32 ulp apart).
// A summation-order ulp would otherwise flip e4m3 and int8 roundings
// downstream and reach greedy tokens.
//
// What bounds it on this card: bytes. Decode reads every cached K/V byte
// once per step and does ~2 FLOPs per byte per query row, far below the
// ~295 FLOP/byte ridge, so the bound is HBM at 3.35 TB/s; the 4-bit tiers
// halve the payload bytes of int8, so their bound halves too, but this
// first kernel unpacks nibbles and applies scales on the CUDA cores per
// element. The grid is one block per (batch, kv head): b * hkv blocks, 64
// at the Llama-3-8B decode shape (b 8, hkv 8), under one wave of 132 SMs,
// so each block must pull its pages at several times its share of
// bandwidth. Splitting the kv walk over more blocks (split-K with a
// merge) and tensor-core dots are later work.
//
// Layout: q/o [b, hq, d]; pages [hkv, num_pages, rows, d] with rows = ps
// (ps / 2 for int4 and int4g32); scales f32 [hkv, num_pages, ps], or
// [hkv, num_pages, 8, ps] for int4g32 (4 scale rows, then 4 zero rows);
// lengths int32 [b]; page_indices int32 [b, pps]; ring [b, hkv, W, d]
// bf16; m/l out f32 [b, hq]; all contiguous, pages 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 128;        // head dim (the only one this build serves)
constexpr int NG = D / 32;    // int4g32 channel groups
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_G = 8;      // q heads per kv head
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

enum Tier {
  kF32 = 0, kBF16 = 1, kInt8 = 2, kInt8Mxu = 3, kInt4 = 4, kInt4Mxu = 5,
  kInt4G32 = 6, kFp8 = 7, kFp8Native = 8
};

// What each tier stores and how it computes.
template <int T>
struct Tr {
  static constexpr bool packed = T == kInt4 || T == kInt4Mxu || T == kInt4G32;
  static constexpr bool mxu = T == kInt8Mxu || T == kInt4Mxu;
  static constexpr bool group = T == kInt4G32;
  static constexpr bool native8 = T == kFp8Native;
  static constexpr bool token_scaled =
      T == kInt8 || T == kInt8Mxu || T == kInt4 || T == kInt4Mxu ||
      T == kFp8 || T == kFp8Native;
};
template <int T> struct Store { using type = int8_t; };
template <> struct Store<kF32> { using type = float; };
template <> struct Store<kBF16> { using type = __nv_bfloat16; };
template <> struct Store<kFp8> { using type = __nv_fp8_e4m3; };
template <> struct Store<kFp8Native> { using type = __nv_fp8_e4m3; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_e4m3(float x) {
  return static_cast<float>(__nv_fp8_e4m3(x));
}

// The value of stored element x of tier T; `hi` picks the high nibble of
// a packed byte.
template <int T, typename S>
__device__ __forceinline__ float elem(S x, bool hi) {
  if constexpr (T == kInt4G32) {
    const unsigned b = static_cast<uint8_t>(x);
    return (float)(hi ? (b >> 4) : (b & 0xFu));
  } else if constexpr (Tr<T>::packed) {
    const int b = static_cast<int>(x);  // sign-extended byte
    return (float)(hi ? (b >> 4) : ((int)((unsigned)b << 28) >> 28));
  } else if constexpr (T == kInt8 || T == kInt8Mxu) {
    return (float)x;
  } else {
    return to_f(x);
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct DecodeParams {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;   // nullptr for f32/bf16 pages
  const float* v_scales;
  const int* lengths;
  const int* page_indices;
  const __nv_bfloat16* ring_k;  // nullptr: no ring
  const __nv_bfloat16* ring_v;
  const float* sinks;      // [hq] or nullptr
  const float* alibi;      // [hq] or nullptr
  void* o;
  float* m_out;            // [b, hq] or nullptr
  float* l_out;
  int hq, hkv, num_pages, ps, pps, bk, ring_w, g;
  float scale;
  int window;              // <= 0: none
  float softcap, inv_softcap;  // softcap <= 0: none
};

// One side's pages of one kv head: where token `pos` of a sequence lives.
template <int T>
struct Side {
  using S = typename Store<T>::type;
  const S* pages;      // this head's pages
  const float* scales;  // this head's scales (nullptr: none)
  const int* table;
  int ps;

  __device__ Side(const void* all_pages, const float* all_scales,
                  const int* table_, int h, const DecodeParams& p)
      : table(table_), ps(p.ps) {
    const long long rows = Tr<T>::packed ? p.ps / 2 : p.ps;
    pages = static_cast<const S*>(all_pages) + h * p.num_pages * rows * D;
    const long long srows = Tr<T>::group ? 2 * NG : 1;
    scales = all_scales != nullptr
                 ? all_scales + h * p.num_pages * srows * p.ps
                 : nullptr;
  }
  // Row pointer and nibble half of token `pos`.
  __device__ __forceinline__ const S* row(int pos, bool& hi) const {
    const int page = table[pos / ps], off = pos % ps;
    if constexpr (Tr<T>::packed) {
      const int half = ps / 2;
      hi = off >= half;
      return pages + ((long long)page * half + off % half) * D;
    } else {
      hi = false;
      return pages + ((long long)page * ps + off) * D;
    }
  }
  // The per-token scale of `pos`.
  __device__ __forceinline__ float token_scale(int pos) const {
    return scales[(long long)table[pos / ps] * ps + pos % ps];
  }
  // int4g32: row j (0..2*NG-1) of the (scale, zero) rows at `pos`.
  __device__ __forceinline__ float group_row(int pos, int j) const {
    const long long page = table[pos / ps];
    return scales[(page * 2 * NG + j) * ps + pos % ps];
  }
};

// One f32 rounding per step, never fused into an FMA.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Loads lane `sub`'s slice of one K row: elements (c * 8 + sub) * CE +
// [0, CE) for chunks c, CE = 16 / sizeof(S) elements per 16-byte chunk,
// so 8 lanes read one row's bytes contiguously.
template <int T, typename S>
__device__ __forceinline__ void load_row_slice(const S* row, int sub, bool hi,
                                               float* out) {
  constexpr int CE = 16 / sizeof(S);
  constexpr int CHUNKS = D / 8 / CE;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e0 = (c * 8 + sub) * CE;
    const uint4 raw = *reinterpret_cast<const uint4*>(row + e0);
    const S* vals = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int e = 0; e < CE; ++e) out[c * CE + e] = elem<T>(vals[e], hi);
  }
}
template <typename S>
__device__ __forceinline__ int slice_elem(int i, int sub) {
  constexpr int CE = 16 / sizeof(S);
  return ((i / CE) * 8 + sub) * CE + i % CE;
}

template <typename TQ, int KT, int VT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(DecodeParams p) {
  using KS = typename Store<KT>::type;
  constexpr int SLICE = D / 8;
  extern __shared__ double smem[];
  const int G = p.g;
  const int sc_w = p.bk > p.ring_w ? p.bk : p.ring_w;
  double* red = smem;  // [THREADS / D][G][D] PV partials (f64, or int32)
  // [G][D] q * scale (f32)
  float* qs = reinterpret_cast<float*>(red + (THREADS / D) * MAX_G * D);
  float* qop = qs + MAX_G * D;       // [G][D] the score operand of q
  float* acc = qop + MAX_G * D;      // [G][D]
  float* row_m = acc + MAX_G * D;
  float* row_l = row_m + MAX_G;
  float* row_alpha = row_l + MAX_G;
  float* row_qscale = row_alpha + MAX_G;
  float* row_pscale = row_qscale + MAX_G;
  float* row_qsum = row_pscale + MAX_G;  // [G][NG] int4g32 K: sum(q'_g)
  float* row_z = row_qsum + MAX_G * NG;  // [G][NG] int4g32 V: sum(p z_g)
  float* sc = row_z + MAX_G * NG;        // [G][sc_w] scores, then P

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const TQ* q = static_cast<const TQ*>(p.q) + ((long long)b * p.hq + h * G) * D;
  const int* table = p.page_indices + (long long)b * p.pps;
  const Side<KT> ks(p.k_pages, p.k_scales, table, h, p);
  const Side<VT> vs(p.v_pages, p.v_scales, table, h, p);

  const int L = p.lengths[b];
  const int eff = p.ring_w > 0 ? max(L - p.ring_w, 1) : L;
  const int page_limit = p.ring_w > 0 ? max(L - p.ring_w, 0) : L;
  const int num_active = (eff + p.bk - 1) / p.bk;
  int first = 0;
  if (p.window > 0 && eff - p.window > 0) first = (eff - p.window) / p.bk;

  for (int idx = tid; idx < G * D; idx += THREADS) {
    const float x = mul(to_f(q[idx]), p.scale);
    qs[idx] = x;
    qop[idx] = (KT == kBF16 || KT == kInt4G32) ? round_bf16(x) : x;
    acc[idx] = 0.f;
  }
  if (tid < G) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  __syncthreads();
  if constexpr (Tr<KT>::mxu || Tr<KT>::native8) {
    // Per-row quantization of q': int8 (round half to even, then clip)
    // or e4m3 (RNE).
    if (warp < G) {
      float a = 0.f;
      for (int c = lane; c < D; c += 32) a = fmaxf(a, fabsf(qs[warp * D + c]));
      a = warp_max(a);
      const float top = Tr<KT>::mxu ? 127.f : 448.f;
      const float qscale = (a == 0.f) ? 1.f : a / top;
      for (int c = lane; c < D; c += 32) {
        const float x = qs[warp * D + c] / qscale;
        qop[warp * D + c] = Tr<KT>::mxu ? fminf(fmaxf(rintf(x), -127.f), 127.f)
                                        : round_e4m3(x);
      }
      if (lane == 0) row_qscale[warp] = qscale;
    }
  }
  if constexpr (Tr<KT>::group) {
    // sum(q'_g) in f32, one thread per (row, group).
    if (tid < G * NG) {
      const int r = tid / NG, gi = tid % NG;
      double s = 0.0;
      for (int c = 0; c < 32; ++c) s += qs[r * D + gi * 32 + c];
      row_qsum[tid] = (float)s;
    }
  }
  __syncthreads();

  // Online-softmax update over the scores in sc[g][0, width): row max,
  // P, l; then P is turned into the PV operand of the tier.
  auto softmax_rows = [&](int width, bool ring, int blk0) {
    if (warp < G) {
      const int g = warp;
      float* srow = sc + g * sc_w;
      float mc = -INFINITY;
      for (int t = lane; t < width; t += 32) mc = fmaxf(mc, srow[t]);
      mc = warp_max(mc);
      const float m_prev = row_m[g];
      const float m_next = fmaxf(m_prev, mc);
      const float alpha = expf(m_prev - m_next);
      double lsum = 0.0;
      float pmax = 0.f;
      double zs[NG];
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) zs[gi] = 0.0;
      for (int t = lane; t < width; t += 32) {
        float pp = expf(srow[t] - m_next);
        lsum += pp;
        if (ring || VT == kBF16) {
          pp = round_bf16(pp);
        } else if constexpr (Tr<VT>::token_scaled) {
          pp = mul(pp, vs.token_scale(blk0 + t));
          pmax = fmaxf(pmax, pp);
        } else if constexpr (Tr<VT>::group) {
#pragma unroll
          for (int gi = 0; gi < NG; ++gi)
            zs[gi] += (double)pp * vs.group_row(blk0 + t, NG + gi);
        }
        srow[t] = pp;
      }
      lsum = warp_sum(lsum);
      if constexpr (Tr<VT>::mxu || Tr<VT>::native8) {
        if (!ring) {
          pmax = warp_max(pmax);
          const float top = Tr<VT>::mxu ? 127.f : 448.f;
          const float pscale = (pmax == 0.f) ? 1.f : pmax / top;
          for (int t = lane; t < width; t += 32) {
            const float x = srow[t] / pscale;
            srow[t] = Tr<VT>::mxu ? fminf(fmaxf(rintf(x), 0.f), 127.f)
                                  : round_e4m3(x);
          }
          if (lane == 0) row_pscale[g] = pscale;
        }
      }
      if constexpr (Tr<VT>::group) {
        if (!ring) {
#pragma unroll
          for (int gi = 0; gi < NG; ++gi) {
            const double z = warp_sum(zs[gi]);
            if (lane == 0) row_z[g * NG + gi] = (float)z;
          }
        }
      }
      if (lane == 0) {
        row_l[g] = add(mul(row_l[g], alpha), (float)lsum);
        row_m[g] = m_next;
        row_alpha[g] = alpha;
      }
    }
    __syncthreads();
  };

  // acc = acc * alpha + P V over `width` rows. vval(t, c) is element c of
  // V row t; vscale(t, gi) the int4g32 group scale of row t. Integer P
  // (mxu) sums in int32, the others in f64; e4m3 P (fp8 native) and the
  // int4g32 sums end with their row terms.
  constexpr int TG = THREADS / D;  // token groups
  auto pv_rows = [&](int width, auto tier, auto vval, auto vscale) {
    constexpr int T = decltype(tier)::value;
    const int c = tid % D, tg = tid / D;
    if constexpr (Tr<T>::mxu) {
      int part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0;
      for (int t = tg; t < width; t += TG) {
        const int vv = (int)vval(t, c);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] += (int)sc[g * sc_w + t] * vv;
      }
      int* redi = reinterpret_cast<int*>(red);
      for (int g = 0; g < G; ++g) redi[(tg * MAX_G + g) * D + c] = part[g];
    } else {
      double part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.0;
      for (int t = tg; t < width; t += TG) {
        const double vv = vval(t, c);
        if constexpr (Tr<T>::group) {
          const float s_g = vscale(t, c / 32);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G)
              part[g] = fma((double)round_bf16(mul(sc[g * sc_w + t], s_g)),
                            vv, part[g]);
        } else {
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) part[g] = fma((double)sc[g * sc_w + t], vv, part[g]);
        }
      }
      for (int g = 0; g < G; ++g) red[(tg * MAX_G + g) * D + c] = part[g];
    }
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += THREADS) {
      const int g = idx / D, cc = idx % D;
      float out;
      if constexpr (Tr<T>::mxu) {
        const int* redi = reinterpret_cast<const int*>(red);
        int s = 0;
        for (int k = 0; k < TG; ++k) s += redi[(k * MAX_G + g) * D + cc];
        out = mul((float)s, row_pscale[g]);
      } else {
        double s = 0.0;
        for (int k = 0; k < TG; ++k) s += red[(k * MAX_G + g) * D + cc];
        out = (float)s;
        if constexpr (Tr<T>::native8) out = mul(out, row_pscale[g]);
        if constexpr (Tr<T>::group) out = add(out, row_z[g * NG + cc / 32]);
      }
      acc[idx] = add(mul(acc[idx], row_alpha[g]), out);
    }
    __syncthreads();
  };

  for (int blk = first; blk < num_active; ++blk) {
    const int blk0 = blk * p.bk;
    // Scores: 8 lanes per token, 4 tokens per warp, 32 per block pass.
    // Every lane runs every pass (the shuffles need the whole warp).
    const int sub = lane % 8;
    for (int base = 0; base < p.bk; base += 32) {
      const int t0 = base + warp * 4 + lane / 8;
      const bool live = t0 < p.bk;
      const int pos = blk0 + (live ? t0 : 0);
      bool hi;
      const KS* krow = ks.row(pos, hi);
      float kv[SLICE];
      if (live) {
        load_row_slice<KT>(krow, sub, hi, kv);
      } else {
#pragma unroll
        for (int i = 0; i < SLICE; ++i) kv[i] = 0.f;
      }
      double dot[MAX_G];
      int idot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        dot[g] = 0.0;
        idot[g] = 0;
        if (g < G) {
#pragma unroll
          for (int i = 0; i < SLICE; ++i) {
            const float qv = qop[g * D + slice_elem<KS>(i, sub)];
            if constexpr (Tr<KT>::mxu) {
              idot[g] += (int)qv * (int)kv[i];
            } else {
              dot[g] = fma((double)qv, (double)kv[i], dot[g]);
            }
          }
        }
      }
      // int4g32: a lane's 16 channels lie in group sub / 2, so a lane
      // pair sums one group; the others sum the whole row.
      constexpr int OFF0 = Tr<KT>::group ? 2 : 8;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
        for (int o = 1; o < OFF0; o <<= 1) {
          if constexpr (Tr<KT>::mxu) {
            idot[g] += __shfl_xor_sync(0xffffffffu, idot[g], o);
          } else {
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
          }
        }
      }
      double gdot[MAX_G][NG];
      if constexpr (Tr<KT>::group) {
        const int lane0 = lane & ~7;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
#pragma unroll
          for (int gi = 0; gi < NG; ++gi)
            gdot[g][gi] = __shfl_sync(0xffffffffu, dot[g], lane0 + 2 * gi);
      }
      if (live && sub == 0) {
        float kscale = 1.f;
        if constexpr (Tr<KT>::token_scaled) kscale = ks.token_scale(pos);
        float gs[NG], gz[NG];
        if constexpr (Tr<KT>::group) {
#pragma unroll
          for (int gi = 0; gi < NG; ++gi) {
            gs[gi] = ks.group_row(pos, gi);
            gz[gi] = ks.group_row(pos, NG + gi);
          }
        }
        for (int g = 0; g < G; ++g) {
          float s;
          if constexpr (Tr<KT>::mxu) {
            s = mul(mul((float)idot[g], row_qscale[g]), kscale);
          } else if constexpr (Tr<KT>::native8) {
            s = mul(mul((float)dot[g], row_qscale[g]), kscale);
          } else if constexpr (Tr<KT>::group) {
            s = 0.f;
#pragma unroll
            for (int gi = 0; gi < NG; ++gi)
              s = add(add(s, mul((float)gdot[g][gi], gs[gi])),
                      mul(row_qsum[g * NG + gi], gz[gi]));
          } else if constexpr (Tr<KT>::token_scaled) {
            s = mul((float)dot[g], kscale);
          } else {
            s = (float)dot[g];
          }
          if (p.softcap > 0.f)
            s = mul(p.softcap, tanhf(mul(s, p.inv_softcap)));
          bool valid = pos < page_limit;
          if (p.window > 0) valid = valid && pos >= eff - p.window;
          if (p.alibi != nullptr)
            s = add(s, mul(p.alibi[h * G + g], (float)(pos - (eff - 1))));
          sc[g * sc_w + t0] = valid ? s : MASK_VALUE;
        }
      }
    }
    __syncthreads();
    softmax_rows(p.bk, false, blk0);
    pv_rows(
        p.bk, std::integral_constant<int, VT>(),
        [&](int t, int c) {
          bool hi;
          const auto* vrow = vs.row(blk0 + t, hi);
          return elem<VT>(vrow[c], hi);
        },
        [&](int t, int gi) {
          if constexpr (Tr<VT>::group) return vs.group_row(blk0 + t, gi);
          return 1.f;
        });
  }

  if (p.ring_w > 0) {
    // The exact recent ring as a final block: row j holds position
    // last - ((last - j) % W) (C remainder, as lax.rem).
    const int W = p.ring_w;
    const __nv_bfloat16* rk =
        p.ring_k + ((long long)b * p.hkv + h) * (long long)W * D;
    const __nv_bfloat16* rv =
        p.ring_v + ((long long)b * p.hkv + h) * (long long)W * D;
    const int last = L - 1;
    const int sub = lane % 8;
    for (int base = 0; base < W; base += 32) {
      const int j0 = base + warp * 4 + lane / 8;
      const bool live = j0 < W;
      float kv[SLICE];
      if (live) {
        load_row_slice<kBF16>(rk + (long long)j0 * D, sub, false, kv);
      } else {
#pragma unroll
        for (int i = 0; i < SLICE; ++i) kv[i] = 0.f;
      }
      double dot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        dot[g] = 0.0;
        if (g < G) {
#pragma unroll
          for (int i = 0; i < SLICE; ++i)
            dot[g] = fma(
                (double)round_bf16(qs[g * D + slice_elem<__nv_bfloat16>(i, sub)]),
                (double)kv[i], dot[g]);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      }
      if (live && sub == 0) {
        const int pj = last - (last - j0) % W;
        const bool valid = pj >= page_limit && pj <= last;
        for (int g = 0; g < G; ++g) {
          float s = (float)dot[g];
          if (p.softcap > 0.f)
            s = mul(p.softcap, tanhf(mul(s, p.inv_softcap)));
          if (p.alibi != nullptr)
            s = add(s, mul(p.alibi[h * G + g], (float)(pj - last)));
          sc[g * sc_w + j0] = valid ? s : MASK_VALUE;
        }
      }
    }
    __syncthreads();
    softmax_rows(W, true, 0);
    pv_rows(
        W, std::integral_constant<int, kBF16>(),
        [&](int t, int c) { return __bfloat162float(rv[(long long)t * D + c]); },
        [&](int, int) { return 1.f; });
  }

  // Deferred normalisation (sink logit folded in once).
  TQ* o = static_cast<TQ*>(p.o) + ((long long)b * p.hq + h * G) * D;
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D;
    const float m = row_m[g], l = row_l[g];
    float mult;
    if (p.sinks != nullptr) {
      const float sk = p.sinks[h * G + g];
      const float m2 = fmaxf(m, sk);
      const float scale_m = expf(m - m2);
      mult = scale_m / add(mul(l, scale_m), expf(sk - m2));
    } else {
      mult = (l == 0.f) ? 1.f : 1.f / l;
    }
    o[idx] = from_f<TQ>(mul(acc[idx], mult));
  }
  if (p.m_out != nullptr && tid < G) {
    p.m_out[(long long)b * p.hq + h * G + tid] = row_m[tid];
    p.l_out[(long long)b * p.hq + h * G + tid] = row_l[tid];
  }
}

size_t smem_bytes(int bk, int ring_w) {
  const int sc_w = bk > ring_w ? bk : ring_w;
  return sizeof(double) * (THREADS / D) * MAX_G * D +
         sizeof(float) * (3 * MAX_G * D + 5 * MAX_G + 2 * MAX_G * NG +
                          (size_t)MAX_G * sc_w);
}

template <typename TQ, int KT, int VT>
int launch(const DecodeParams& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.bk, p.ring_w);
  cudaFuncSetAttribute(paged_decode_kernel<TQ, KT, VT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(p.hkv, batch);
  paged_decode_kernel<TQ, KT, VT><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The (K tier, V tier) pairs this build serves: each tier with itself,
// and k8v4's int8 K with int4 V (exact and mxu).
template <typename TQ>
int launch_tiers(const DecodeParams& p, int k_tier, int v_tier, int batch,
                 cudaStream_t stream) {
  if (k_tier == kInt8 && v_tier == kInt4)
    return launch<TQ, kInt8, kInt4>(p, batch, stream);
  if (k_tier == kInt8Mxu && v_tier == kInt4Mxu)
    return launch<TQ, kInt8Mxu, kInt4Mxu>(p, batch, stream);
  if (k_tier != v_tier) return (int)cudaErrorInvalidValue;
  switch (k_tier) {
    case kF32: return launch<TQ, kF32, kF32>(p, batch, stream);
    case kBF16: return launch<TQ, kBF16, kBF16>(p, batch, stream);
    case kInt8: return launch<TQ, kInt8, kInt8>(p, batch, stream);
    case kInt8Mxu: return launch<TQ, kInt8Mxu, kInt8Mxu>(p, batch, stream);
    case kInt4: return launch<TQ, kInt4, kInt4>(p, batch, stream);
    case kInt4Mxu: return launch<TQ, kInt4Mxu, kInt4Mxu>(p, batch, stream);
    case kInt4G32: return launch<TQ, kInt4G32, kInt4G32>(p, batch, stream);
    case kFp8: return launch<TQ, kFp8, kFp8>(p, batch, stream);
    case kFp8Native:
      return launch<TQ, kFp8Native, kFp8Native>(p, batch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q and o). k_tier / v_tier: 0 f32,
// 1 bf16, 2 int8 (exact dequant), 3 int8 (int8 q and P), 4 int4 (exact),
// 5 int4 (int8 q and P), 6 int4g32, 7 fp8 (exact), 8 fp8 (e4m3 q and P).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a configuration this build does not serve.
extern "C" int paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* lengths,
    const void* page_indices, const void* ring_k, const void* ring_v,
    const void* sinks, const void* alibi, void* o, void* m_out, void* l_out,
    int q_dtype, int k_tier, int v_tier, int batch, int hq, int hkv,
    int num_pages, int page_size, int pages_per_seq, int block_tokens,
    int ring_w, int head_dim, float scale, int window, float softcap,
    float inv_softcap, void* stream) {
  const bool packed = k_tier == kInt4 || k_tier == kInt4Mxu ||
                      k_tier == kInt4G32 || v_tier == kInt4 ||
                      v_tier == kInt4Mxu || v_tier == kInt4G32;
  if (head_dim != D || hq % hkv != 0 || hq / hkv > MAX_G ||
      (q_dtype != 0 && q_dtype != 1) || (packed && page_size % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeParams p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.page_indices = static_cast<const int*>(page_indices);
  p.ring_k = static_cast<const __nv_bfloat16*>(ring_k);
  p.ring_v = static_cast<const __nv_bfloat16*>(ring_v);
  p.sinks = static_cast<const float*>(sinks);
  p.alibi = static_cast<const float*>(alibi);
  p.o = o;
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.hq = hq;
  p.hkv = hkv;
  p.num_pages = num_pages;
  p.ps = page_size;
  p.pps = pages_per_seq;
  p.bk = block_tokens;
  p.ring_w = ring_w;
  p.g = hq / hkv;
  p.scale = scale;
  p.window = window;
  p.softcap = softcap;
  p.inv_softcap = inv_softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_dtype == 0 ? launch_tiers<float>(p, k_tier, v_tier, batch, s)
                      : launch_tiers<__nv_bfloat16>(p, k_tier, v_tier, batch,
                                                    s);
}
