// paged_decode: single-token GQA decode over a paged KV cache, for Hopper
// (sm_90a).
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
//   scores by page tier: f32 (q' . k), bf16 (bf16(q') . k), int8 exact
//   ((q' . k8) * k_scale), int8 "mxu" (q' quantized per row to int8 by
//   absmax / 127, integer dot, * q_scale * k_scale);
//   softcap, masks (length, window), ALiBi; online softmax;
//   P V by tier: f32 (p), bf16 (bf16(p)), int8 exact (p * v_scale),
//   int8 "mxu" (p * v_scale quantized per row over the WHOLE bk block to
//   [0, 127], integer dot, * p_scale). Rounding is half to even
//   (rintf), as jnp.round; divisions are IEEE (no fast math).
//   Deferred normalisation with optional sink logits; optional (m, l) out.
//
// What bounds it on this card: bytes. Decode reads every cached K/V byte
// once per step and does ~2 FLOPs per byte per query row, far below the
// ~295 FLOP/byte ridge, so the bound is HBM at 3.35 TB/s. The grid is one
// block per (batch, kv head): b * hkv blocks, 64 at the Llama-3-8B decode
// shape (b 8, hkv 8), under one wave of 132 SMs, so each block must pull
// its pages at several times its share of bandwidth. Splitting the kv
// walk over more blocks (split-K with a merge) is later work.
//
// Layout: q/o [b, hq, d]; pages [hkv, num_pages, ps, d]; scales f32
// [hkv, num_pages, ps]; lengths int32 [b]; page_indices int32 [b, pps];
// ring [b, hkv, W, d] bf16; m/l out f32 [b, hq]; all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head dim (the only one this build serves)
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_G = 8;      // q heads per kv head
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

enum Tier { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt8Mxu = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int TIER>
struct PageType;
template <>
struct PageType<kF32> { using T = float; };
template <>
struct PageType<kBF16> { using T = __nv_bfloat16; };
template <>
struct PageType<kInt8> { using T = int8_t; };
template <>
struct PageType<kInt8Mxu> { using T = int8_t; };

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Loads lane `sub`'s slice of one K row: elements (c * 8 + sub) * CE +
// [0, CE) for chunks c, CE = 16 / sizeof(T) elements per 16-byte chunk,
// so 8 lanes read one row's bytes contiguously.
template <typename T>
__device__ __forceinline__ void load_row_slice(const T* row, int sub,
                                               float* out) {
  constexpr int CE = 16 / sizeof(T);
  constexpr int CHUNKS = D / 8 / CE;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e0 = (c * 8 + sub) * CE;
    const uint4 raw = *reinterpret_cast<const uint4*>(row + e0);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < CE; ++e) out[c * CE + e] = to_f(vals[e]);
  }
}
template <typename T>
__device__ __forceinline__ int slice_elem(int i, int sub) {
  constexpr int CE = 16 / sizeof(T);
  return ((i / CE) * 8 + sub) * CE + i % CE;
}

template <typename TQ, int TIER>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(DecodeParams p) {
  using TK = typename PageType<TIER>::T;
  constexpr int SLICE = D / 8;
  extern __shared__ float smem[];
  const int G = p.g;
  const int sc_w = p.bk > p.ring_w ? p.bk : p.ring_w;
  float* qs = smem;                  // [G][D] q * scale (f32)
  float* qop = qs + MAX_G * D;       // [G][D] the score operand of q
  float* acc = qop + MAX_G * D;      // [G][D]
  float* red = acc + MAX_G * D;      // [THREADS / D][G][D] PV partials
  float* row_m = red + (THREADS / D) * MAX_G * D;
  float* row_l = row_m + MAX_G;
  float* row_alpha = row_l + MAX_G;
  float* row_qscale = row_alpha + MAX_G;
  float* row_pscale = row_qscale + MAX_G;
  float* sc = row_pscale + MAX_G;    // [G][sc_w] scores, then P

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const TQ* q = static_cast<const TQ*>(p.q) + ((long long)b * p.hq + h * G) * D;
  const TK* kp = static_cast<const TK*>(p.k_pages) +
                 (long long)h * p.num_pages * p.ps * D;
  const TK* vp = static_cast<const TK*>(p.v_pages) +
                 (long long)h * p.num_pages * p.ps * D;
  const float* ks = p.k_scales != nullptr
                        ? p.k_scales + (long long)h * p.num_pages * p.ps
                        : nullptr;
  const float* vs = p.v_scales != nullptr
                        ? p.v_scales + (long long)h * p.num_pages * p.ps
                        : nullptr;
  const int* table = p.page_indices + (long long)b * p.pps;

  const int L = p.lengths[b];
  const int eff = p.ring_w > 0 ? max(L - p.ring_w, 1) : L;
  const int page_limit = p.ring_w > 0 ? max(L - p.ring_w, 0) : L;
  const int num_active = (eff + p.bk - 1) / p.bk;
  int first = 0;
  if (p.window > 0 && eff - p.window > 0) first = (eff - p.window) / p.bk;

  for (int idx = tid; idx < G * D; idx += THREADS) {
    const float x = to_f(q[idx]) * p.scale;
    qs[idx] = x;
    qop[idx] = (TIER == kBF16) ? round_bf16(x) : x;
    acc[idx] = 0.f;
  }
  if (tid < G) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  __syncthreads();
  if (TIER == kInt8Mxu && warp < G) {
    // Per-row int8 quantization of q' (round half to even, then clip).
    float a = 0.f;
    for (int c = lane; c < D; c += 32) a = fmaxf(a, fabsf(qs[warp * D + c]));
    a = warp_max(a);
    const float qscale = (a == 0.f) ? 1.f : a / 127.f;
    for (int c = lane; c < D; c += 32) {
      const float r = rintf(qs[warp * D + c] / qscale);
      qop[warp * D + c] = fminf(fmaxf(r, -127.f), 127.f);
    }
    if (lane == 0) row_qscale[warp] = qscale;
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
      float lsum = 0.f, pmax = 0.f;
      for (int t = lane; t < width; t += 32) {
        float pp = expf(srow[t] - m_next);
        lsum += pp;
        if (ring || TIER == kBF16) {
          pp = round_bf16(pp);
        } else if (TIER == kInt8 || TIER == kInt8Mxu) {
          const int pos = blk0 + t;
          const int page = table[pos / p.ps];
          pp = pp * vs[(long long)page * p.ps + pos % p.ps];
          pmax = fmaxf(pmax, pp);
        }
        srow[t] = pp;
      }
      lsum = warp_sum(lsum);
      if (TIER == kInt8Mxu && !ring) {
        pmax = warp_max(pmax);
        const float pscale = (pmax == 0.f) ? 1.f : pmax / 127.f;
        for (int t = lane; t < width; t += 32) {
          const float r = rintf(srow[t] / pscale);
          srow[t] = fminf(fmaxf(r, 0.f), 127.f);
        }
        if (lane == 0) row_pscale[g] = pscale;
      }
      if (lane == 0) {
        row_l[g] = row_l[g] * alpha + lsum;
        row_m[g] = m_next;
        row_alpha[g] = alpha;
      }
    }
    __syncthreads();
  };

  // acc = acc * alpha + P V over `width` rows; row t of V is at vrow(t).
  constexpr int TG = THREADS / D;  // token groups
  auto pv_rows = [&](int width, bool integer, auto vrow) {
    const int c = tid % D, tg = tid / D;
    if (integer) {
      int part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0;
      for (int t = tg; t < width; t += TG) {
        const int vv = (int)to_f(vrow(t)[c]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] += (int)sc[g * sc_w + t] * vv;
      }
      int* redi = reinterpret_cast<int*>(red);
      for (int g = 0; g < G; ++g) redi[(tg * MAX_G + g) * D + c] = part[g];
    } else {
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      for (int t = tg; t < width; t += TG) {
        const float vv = to_f(vrow(t)[c]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] = fmaf(sc[g * sc_w + t], vv, part[g]);
      }
      for (int g = 0; g < G; ++g) red[(tg * MAX_G + g) * D + c] = part[g];
    }
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += THREADS) {
      const int g = idx / D, cc = idx % D;
      float out;
      if (integer) {
        const int* redi = reinterpret_cast<const int*>(red);
        int s = 0;
        for (int k = 0; k < TG; ++k) s += redi[(k * MAX_G + g) * D + cc];
        out = (float)s * row_pscale[g];
      } else {
        out = 0.f;
        for (int k = 0; k < TG; ++k) out += red[(k * MAX_G + g) * D + cc];
      }
      acc[idx] = acc[idx] * row_alpha[g] + out;
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
      const int page = table[pos / p.ps];
      const long long row_off = ((long long)page * p.ps + pos % p.ps) * D;
      float kv[SLICE];
      if (live) {
        load_row_slice<TK>(kp + row_off, sub, kv);
      } else {
#pragma unroll
        for (int i = 0; i < SLICE; ++i) kv[i] = 0.f;
      }
      float dot[MAX_G];
      int idot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        dot[g] = 0.f;
        idot[g] = 0;
        if (g < G) {
#pragma unroll
          for (int i = 0; i < SLICE; ++i) {
            const float qv = qop[g * D + slice_elem<TK>(i, sub)];
            if (TIER == kInt8Mxu) {
              idot[g] += (int)qv * (int)kv[i];
            } else {
              dot[g] = fmaf(qv, kv[i], dot[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          if (TIER == kInt8Mxu) {
            idot[g] += __shfl_xor_sync(0xffffffffu, idot[g], o);
          } else {
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
          }
        }
      }
      if (live && sub == 0) {
        const float kscale =
            (TIER == kInt8 || TIER == kInt8Mxu) ? ks[row_off / D] : 1.f;
        for (int g = 0; g < G; ++g) {
          float s;
          if (TIER == kInt8Mxu) {
            s = (float)idot[g] * row_qscale[g];
            s = s * kscale;
          } else if (TIER == kInt8) {
            s = dot[g] * kscale;
          } else {
            s = dot[g];
          }
          if (p.softcap > 0.f) s = p.softcap * tanhf(s * p.inv_softcap);
          bool valid = pos < page_limit;
          if (p.window > 0) valid = valid && pos >= eff - p.window;
          if (p.alibi != nullptr)
            s += p.alibi[h * G + g] * (float)(pos - (eff - 1));
          sc[g * sc_w + t0] = valid ? s : MASK_VALUE;
        }
      }
    }
    __syncthreads();
    softmax_rows(p.bk, false, blk0);
    pv_rows(p.bk, TIER == kInt8Mxu, [&](int t) {
      const int pos = blk0 + t;
      const int page = table[pos / p.ps];
      return vp + ((long long)page * p.ps + pos % p.ps) * D;
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
        load_row_slice<__nv_bfloat16>(rk + (long long)j0 * D, sub, kv);
      } else {
#pragma unroll
        for (int i = 0; i < SLICE; ++i) kv[i] = 0.f;
      }
      float dot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        dot[g] = 0.f;
        if (g < G) {
#pragma unroll
          for (int i = 0; i < SLICE; ++i)
            dot[g] = fmaf(
                round_bf16(qs[g * D + slice_elem<__nv_bfloat16>(i, sub)]),
                kv[i], dot[g]);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      }
      if (live && sub == 0) {
        const int pj = last - (last - j0) % W;
        const bool valid = pj >= page_limit && pj <= last;
        for (int g = 0; g < G; ++g) {
          float s = dot[g];
          if (p.softcap > 0.f) s = p.softcap * tanhf(s * p.inv_softcap);
          if (p.alibi != nullptr) s += p.alibi[h * G + g] * (float)(pj - last);
          sc[g * sc_w + j0] = valid ? s : MASK_VALUE;
        }
      }
    }
    __syncthreads();
    softmax_rows(W, true, 0);
    pv_rows(W, false, [&](int t) { return rv + (long long)t * D; });
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
      mult = scale_m / (l * scale_m + expf(sk - m2));
    } else {
      mult = (l == 0.f) ? 1.f : 1.f / l;
    }
    o[idx] = from_f<TQ>(acc[idx] * mult);
  }
  if (p.m_out != nullptr && tid < G) {
    p.m_out[(long long)b * p.hq + h * G + tid] = row_m[tid];
    p.l_out[(long long)b * p.hq + h * G + tid] = row_l[tid];
  }
}

size_t smem_bytes(int bk, int ring_w) {
  const int sc_w = bk > ring_w ? bk : ring_w;
  return sizeof(float) * (3 * MAX_G * D + (THREADS / D) * MAX_G * D +
                          5 * MAX_G + (size_t)MAX_G * sc_w);
}

template <typename TQ, int TIER>
int launch(const DecodeParams& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.bk, p.ring_w);
  cudaFuncSetAttribute(paged_decode_kernel<TQ, TIER>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(p.hkv, batch);
  paged_decode_kernel<TQ, TIER><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_tier(const DecodeParams& p, int tier, int batch,
                cudaStream_t stream) {
  switch (tier) {
    case kF32: return launch<TQ, kF32>(p, batch, stream);
    case kBF16: return launch<TQ, kBF16>(p, batch, stream);
    case kInt8: return launch<TQ, kInt8>(p, batch, stream);
    case kInt8Mxu: return launch<TQ, kInt8Mxu>(p, batch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q and o). tier: 0 f32 pages,
// 1 bf16 pages, 2 int8 pages (exact dequant), 3 int8 pages (int8 q and P).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a configuration this build does not serve.
extern "C" int paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* lengths,
    const void* page_indices, const void* ring_k, const void* ring_v,
    const void* sinks, const void* alibi, void* o, void* m_out, void* l_out,
    int q_dtype, int tier, int batch, int hq, int hkv, int num_pages,
    int page_size, int pages_per_seq, int block_tokens, int ring_w,
    int head_dim, float scale, int window, float softcap, float inv_softcap,
    void* stream) {
  if (head_dim != D || hq % hkv != 0 || hq / hkv > MAX_G ||
      (q_dtype != 0 && q_dtype != 1) || tier < 0 || tier > 3) {
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
  return q_dtype == 0 ? launch_tier<float>(p, tier, batch, s)
                      : launch_tier<__nv_bfloat16>(p, tier, batch, s);
}
