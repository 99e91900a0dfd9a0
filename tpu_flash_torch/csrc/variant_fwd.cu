// variant_fwd: the causal-forward variant harness's kernel for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of tpu_flash/bench/experiments.py
// (:30, launched by variant_attention :119, pallas_call :135): a
// standalone copy of the causal forward, parametrized so that variants can
// be A/B'd on the card before a winner goes into the product kernel. One
// template instance per variant:
//   MASK_ALL  true: "always" (compare and select on every tile); false:
//             "diag" (only kv stages that cross the diagonal are masked;
//             a stage wholly below it takes every score as it is);
//   EXP2      exp2f with log2 e folded into the q scale (by the wrapper),
//             against expf;
//   BQ, BKM, BKV  the three block sizes. The TPU's are VMEM tiles of up to
//             1024 rows; here they mean: BQ q rows per thread block, BKM
//             kv rows staged in shared memory per stage (the TPU's
//             block_kv_major), BKV kv rows per online-softmax step (the
//             TPU's block_kv, which fixes where P is rounded).
//
// Computes, per (batch, head, BQ-row q tile), the TPU kernel's arithmetic:
// q' = bf16(q * scale) (the wrapper rounds the scale to bf16, as JAX
// multiplies a bf16 q by a weakly typed scalar); for each kv stage up to
// the one holding the tile's last row (the TPU's clamped kv index), for
// each BKV-row step: s = q' k^T in f32; masked scores MASK_VALUE; m_next =
// max(m, rowmax s); alpha = exp(m - m_next); p = exp(s - m_next); l = l
// alpha + sum p; acc = acc alpha + bf16(p) v in f32. Then o = bf16(acc *
// (1 / l)) with l = 0 taken as 1. No lse.
//
// What bounds it on this card: operations. At the sweep's shape (b 1, h 32,
// s 2048, d 128, causal) it does 34.4 GFLOP on 16.8 MB of q/k/v/o, some
// 2000 FLOPs a byte against the ~295 ridge: the bound is the tensor cores'
// 989 TFLOP/s (0.035 ms). This first kernel is deliberately simple: bf16
// tiles in shared memory (exact, since q' and k/v are bf16 values), f32
// FMAs on the CUDA cores, each thread a (BQ/16) x (BKV/16) tile of S and a
// (BQ/16) x 8 tile of O. It reaches the CUDA-core f32 rate at best; mma /
// wgmma variants are what this harness exists to A/B next.
//
// Layout: q/k/v/o [b, h, s, 128] bf16, contiguous, s a multiple of BQ and
// BKM, BKM a multiple of BKV. Each launch runs on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;  // head width (the sweep's, the only one built)
constexpr int THREADS = 256;
constexpr int HS = D + 8;  // padded bf16 row stride, 16-byte aligned
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

template <int BQ, int BKM, int BKV>
struct Geo {
  static constexpr int SS = BKV + 4;        // score row stride (floats)
  static constexpr int RI = BQ / 16;        // S and O rows a thread
  static constexpr int RJ = BKV / 16;       // S columns a thread
  static constexpr int TPR = THREADS / BQ;  // softmax threads a row
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * (BQ + 2 * BKM) * HS +
      sizeof(float) * (BQ * SS + 3 * BQ);
  static_assert(BKM % BKV == 0 && BKV % 16 == 0 && BQ % 16 == 0 &&
                    (TPR == 2 || TPR == 4),
                "unsupported tile shape");
  static_assert(smem_bytes <= 232448, "over the card's 227 KB a block");
};

// Four bf16 values of shared memory (8-byte aligned) as floats.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <bool EXP2>
__device__ __forceinline__ float ex(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

template <bool MASK_ALL, bool EXP2, int BQ, int BKM, int BKV>
__global__ void __launch_bounds__(THREADS)
variant_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int heads, int seq,
                   float scale) {
  using G = Geo<BQ, BKM, BKV>;
  constexpr int SS = G::SS, RI = G::RI, RJ = G::RJ, TPR = G::TPR;
  constexpr int CPT = BKV / TPR;  // softmax columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][HS]
  __nv_bfloat16* Ks = Qs + BQ * HS;   // [BKM][HS]
  __nv_bfloat16* Vs = Ks + BKM * HS;  // [BKM][HS]
  float* Ss = reinterpret_cast<float*>(Vs + BKM * HS);  // [BQ][SS]
  float* row_m = Ss + BQ * SS;
  float* row_l = row_m + BQ;
  float* row_alpha = row_l + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * BQ;
  const long long base = ((long long)b * heads + h) * (long long)seq * D;
  const __nv_bfloat16* qh = q + base;
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const float x = __bfloat162float(qh[(long long)(q0 + r) * D + c]);
    Qs[r * HS + c] = __float2bfloat16_rn(x * scale);
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[RI][D / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  // kv stages up to the one holding the tile's last row (the TPU's kv
  // index clamp; stages past it never run).
  const int last_stage = (q0 + BQ - 1) / BKM;
  for (int st = 0; st <= last_stage; ++st) {
    const int kv0 = st * BKM;
    // "diag": only a stage that reaches past the tile's first row masks.
    const bool masked = MASK_ALL || q0 < kv0 + BKM;
    __syncthreads();  // earlier readers of Ks/Vs/Ss are done
    for (int idx = tid; idx < BKM * (D / 8); idx += THREADS) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const long long at = (long long)(kv0 + r) * D + c;
      *reinterpret_cast<uint4*>(&Ks[r * HS + c]) =
          *reinterpret_cast<const uint4*>(&kh[at]);
      *reinterpret_cast<uint4*>(&Vs[r * HS + c]) =
          *reinterpret_cast<const uint4*>(&vh[at]);
    }
    __syncthreads();

    for (int t0 = 0; t0 < BKM; t0 += BKV) {
      // S = Q K^T: thread rows ty*RI+i, columns tx+16*j of this step.
      float s[RI][RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
      for (int kk = 0; kk < D; kk += 4) {
        float4 qv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) qv[i] = load4(&Qs[(ty * RI + i) * HS + kk]);
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const float4 kv = load4(&Ks[(t0 + tx + 16 * j) * HS + kk]);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
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
      for (int i = 0; i < RI; ++i) {
        const int r = ty * RI + i;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int c = tx + 16 * j;
          float x = s[i][j];
          if (masked && kv0 + t0 + c > q0 + r) x = MASK_VALUE;
          Ss[r * SS + c] = x;
        }
      }
      __syncthreads();

      // Online softmax: TPR threads a row, CPT columns each.
      {
        const int r = tid / TPR, part = tid % TPR;
        float mc = -INFINITY;
        for (int c = part * CPT; c < part * CPT + CPT; ++c)
          mc = fmaxf(mc, Ss[r * SS + c]);
#pragma unroll
        for (int o2 = 1; o2 < TPR; o2 <<= 1)
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o2));
        const float m_prev = row_m[r];
        const float m_next = fmaxf(m_prev, mc);
        const float alpha = ex<EXP2>(m_prev - m_next);
        float lsum = 0.f;
        for (int c = part * CPT; c < part * CPT + CPT; ++c) {
          const float pp = ex<EXP2>(Ss[r * SS + c] - m_next);
          lsum += pp;
          Ss[r * SS + c] = __bfloat162float(__float2bfloat16_rn(pp));
        }
#pragma unroll
        for (int o2 = 1; o2 < TPR; o2 <<= 1)
          lsum += __shfl_xor_sync(0xffffffffu, lsum, o2);
        __syncwarp();
        if (part == 0) {
          row_l[r] = row_l[r] * alpha + lsum;
          row_m[r] = m_next;
          row_alpha[r] = alpha;
        }
      }
      __syncthreads();

      // O = O * alpha + P V: thread rows ty*RI+i, columns tx+16*j.
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float a = row_alpha[ty * RI + i];
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] *= a;
      }
      for (int t = 0; t < BKV; t += 4) {
        float4 pv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          pv[i] = *reinterpret_cast<const float4*>(&Ss[(ty * RI + i) * SS + t]);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          const int c = tx + 16 * j;
          const __nv_bfloat16* vc = &Vs[(t0 + t) * HS + c];
          const float v0 = __bfloat162float(vc[0]);
          const float v1 = __bfloat162float(vc[HS]);
          const float v2 = __bfloat162float(vc[2 * HS]);
          const float v3 = __bfloat162float(vc[3 * HS]);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            float a = acc[i][j];
            a = fmaf(pv[i].x, v0, a);
            a = fmaf(pv[i].y, v1, a);
            a = fmaf(pv[i].z, v2, a);
            a = fmaf(pv[i].w, v3, a);
            acc[i][j] = a;
          }
        }
      }
      __syncthreads();  // readers of Ss are done before the next step
    }
  }

  // Deferred normalisation: acc * (1 / l), l = 0 taken as 1.
  __nv_bfloat16* oh = o + base;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty * RI + i;
    const float l = row_l[r];
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      oh[(long long)(q0 + r) * D + tx + 16 * j] =
          __float2bfloat16_rn(acc[i][j] * l_inv);
  }
}

template <bool MASK_ALL, bool EXP2, int BQ, int BKM, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int seq, float scale, cudaStream_t stream) {
  constexpr size_t smem = Geo<BQ, BKM, BKV>::smem_bytes;
  cudaFuncSetAttribute(variant_fwd_kernel<MASK_ALL, EXP2, BQ, BKM, BKV>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(seq / BQ, heads, batch);
  variant_fwd_kernel<MASK_ALL, EXP2, BQ, BKM, BKV>
      <<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      heads, seq, scale);
  return (int)cudaGetLastError();
}

template <int BQ, int BKM, int BKV>
int launch_flags(bool mask_all, bool exp2, const void* q, const void* k,
                 const void* v, void* o, int batch, int heads, int seq,
                 float scale, cudaStream_t s) {
  if (mask_all) {
    return exp2 ? launch<true, true, BQ, BKM, BKV>(q, k, v, o, batch, heads,
                                                   seq, scale, s)
                : launch<true, false, BQ, BKM, BKV>(q, k, v, o, batch,
                                                    heads, seq, scale, s);
  }
  return exp2 ? launch<false, true, BQ, BKM, BKV>(q, k, v, o, batch, heads,
                                                  seq, scale, s)
              : launch<false, false, BQ, BKM, BKV>(q, k, v, o, batch, heads,
                                                   seq, scale, s);
}

}  // namespace

// The built tile shapes (block_q, block_kv_major, block_kv), as
// ops/flash/variant.py::KERNEL_TILES lists them.
#define VARIANT_TILES(X) \
  X(64, 128, 64)         \
  X(64, 128, 128)        \
  X(128, 128, 64)        \
  X(128, 128, 128)       \
  X(64, 64, 64)

// q/k/v/o bf16 [batch, heads, seq, head_dim]; mask_mode 1 = "always", 0 =
// "diag"; use_exp2 0/1; scale already rounded to bf16 (and holding log2 e
// under exp2). Returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a head_dim, tile shape or sequence length
// this build does not serve.
extern "C" int variant_fwd(const void* q, const void* k, const void* v,
                           void* o, int batch, int heads, int seq,
                           int head_dim, float scale, int block_q,
                           int block_kv_major, int block_kv, int mask_mode,
                           int use_exp2, void* stream) {
  if (head_dim != D || seq <= 0 || seq % block_q != 0 ||
      seq % block_kv_major != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VARIANT_CASE(BQ, BKM, BKV)                                         \
  if (block_q == BQ && block_kv_major == BKM && block_kv == BKV)          \
    return launch_flags<BQ, BKM, BKV>(mask_mode != 0, use_exp2 != 0, q, k, \
                                      v, o, batch, heads, seq, scale, s);
  VARIANT_TILES(VARIANT_CASE)
#undef VARIANT_CASE
  return (int)cudaErrorInvalidValue;
}
