// attn_weights: the attention probabilities P = exp(s - lse) for Hopper
// (sm_90a), the debug surface of the flash forward.
//
// Replaces the Pallas TPU kernel tpu_flash/ops/flash/debug.py::
// _weights_kernel (:40, launched by attention_weights :96). Given the
// forward's own lse (flash_fwd with lse, sinks folded in), it re-walks the
// score tiles with the forward's arithmetic and writes f32 P:
//   s = round_T(q * sm_scale) k^T in f32; softcap; ALiBi slope * (kv_pos -
//   q_pos); causal (with q_offset) and window masks to MASK_VALUE;
//   P = lse == -inf ? 0 : exp(s - lse), for kv positions < kv_len.
// No state crosses tiles, so each block owns one (q tile, kv tile) of one
// (batch, q head) and its values depend only on the f32 sum of its dot.
//
// What bounds it on this card: bytes. It writes 4 bytes of P per (query,
// key) pair and does 2 d operations for each (at b 1, 32 heads, 2048 x
// 2048, d 128: 537 MB written, 0.16 ms at 3.35 TB/s, against 34 GFLOP).
// Design: Q (64 rows) and K (128 rows) tiles staged in shared memory as
// f32, each thread computing a 4 x 8 score tile with f32 FMAs and writing
// its P straight from registers, 16 threads to 64 contiguous bytes of a
// row. Head widths 64, 128 and 256 (at 256 a block takes (64 + 128) x 260
// x 4 = 199,680 bytes of shared memory, under the 232,448 one block may
// use). Each launch runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 128;   // kv columns per block
constexpr int THREADS = 256;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ + BK) * (D + 4);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct WParams {
  const void* q;      // [b, hq, sq, d]
  const void* k;      // [b, hkv, skv, d]
  const float* lse;   // [b, hq, sq]
  const float* alibi; // [hq] or nullptr
  float* w;           // [b, hq, sq, kv_len]
  int hq, hkv, sq, skv, kv_len;
  float scale;        // sm_scale, already rounded to T by the wrapper
  int causal, q_offset, window;  // window <= 0: none
  float softcap, inv_softcap;    // softcap <= 0: none
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_weights_kernel(WParams p) {
  constexpr int S = D + 4;  // padded row stride (floats)
  extern __shared__ float smem[];
  float* Qs = smem;         // [BQ][S] scaled q
  float* Ks = Qs + BQ * S;  // [BK][S]
  const int n_kt = (p.kv_len + BK - 1) / BK;
  const int qt = blockIdx.x / n_kt, kt = blockIdx.x % n_kt;
  const int bh = blockIdx.y;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x;
  const int q0 = qt * BQ, k0 = kt * BK;
  const T* q = static_cast<const T*>(p.q) + (long long)bh * p.sq * D;
  const T* k = static_cast<const T*>(p.k) +
               ((long long)b * p.hkv + hk) * (long long)p.skv * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (q0 + r < p.sq)
      x = round_to<T>(to_f(q[(long long)(q0 + r) * D + c]) * p.scale);
    Qs[r * S + c] = x;
  }
  for (int idx = tid; idx < BK * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    Ks[r * S + c] = k0 + r < p.kv_len ? to_f(k[(long long)(k0 + r) * D + c])
                                      : 0.f;
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  float s[4][BK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) s[i][j] = 0.f;
  for (int kk = 0; kk < D; kk += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * S + kk]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * S + kk]);
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

  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const int qpos = r + p.q_offset;
    const float lse = p.lse[(long long)bh * p.sq + r];
    float* wrow = p.w + ((long long)bh * p.sq + r) * p.kv_len;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const int kpos = k0 + tx + 16 * j;
      if (kpos >= p.kv_len) continue;
      float x = s[i][j];
      if (p.softcap > 0.f)
        x = __fmul_rn(p.softcap, tanhf(__fmul_rn(x, p.inv_softcap)));
      if (p.alibi != nullptr)
        x = __fadd_rn(x, __fmul_rn(slope, (float)(kpos - qpos)));
      if (p.causal) {
        bool valid = kpos <= qpos;
        if (p.window > 0) valid = valid && kpos > qpos - p.window;
        if (!valid) x = MASK_VALUE;
      }
      wrow[kpos] = lse == -INFINITY ? 0.f : expf(__fsub_rn(x, lse));
    }
  }
}

template <typename T, int D>
int launch(const WParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaFuncSetAttribute(attn_weights_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int n_qt = (p.sq + BQ - 1) / BQ, n_kt = (p.kv_len + BK - 1) / BK;
  dim3 grid(n_qt * n_kt, batch * p.hq);
  attn_weights_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const WParams& p, int head_dim, int batch,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(p, batch, stream);
    case 128:
      return launch<T, 128>(p, batch, stream);
    default:
      return launch<T, 256>(p, batch, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and k share it); head_dim 64, 128
// or 256. Returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for an argument this build does not serve.
extern "C" int attn_weights(const void* q, const void* k, const void* lse,
                            const void* alibi, void* w, int dtype, int batch,
                            int hq, int hkv, int sq, int skv, int kv_len,
                            int head_dim, float scale, int causal,
                            int q_offset, int window, float softcap,
                            float inv_softcap, void* stream) {
  if ((head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (dtype != 0 && dtype != 1) ||
      kv_len <= 0 || kv_len > skv || hq % hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  WParams p;
  p.q = q;
  p.k = k;
  p.lse = static_cast<const float*>(lse);
  p.alibi = static_cast<const float*>(alibi);
  p.w = static_cast<float*>(w);
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.window = window;
  p.softcap = softcap;
  p.inv_softcap = inv_softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_width<float>(p, head_dim, batch, s)
                    : launch_width<__nv_bfloat16>(p, head_dim, batch, s);
}
