// flash_fwd: tiled online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_flash/ops/flash/forward.py:
//   _flash_fwd_kernel (:102, rectangular grid), _flash_fwd_onepass_kernel
//   (:287, short-sequence single pass), _flash_fwd_tri_kernel (:607,
//   triangular causal grid) and _flash_fwd_tri2_kernel (:758, paired-q
//   triangular grid). On the TPU those are four grid geometries of one
//   computation; here one kernel covers them: the TPU's sequential kv grid
//   axis becomes a loop inside the block, and the cells the triangular
//   grid enumerates are exactly the kv tiles this loop visits (tiles above
//   the diagonal or below the sliding window are never loaded).
//
// Computes, per (batch, q head, 64-row q tile):
//   s = (round_T(q * sm_scale)) k^T in f32; softcap; ALiBi; masks
//   (causal with q_offset, sliding window, kv tail, segment ids: a score
//   whose q and kv ids differ, as _seg_mask :44); online softmax with
//   deferred normalisation; P rounded to the input type before P V (the
//   TPU kernel's `p.astype(v.dtype)`); optional per-head sink logits in the
//   denominator; optional lse.
//
// What bounds it on this card: prefill attention is compute-bound (about
// 2 * 64 FLOPs per K/V byte per q tile at d = 128), so the bound is the
// tensor cores' 989 TFLOP/s (bf16). This first kernel is deliberately
// simple: f32 FMAs on the CUDA cores from f32 tiles in shared memory (Q
// 64 x 128, K and V 128 x 128, S 64 x 128; ~199 KB, one block per SM),
// each thread owning a 4 x 8 register tile of S and of O. It reaches the
// CUDA-core f32 rate at best, far below the bound; wgmma, TMA and warp
// specialisation are later work (ROADMAP queue 2).
//
// Head widths: d = 64, 128 and 256, each its own template instance. At d
// 256 the 128-row K and V tiles would not fit beside Q (365 KB against the
// card's 227), and a narrower kv step would round P after another running
// max than the TPU walk's 128 columns. So the step stays 128 kv rows, and
// K and V share one buffer staged 128 columns of d at a time: K's two
// halves feed S in order (the same f32 sum as one pass), then V's halves
// feed the two halves of O (~169 KB).
//
// Layout: q [b, hq, sq, d], k/v [b, hkv, skv, d], o like q, lse f32
// [b, hq, sq]; all contiguous. GQA by index: q head h reads kv head
// h / (hq / hkv). Every kernel launch runs on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 128;   // kv rows per online-softmax step
constexpr int THREADS = 256;
constexpr int SS = BK + 4;  // padded row stride (floats), 16-byte aligned
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

// The geometry of head width D: K/V staged DC columns at a time (all of
// d up to 128; halves at 256, K and V then sharing one buffer).
template <int D>
struct Geo {
  static constexpr int DC = D > 128 ? 128 : D;
  static constexpr int NC = D / DC;  // column chunks a row
  static constexpr bool SHARED_KV = NC > 1;
  static_assert(NC <= 2, "the kernel stages at most two column chunks");
  static constexpr int QS = D + 4;   // padded row strides (floats)
  static constexpr int KS = DC + 4;
  static constexpr size_t smem_bytes =
      sizeof(float) * (BQ * QS + BK * KS + (SHARED_KV ? 0 : BK * D) +
                       BQ * SS + 3 * BQ);
  static_assert(smem_bytes <= 232448, "over the card's 227 KB a block");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Rows [k0, k0 + BK) x columns [c0, c0 + DC) of a K or V matrix into a
// shared tile of row stride DC + 4; rows at or past kv_len load as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_chunk(float* dst, const T* src, int k0,
                                            int c0, int kv_len) {
  constexpr int DC = Geo<D>::DC, KS = Geo<D>::KS;
  for (int idx = threadIdx.x; idx < BK * DC; idx += THREADS) {
    const int r = idx / DC, c = idx % DC;
    dst[r * KS + c] = k0 + r < kv_len
                          ? to_f(src[(long long)(k0 + r) * D + c0 + c])
                          : 0.f;
  }
}

// s += Qs[:, CH DC + (0..DC)] Ks^T for the thread's 4 x 8 cells (rows
// ty*4+i, cols tx+16*j); Ks holds that column chunk of K.
template <int D, int CH>
__device__ __forceinline__ void scores_chunk(const float* Qs, const float* Ks,
                                             float (&s)[4][BK / 16]) {
  constexpr int DC = Geo<D>::DC, QS = Geo<D>::QS, KS = Geo<D>::KS;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int kk = 0; kk < DC; kk += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(
          &Qs[(ty * 4 + i) * QS + CH * DC + kk]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KS + kk]);
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
}

// acc[:, CH DC / 16 + jj] += P V for the thread's rows ty*4+i and columns
// tx + 16 jj of column chunk CH; Vs holds that chunk with row stride VS.
template <int D, int CH, int VS>
__device__ __forceinline__ void pv_chunk(const float* Ss, const float* Vs,
                                         float (&acc)[4][D / 16]) {
  constexpr int DC = Geo<D>::DC;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int t = 0; t < BK; t += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(&Ss[(ty * 4 + i) * SS + t]);
#pragma unroll
    for (int jj = 0; jj < DC / 16; ++jj) {
      const int c = tx + 16 * jj;
      const float v0 = Vs[(t + 0) * VS + c], v1 = Vs[(t + 1) * VS + c];
      const float v2 = Vs[(t + 2) * VS + c], v3 = Vs[(t + 3) * VS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = acc[i][CH * (DC / 16) + jj];
        a = fmaf(pv[i].x, v0, a);
        a = fmaf(pv[i].y, v1, a);
        a = fmaf(pv[i].z, v2, a);
        a = fmaf(pv[i].w, v3, a);
        acc[i][CH * (DC / 16) + jj] = a;
      }
    }
  }
}

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // nullptr: not requested
  const float* sinks;  // [hq] or nullptr
  const float* alibi;  // [hq] or nullptr
  const int* q_seg;    // [b, sq] segment ids or nullptr
  const int* kv_seg;   // [b, skv] (set with q_seg)
  int hq, hkv, sq, skv;
  int kv_len;          // kv positions >= kv_len are masked (padded tail)
  float scale;         // sm_scale, already rounded to T by the wrapper
  int causal, q_offset, window;  // window <= 0: none
  float softcap, inv_softcap;    // softcap <= 0: none
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(FwdParams p) {
  using G = Geo<D>;
  constexpr int QS = G::QS, KS = G::KS, DC = G::DC;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][QS] scaled q
  float* Ks = Qs + BQ * QS;         // [BK][KS] K columns [c DC, (c+1) DC)
  // [BK][D] V, or (shared) [BK][KS] V columns [c DC, (c+1) DC) in Ks.
  float* Vs = G::SHARED_KV ? Ks : Ks + BK * KS;
  float* Ss = Vs + (G::SHARED_KV ? BK * KS : BK * D);  // [BQ][SS] S, then P
  float* row_m = Ss + BQ * SS;      // [BQ] running max
  float* row_l = row_m + BQ;        // [BQ] running sum
  float* row_alpha = row_l + BQ;    // [BQ] rescale of this step

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x;
  const int q0 = qt * BQ;
  const T* q = static_cast<const T*>(p.q) +
               ((long long)b * p.hq + h) * (long long)p.sq * D;
  const T* k = static_cast<const T*>(p.k) +
               ((long long)b * p.hkv + hk) * (long long)p.skv * D;
  const T* v = static_cast<const T*>(p.v) +
               ((long long)b * p.hkv + hk) * (long long)p.skv * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (q0 + r < p.sq) {
      x = round_to<T>(to_f(q[(long long)(q0 + r) * D + c]) * p.scale);
    }
    Qs[r * QS + c] = x;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // kv tiles this q tile attends: the triangular grid's active cells.
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + p.q_offset;
  int first_tile = 0;
  int last_tile = (p.kv_len + BK - 1) / BK - 1;
  if (p.causal) {
    last_tile = min(last_tile, q_last / BK);
    if (p.window > 0) {
      const int lo = q_first - p.window + 1;
      first_tile = lo > 0 ? lo / BK : 0;
    }
  }

  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // cols tx + 16*j
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;

  for (int tile = first_tile; tile <= last_tile; ++tile) {
    const int k0 = tile * BK;

    // S = Qs Ks^T: each thread a 4 x 8 tile (rows ty*4+i, cols tx+16*j).
    float s[4][BK / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) s[i][j] = 0.f;
    if constexpr (!G::SHARED_KV) {
      __syncthreads();  // previous step's readers of Ks/Vs/Ss are done
      for (int idx = tid; idx < BK * D; idx += THREADS) {
        const int r = idx / D, c = idx % D;
        float kx = 0.f, vx = 0.f;
        if (k0 + r < p.kv_len) {
          kx = to_f(k[(long long)(k0 + r) * D + c]);
          vx = to_f(v[(long long)(k0 + r) * D + c]);
        }
        Ks[r * KS + c] = kx;
        Vs[r * D + c] = vx;
      }
      __syncthreads();
      scores_chunk<D, 0>(Qs, Ks, s);
    } else {
      // K's column halves in order: the same f32 sum over d as one pass.
      __syncthreads();
      stage_chunk<T, D>(Ks, k, k0, 0, p.kv_len);
      __syncthreads();
      scores_chunk<D, 0>(Qs, Ks, s);
      __syncthreads();
      stage_chunk<T, D>(Ks, k, k0, DC, p.kv_len);
      __syncthreads();
      scores_chunk<D, 1>(Qs, Ks, s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r + p.q_offset;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_softcap);
        bool valid = kpos < p.kv_len;
        if (p.causal) {
          valid = valid && kpos <= qpos;
          if (p.window > 0) valid = valid && kpos > qpos - p.window;
          if (p.alibi != nullptr) x += slope * (float)(kpos - qpos);
        }
        if (valid && p.q_seg != nullptr && q0 + r < p.sq) {
          valid = p.q_seg[(long long)b * p.sq + q0 + r] ==
                  p.kv_seg[(long long)b * p.skv + kpos];
        }
        Ss[r * SS + c] = valid ? x : MASK_VALUE;
      }
    }
    __syncthreads();

    // Online softmax: 4 threads per row, 32 columns each.
    {
      const int r = tid / 4, part = tid % 4;
      float mc = -INFINITY;
      for (int c = part * 32; c < part * 32 + 32; ++c)
        mc = fmaxf(mc, Ss[r * SS + c]);
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_prev = row_m[r];
      const float m_next = fmaxf(m_prev, mc);
      const float alpha = expf(m_prev - m_next);
      float lsum = 0.f;
      for (int c = part * 32; c < part * 32 + 32; ++c) {
        const float pp = expf(Ss[r * SS + c] - m_next);
        lsum += pp;
        Ss[r * SS + c] = round_to<T>(pp);
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      __syncwarp();
      if (part == 0) {
        row_l[r] = row_l[r] * alpha + lsum;
        row_m[r] = m_next;
        row_alpha[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V: each thread rows ty*4+i, cols tx+16*j; with a
    // shared K/V buffer, V is staged here, one column chunk at a time.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= a;
    }
    if constexpr (!G::SHARED_KV) {
      pv_chunk<D, 0, D>(Ss, Vs, acc);
    } else {
      // V's column halves into the matching halves of O (the barrier
      // after the softmax has seen every reader of K's second half).
      stage_chunk<T, D>(Vs, v, k0, 0, p.kv_len);
      __syncthreads();
      pv_chunk<D, 0, KS>(Ss, Vs, acc);
      __syncthreads();
      stage_chunk<T, D>(Vs, v, k0, DC, p.kv_len);
      __syncthreads();
      pv_chunk<D, 1, KS>(Ss, Vs, acc);
    }
  }
  __syncthreads();

  // Deferred normalisation (with the sink logit folded in once).
  T* o = static_cast<T*>(p.o) + ((long long)b * p.hq + h) * (long long)p.sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= p.sq) continue;
    const float m = row_m[r], l = row_l[r];
    float mult, lse;
    if (p.sinks != nullptr) {
      const float sk = p.sinks[h];
      const float m2 = fmaxf(m, sk);
      const float scale_m = expf(m - m2);
      const float l_tot = l * scale_m + expf(sk - m2);
      mult = scale_m / l_tot;
      lse = m2 + logf(l_tot);
    } else {
      mult = (l == 0.f) ? 1.f : 1.f / l;
      lse = (m == -INFINITY) ? -INFINITY : m + logf(l);
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[(long long)(q0 + r) * D + tx + 16 * j] = from_f<T>(acc[i][j] * mult);
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.hq + h) * p.sq + q0 + r] = lse;
  }
}

template <typename T, int D>
int launch(const FwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::smem_bytes;
  cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const FwdParams& p, int head_dim, int batch,
                 cudaStream_t stream) {
  if (head_dim == 64) return launch<T, 64>(p, batch, stream);
  if (head_dim == 256) return launch<T, 256>(p, batch, stream);
  return launch<T, 128>(p, batch, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// head_dim: 64, 128 or 256. Returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a dtype or head_dim this build does not
// serve.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* sinks,
                         const void* alibi, const void* q_seg,
                         const void* kv_seg, int dtype, int batch, int hq,
                         int hkv, int sq, int skv, int kv_len, int head_dim,
                         float scale, int causal, int q_offset, int window,
                         float softcap, float inv_softcap, void* stream) {
  if ((head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sinks = static_cast<const float*>(sinks);
  p.alibi = static_cast<const float*>(alibi);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
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
