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
// Computes, per (batch, q head, q tile):
//   s = (round_T(q * sm_scale)) k^T in f32; softcap; ALiBi; masks
//   (causal with q_offset, sliding window, kv tail, segment ids: a score
//   whose q and kv ids differ, as _seg_mask :44); online softmax over BK =
//   128 kv columns a step (TileSizes.block_kv: the step fixes which
//   running max each P element is rounded after, as the TPU walk and the
//   plain version round it) with deferred normalisation; P rounded to the
//   input type before P V (the TPU kernel's `p.astype(v.dtype)`); optional
//   per-head sink logits in the denominator; optional lse.
//
// What bounds it on this card: prefill attention is compute-bound (about
// 2 * BQ FLOPs per K/V byte per q tile), so the bound is the tensor cores'
// 989 TFLOP/s (bf16).
//
// bf16 (flash_fwd: training, and every call but the serving engine's):
// the tensor-core body of fwd_tile.cuh (mma.sync m16n8k16, ldmatrix
// fragments, K and V bf16 in shared memory by cp.async with the next
// stage in flight; S, the softmax and P in registers), the body the
// variant harness (variant_fwd.cu) times. A block stages 128 kv rows,
// one softmax step, at a time and owns 64 q rows (4 warps of 16), the
// harness's fastest q-tile height: Q, K and V tiles of D + 8-element rows
// take 85 KB at d 128 (two blocks an SM) and 45 KB at d 64. At d 256 it
// owns 128 q rows (8 warps, 198 KB): a 64-row block would hold 165 KB for
// 4 warps, one block an SM. The exponential is the harness's winner,
// exp2f: scores leave the score transform times log2 e (after softcap and
// ALiBi), since folding log2 e into q's scale, as the harness does, would
// round q' otherwise than the TPU kernel. tools/torch_fwd_sweep.py times
// these choices against the others. The heaviest causal q tiles launch
// first. A step wholly inside the live region for a warp's rows, with no
// segment ids and no softcap or ALiBi, takes its scores as they are; one
// with no segment ids skips the compares; a step wholly above its
// diagonal, below its window or past sq is not computed.
//
// The CUDA-core kernel: the first one, kept for f32 inputs (TF32
// products would miss their 2^-12 bar) and, in both dtypes, behind a
// second entry point, flash_fwd_exact, which the serving engine takes. It
// sums S over d and P V over the kv rows one FMA at a time in index
// order, the order of the plain version's f32 products on the card, so
// its outputs rarely leave the plain version's by a bit (on the trained
// checkpoint's serving runs, never); the tensor cores sum inside each mma
// in an order of their own, and that checkpoint's greedy tokens sit on
// one-ulp logit margins that notice (PERF.md, Findings). f32 FMAs from
// f32 tiles in shared memory (Q 64 x d, K and V 128 x d, S 64 x 128;
// ~199 KB at d 128, one block per SM), each thread owning a 4 x 8
// register tile of S and of O. At d 256 the 128-row K and V tiles would
// not fit beside Q (365 KB against the card's 227), so K and V share one
// buffer staged 128 columns of d at a time: K's two halves feed S in
// order (the same f32 sum as one pass), then V's halves feed the two
// halves of O (~169 KB).
//
// Layout: q [b, hq, sq, d], k/v [b, hkv, skv, d], o like q, lse f32
// [b, hq, sq]; all contiguous (bf16 rows 16-byte aligned). GQA by index:
// q head h reads kv head h / (hq / hkv). Every kernel launch runs on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwd_tile.cuh"

namespace {

constexpr int BK = 128;  // kv rows per online-softmax step
constexpr float MASK_VALUE = tc::FWD_MASK_VALUE;

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

// The kv tiles of BK rows a q tile [q0, q0 + bq) attends: the triangular
// grid's active cells. Returns (first, last) in first/last.
__device__ __forceinline__ void kv_tiles(const FwdParams& p, int q0, int bq,
                                         int& first, int& last) {
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + bq, p.sq) - 1 + p.q_offset;
  first = 0;
  last = (p.kv_len + BK - 1) / BK - 1;
  if (p.causal) {
    last = min(last, q_last / BK);
    if (p.window > 0) {
      const int lo = q_first - p.window + 1;
      first = lo > 0 ? lo / BK : 0;
    }
  }
}

// The final scale of a row's O and its lse, from its running max m and sum
// l (with the sink logit folded in once).
__device__ __forceinline__ void finish_row(const FwdParams& p, int h, float m,
                                           float l, float& mult,
                                           float& lse) {
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
}

// ---------------------------------------------------------------------------
// The CUDA-core kernel: f32, and the order-exact bf16 entry.

constexpr int BQ = 64;    // q rows per block
constexpr int THREADS = 256;
constexpr int SS = BK + 4;  // padded row stride (floats), 16-byte aligned

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

  int first_tile, last_tile;
  kv_tiles(p, q0, BQ, first_tile, last_tile);

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
    float mult, lse;
    finish_row(p, h, row_m[r], row_l[r], mult, lse);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[(long long)(q0 + r) * D + tx + 16 * j] = from_f<T>(acc[i][j] * mult);
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.hq + h) * p.sq + q0 + r] = lse;
  }
}

template <typename T, int D>
int launch_cuda_cores(const FwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::smem_bytes;
  cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cuda_cores(const FwdParams& p, int head_dim, int batch,
                      cudaStream_t s) {
  if (head_dim == 64) return launch_cuda_cores<T, 64>(p, batch, s);
  if (head_dim == 256) return launch_cuda_cores<T, 256>(p, batch, s);
  return launch_cuda_cores<T, 128>(p, batch, s);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (fwd_tile.cuh's body).

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The tiles and exponential this build serves at each head width (see the
// note at the top; tools/torch_fwd_sweep.py times others): 64 q rows (128
// at d 256), one 128-row softmax step staged at a time; exp2.
template <int D>
using TcTiles = tc::FwdTiles<D, D == 256 ? 128 : 64, BK, BK>;
constexpr bool TC_EXP2 = true;

// Softcap, ALiBi and the masks for one warp's 16 q rows from wq0. Under
// EXP2 a live score leaves in log2 units (times log2 e, after softcap and
// ALiBi: the rounded q' stays the TPU's), for exp2f. PLAIN: whether the
// build has the option-free path (plain()) at all.
template <bool EXP2, bool PLAIN>
struct FlashScore {
  const FwdParams& p;
  int b, wq0;
  float slope;
  bool no_options;  // no softcap, no ALiBi
  // The warp's positions: its first and last q row that exist.
  __device__ int qlo() const { return wq0 + p.q_offset; }
  __device__ int qhi() const { return min(wq0 + 15, p.sq - 1) + p.q_offset; }
  // No row of the warp sees the step: past sq, above the diagonal, or
  // below the window.
  __device__ bool skip(int k0) const {
    if (wq0 >= p.sq) return true;
    if (!p.causal) return false;
    return k0 > qhi() || (p.window > 0 && k0 + BK - 1 <= qlo() - p.window);
  }
  // The step needs the compares: segment ids, the kv tail, or the
  // diagonal or the window's edge crossing it.
  __device__ bool masked(int k0) const {
    if (p.q_seg != nullptr || k0 + BK > p.kv_len) return true;
    if (!p.causal) return false;
    return k0 + BK - 1 > qlo() || (p.window > 0 && k0 <= qhi() - p.window);
  }
  __device__ bool plain() const { return PLAIN && no_options; }
  __device__ float unit(float x) const { return EXP2 ? x * LOG2E : x; }
  __device__ float operator()(float x, int row, int kpos, bool masked) const {
    if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_softcap);
    const int qpos = row + p.q_offset;
    if (p.causal && p.alibi != nullptr) x += slope * (float)(kpos - qpos);
    x = unit(x);
    if (!masked) return x;
    bool valid = kpos < p.kv_len;
    if (p.causal) {
      valid = valid && kpos <= qpos;
      if (p.window > 0) valid = valid && kpos > qpos - p.window;
    }
    if (valid && p.q_seg != nullptr && row < p.sq) {
      valid = p.q_seg[(long long)b * p.sq + row] ==
              p.kv_seg[(long long)b * p.skv + kpos];
    }
    return valid ? x : MASK_VALUE;
  }
};

template <class G, bool EXP2, bool PLAIN>
__global__ void __launch_bounds__(G::THREADS)
    flash_fwd_tc_kernel(const __grid_constant__ FwdParams p) {
  constexpr int D = G::D;
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // The heaviest (last) causal q tiles first, so the last wave is the
  // lightest.
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * G::BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qbase = ((long long)b * p.hq + h) * (long long)p.sq * D;
  const long long kvbase = ((long long)b * p.hkv + hk) * (long long)p.skv * D;
  int first, last;
  kv_tiles(p, q0, G::BQ, first, last);
  const FlashScore<EXP2, PLAIN> score{
      p, b, q0 + warp * 16, p.alibi != nullptr ? p.alibi[h] : 0.f,
      !(p.softcap > 0.f) && !(p.causal && p.alibi != nullptr)};
  tc::FwdRows<D> r;
  tc::fwd_block<G, EXP2>(static_cast<const bf16*>(p.q) + qbase,
                         static_cast<const bf16*>(p.k) + kvbase,
                         static_cast<const bf16*>(p.v) + kvbase, q0, p.sq,
                         p.kv_len, p.scale, first, last, score, r, tc_smem);

  // Deferred normalisation (with the sink logit folded in once).
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= p.sq) continue;
    float mult, lse;
    finish_row(p, h, EXP2 ? r.m[half] * LN2 : r.m[half], r.l[half], mult,
               lse);
    tc::fwd_store_row<D>(static_cast<bf16*>(p.o) + qbase + (long long)row * D,
                         r, half, mult);
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[((long long)b * p.hq + h) * p.sq + row] = lse;
  }
}

template <class G, bool EXP2, bool PLAIN = true>
int launch_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  cudaFuncSetAttribute(flash_fwd_tc_kernel<G, EXP2, PLAIN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.sq + G::BQ - 1) / G::BQ, p.hq, batch);
  flash_fwd_tc_kernel<G, EXP2, PLAIN>
      <<<grid, G::THREADS, G::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

FwdParams make_params(const void* q, const void* k, const void* v, void* o,
                      void* lse, const void* sinks, const void* alibi,
                      const void* q_seg, const void* kv_seg, int hq, int hkv,
                      int sq, int skv, int kv_len, float scale, int causal,
                      int q_offset, int window, float softcap,
                      float inv_softcap) {
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
  return p;
}

}  // namespace

#define FLASH_FWD_ARGS                                                      \
  const void *q, const void *k, const void *v, void *o, void *lse,         \
      const void *sinks, const void *alibi, const void *q_seg,              \
      const void *kv_seg, int dtype, int batch, int hq, int hkv, int sq,    \
      int skv, int kv_len, int head_dim, float scale, int causal,           \
      int q_offset, int window, float softcap, float inv_softcap,           \
      void *stream
#define FLASH_FWD_PARAMS                                                    \
  make_params(q, k, v, o, lse, sinks, alibi, q_seg, kv_seg, hq, hkv, sq,    \
              skv, kv_len, scale, causal, q_offset, window, softcap,        \
              inv_softcap)

bool served(int dtype, int head_dim) {
  return (dtype == 0 || dtype == 1) &&
         (head_dim == 64 || head_dim == 128 || head_dim == 256);
}

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel); q, k, v and o share it. head_dim: 64, 128 or 256.
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a dtype or head_dim this build does not serve.
extern "C" int flash_fwd(FLASH_FWD_ARGS) {
  if (!served(dtype, head_dim)) return (int)cudaErrorInvalidValue;
  const FwdParams p = FLASH_FWD_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cuda_cores<float>(p, head_dim, batch, s);
  if (head_dim == 64) return launch_bf16<TcTiles<64>, TC_EXP2>(p, batch, s);
  if (head_dim == 256)
    return launch_bf16<TcTiles<256>, TC_EXP2>(p, batch, s);
  return launch_bf16<TcTiles<128>, TC_EXP2>(p, batch, s);
}

// The order-exact forward: the CUDA-core kernel for both dtypes, whose
// S and P V sums run in sequence over d and over the kv rows, the order
// of the plain version's f32 products on the card (see the note at the
// top). Same arguments and returns as flash_fwd.
extern "C" int flash_fwd_exact(FLASH_FWD_ARGS) {
  if (!served(dtype, head_dim)) return (int)cudaErrorInvalidValue;
  const FwdParams p = FLASH_FWD_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_cuda_cores<float>(p, head_dim, batch, s)
                    : launch_cuda_cores<__nv_bfloat16>(p, head_dim, batch, s);
}
