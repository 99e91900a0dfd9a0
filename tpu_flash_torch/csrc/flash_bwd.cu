// flash_bwd: FlashAttention-2 backward for Hopper (sm_90a), two kernels.
//
// Replaces the Pallas TPU kernels of tpu_flash/ops/flash/backward.py:
//   _flash_bwd_dkv_kernel (:102) and _flash_bwd_dq_kernel (:211), K8, on
//   their rectangular and triangular grids, and the single-pass pair
//   _bwd_dq_onepass_kernel (:315) / _bwd_dkv_onepass_kernel (:365), K9,
//   which is a TPU geometry of the same two computations. On the TPU each
//   kernel carries its sum across a sequential grid axis in VMEM scratch;
//   here that axis is a loop inside the block, and the tiles the loop
//   visits are the triangular grid's active cells (_build_dkv_cells :528
//   for dK/dV, the forward's cell list for dQ): causal tiles above the
//   diagonal, tiles outside a sliding window and the kv tail are never
//   loaded.
//
//   flash_bwd_dkv: one block per (kv tile, q head, batch). The K/V tile
//     stays in shared memory; the block loops over the q tiles that can
//     see it and sums dV += P^T dO and dK += round(dS)^T Q in registers.
//     dK/dV are written per q head ([b, hq, skv, d]); the caller sums each
//     GQA group.
//   flash_bwd_dq: one block per (q tile, q head, batch), looping over its
//     live kv tiles: dQ += round(dS) K.
//
// Both recompute, per (q tile, kv tile):
//   s = q k^T (f32, from the inputs' values) * sm_scale; softcap
//   c tanh(s / c) with dcap = 1 - tanh^2; ALiBi; p = exp(s - lse), 0 where
//   masked (causal with q_offset, window, kv tail, segment ids);
//   dp = dO V^T; dS = p (dp - di) dcap sm_scale, with di = rowsum(o dO) -
//   dlse precomputed by the wrapper; dS rounded to the input type before
//   it meets Q or K (the TPU kernel's `ds.astype(q.dtype)`).
// Each block owns its outputs: no atomics, so the gradients are
// deterministic.
//
// What bounds it on this card: the backward does 3.5x the forward's
// matrix work (S and dP recomputed, dV, dK in one kernel; S, dP and dQ in
// the other: 14 d FLOPs per live (q, kv) pair against the forward's 4 d),
// so at training lengths it is bound by operations, on the tensor cores'
// 989 TFLOP/s (bf16): at b 4 x 2048, 32 q heads of 128, its bytes (each
// input read once, each output written once) take an eighth of that.
//
// bf16 (the training path): tensor-core kernels (namespace tc). Operands
// stay bf16 in shared memory, streamed by cp.async with the next tile in
// flight; all seven products are mma.sync m16n8k16 (bf16 in, f32 sums)
// with ldmatrix fragments. The dK/dV kernel computes S^T = K Q^T and
// dP^T = V dO^T kv-major, so P^T and dS^T come out in the accumulator
// layout, which is the A operand's: they are rounded to bf16 in registers
// and go straight into dV += P^T dO and dK += dS^T Q. The dQ kernel does
// the same with dS into dQ += dS K. Mask arithmetic runs only on steps that
// cross the diagonal, the window's edge, a tail or segment ids.
// One rounding is new against the CUDA-core kernels: P is bf16 in the dV
// product. It is the TPU kernel's own: at bf16 inputs its dV dot runs at
// Precision.DEFAULT, one bf16 pass of the MXU (backward.py:38-43,
// :184-188). flash_bwd_plain(round_p=True) is its plain version.
// Tiles (Tiles<D>, the fastest of a sweep of shapes): dK/dV owns 64 kv
// rows at d 64 and 128 (a warp 16) and steps 32 q rows (4 warps, 70 KB of
// shared memory at d 128); at d 256 it owns 32 kv rows and two warps share
// each 16, each summing half of their dK/dV columns and recomputing their
// S and dP (4 warps, 101 KB), so the sums stay in registers. dQ owns 64 q
// rows and steps 32 kv rows (16 at d 256; 70 and 101 KB). Registers (127-
// 242 a thread), not shared memory, cap the card at 8-12 warps an SM.
// tools/torch_bwd_sweep.py times other shapes against these.
//
// f32: the first, CUDA-core kernels, kept for f32 inputs (TF32 products
// would miss their 2^-12 bar): f32 FMAs from f32 tiles in shared memory
// (each thread a 4 x 4 tile of S and dP and a 4 x 8 tile of each
// accumulator; ~167 KB of shared memory in dK/dV, ~150 KB in dQ at d 128,
// one block per SM). At d 256 a 64 x 64 step's four f32 tiles of
// 260-float rows would need 301 KB (dK/dV) and 284 KB (dQ), over the
// card's 227: dK/dV then steps 32 q rows against its 64 kv rows (217 KB)
// and dQ 32 kv rows against its 64 q rows (209 KB). The backward rounds
// nothing across a step (P comes from the forward's lse), so the tiles
// change only the f32 summation order.
//
// Later work (ROADMAP item 17): wgmma with TMA and warp specialisation,
// summing each GQA group inside the kernel (per-q-head dK/dV cost hq/hkv
// times their bytes), tensor cores for f32.
//
// Layout: q/o/dO [b, hq, sq, d], k/v [b, hkv, skv, d], lse/di f32
// [b, hq, sq], dQ like q, dK/dV [b, hq, skv, d]; all contiguous, bf16
// rows 16-byte aligned. GQA by index: q head h reads kv head
// h / (hq / hkv). Each launch runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads over each score tile

// The tiles of head width D: the dK/dV block owns 64 kv rows and steps
// DKV_BQ q rows; the dQ block owns 64 q rows and steps DQ_BKV kv rows.
template <int D>
struct Geo {
  static constexpr int DKV_BQ = D > 128 ? 32 : 64;
  static constexpr int DQ_BKV = D > 128 ? 32 : 64;
  static constexpr int DS = D + 4;  // padded row stride (floats), 16-byte
                                    // aligned
  // dK/dV: K, V, Q, dO tiles, P and dS tiles, lse and di of the q tile.
  static constexpr size_t dkv_smem =
      sizeof(float) * (2 * 64 * DS + 2 * DKV_BQ * DS +
                       2 * DKV_BQ * (64 + 4) + 2 * DKV_BQ);
  // dQ: Q, dO, K, V tiles, the dS tile, lse and di.
  static constexpr size_t dq_smem =
      sizeof(float) * (2 * 64 * DS + 2 * DQ_BKV * DS + 64 * (DQ_BKV + 4) +
                       2 * 64);
  static_assert(dkv_smem <= 232448 && dq_smem <= 232448,
                "over the card's 227 KB a block");
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [b, hq, sq]
  const float* di;     // [b, hq, sq]: rowsum(o dO) - dlse
  void* out1;          // dK (dkv kernel) or dQ (dq kernel)
  void* out2;          // dV (dkv kernel)
  const float* alibi;  // [hq] or nullptr
  const int* q_seg;    // [b, sq] or nullptr
  const int* kv_seg;   // [b, skv]
  int hq, hkv, sq, skv;
  int kv_len;          // kv positions >= kv_len are masked
  float scale;         // sm_scale as an f32 number
  int causal, q_offset, window;  // window <= 0: none
  float softcap, inv_softcap;    // softcap <= 0: none
};

// Rows [r0, r0 + R) of a [rows, D] matrix into an f32 shared tile with
// row stride D + 4; rows at or past `rows` load as zeros.
template <int D, int R, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows) {
  constexpr int DS = Geo<D>::DS;
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * DS + c] =
        r0 + r < rows ? to_f(src[(long long)(r0 + r) * D + c]) : 0.f;
  }
}

// S = Qs Ks^T and dP = dOs Vs^T over an RQ x RK tile, the thread's cells
// at q rows ty*(RQ/16)+i and kv cols tx+16*j, then P and dS in place:
// s[i][j] becomes p, dp[i][j] becomes the unrounded dS.
template <int D, int RQ, int RK>
__device__ __forceinline__ void scores_and_ds(
    const BwdParams& p, int b, int h, int q0, int k0, const float* Qs,
    const float* Ks, const float* dOs, const float* Vs, const float* lse_s,
    const float* di_s, float (&s)[RQ / 16][RK / 16],
    float (&dp)[RQ / 16][RK / 16]) {
  constexpr int DS = Geo<D>::DS, RI = RQ / 16, RJ = RK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int kk = 0; kk < D; kk += 4) {
    float4 qv[RI], dv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RI + i) * DS + kk]);
      dv[i] =
          *reinterpret_cast<const float4*>(&dOs[(ty * RI + i) * DS + kk]);
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * DS + kk]);
      const float4 vv =
          *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * DS + kk]);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv.x, a);
        a = fmaf(qv[i].y, kv.y, a);
        a = fmaf(qv[i].z, kv.z, a);
        a = fmaf(qv[i].w, kv.w, a);
        s[i][j] = a;
        float c = dp[i][j];
        c = fmaf(dv[i].x, vv.x, c);
        c = fmaf(dv[i].y, vv.y, c);
        c = fmaf(dv[i].z, vv.z, c);
        c = fmaf(dv[i].w, vv.w, c);
        dp[i][j] = c;
      }
    }
  }
  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty * RI + i;
    const int qi = q0 + r;
    const int qpos = qi + p.q_offset;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int kpos = k0 + tx + 16 * j;
      float x = s[i][j] * p.scale;
      float dcap = 1.f;
      if (p.softcap > 0.f) {
        const float t = tanhf(x * p.inv_softcap);
        x = p.softcap * t;
        dcap = 1.f - t * t;
      }
      if (p.alibi != nullptr) x += slope * (float)(kpos - qpos);
      bool valid = qi < p.sq && kpos < p.kv_len;
      if (p.causal) {
        valid = valid && kpos <= qpos;
        if (p.window > 0) valid = valid && kpos > qpos - p.window;
      }
      if (valid && p.q_seg != nullptr) {
        valid = p.q_seg[(long long)b * p.sq + qi] ==
                p.kv_seg[(long long)b * p.skv + kpos];
      }
      const float pp = valid ? expf(x - lse_s[r]) : 0.f;
      float ds = pp * (dp[i][j] - di_s[r]);
      if (p.softcap > 0.f) ds = ds * dcap;
      s[i][j] = pp;
      dp[i][j] = ds * p.scale;
    }
  }
}

// lse and di of q rows [q0, q0 + R) into shared memory (0 past sq).
template <int R>
__device__ __forceinline__ void load_row_stats(const BwdParams& p, int b,
                                               int h, int q0, float* lse_s,
                                               float* di_s) {
  if (threadIdx.x < R) {
    const int qi = q0 + threadIdx.x;
    const long long at = ((long long)b * p.hq + h) * p.sq + qi;
    lse_s[threadIdx.x] = qi < p.sq ? p.lse[at] : 0.f;
    di_s[threadIdx.x] = qi < p.sq ? p.di[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int BKV = 64, BQ = Geo<D>::DKV_BQ, DS = Geo<D>::DS;
  constexpr int PS = BKV + 4;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BKV][DS]
  float* Vs = Ks + BKV * DS;      // [BKV][DS]
  float* Qs = Vs + BKV * DS;      // [BQ][DS]
  float* dOs = Qs + BQ * DS;      // [BQ][DS]
  float* Ps = dOs + BQ * DS;      // [BQ][PS]  P, q-major
  float* dSs = Ps + BQ * PS;      // [BQ][PS]  round(dS), q-major
  float* lse_s = dSs + BQ * PS;   // [BQ]
  float* di_s = lse_s + BQ;       // [BQ]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int k0 = kt * BKV;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qbase = ((long long)b * p.hq + h) * (long long)p.sq * D;
  const long long kbase = ((long long)b * p.hkv + hk) * (long long)p.skv * D;
  const T* q = static_cast<const T*>(p.q) + qbase;
  const T* dout = static_cast<const T*>(p.dout) + qbase;

  load_tile<D, BKV>(Ks, static_cast<const T*>(p.k) + kbase, k0, p.kv_len);
  load_tile<D, BKV>(Vs, static_cast<const T*>(p.v) + kbase, k0, p.kv_len);

  // q tiles that can see this kv tile (none past the kv tail).
  const int n_qt = (p.sq + BQ - 1) / BQ;
  int first = 0, last = k0 < p.kv_len ? n_qt - 1 : -1;
  if (p.causal) {
    const int lo = k0 - p.q_offset;  // first q row at or past k0
    first = lo > 0 ? lo / BQ : 0;
    if (p.window > 0) {
      const int hi = k0 + BKV - 1 + p.window - 1 - p.q_offset;
      last = hi < 0 ? -1 : min(last, hi / BQ);
    }
  }

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int qt = first; qt <= last; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous step's readers are done
    load_tile<D, BQ>(Qs, q, q0, p.sq);
    load_tile<D, BQ>(dOs, dout, q0, p.sq);
    load_row_stats<BQ>(p, b, h, q0, lse_s, di_s);
    __syncthreads();

    constexpr int RI = BQ / 16, RJ = BKV / 16;
    float s[RI][RJ], ds[RI][RJ];
    scores_and_ds<D, BQ, BKV>(p, b, h, q0, k0, Qs, Ks, dOs, Vs, lse_s, di_s,
                              s, ds);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        Ps[(ty * RI + i) * PS + tx + 16 * j] = s[i][j];
        dSs[(ty * RI + i) * PS + tx + 16 * j] = round_to<T>(ds[i][j]);
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: thread kv rows ty*4+i, cols tx+16*j.
    for (int r = 0; r < BQ; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[r * PS + ty * 4]);
      const float4 sv =
          *reinterpret_cast<const float4*>(&dSs[r * PS + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float o = dOs[r * DS + tx + 16 * j];
        const float x = Qs[r * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pa[i], o, dv[i][j]);
          dk[i][j] = fmaf(sa[i], x, dk[i][j]);
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.out1) + ((long long)b * p.hq + h) *
                                            (long long)p.skv * D;
  T* dv_out = static_cast<T*>(p.out2) + ((long long)b * p.hq + h) *
                                            (long long)p.skv * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= p.skv) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const long long at = (long long)kr * D + tx + 16 * j;
      dk_out[at] = from_f<T>(dk[i][j]);
      dv_out[at] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(BwdParams p) {
  constexpr int BQ = 64, BKV = Geo<D>::DQ_BKV, DS = Geo<D>::DS;
  constexpr int PS = BKV + 4;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][DS]
  float* dOs = Qs + BQ * DS;      // [BQ][DS]
  float* Ks = dOs + BQ * DS;      // [BKV][DS]
  float* Vs = Ks + BKV * DS;      // [BKV][DS]
  float* dSs = Vs + BKV * DS;     // [BQ][PS]  round(dS)
  float* lse_s = dSs + BQ * PS;   // [BQ]
  float* di_s = lse_s + BQ;       // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qbase = ((long long)b * p.hq + h) * (long long)p.sq * D;
  const long long kbase = ((long long)b * p.hkv + hk) * (long long)p.skv * D;
  const T* k = static_cast<const T*>(p.k) + kbase;
  const T* v = static_cast<const T*>(p.v) + kbase;

  load_tile<D, BQ>(Qs, static_cast<const T*>(p.q) + qbase, q0, p.sq);
  load_tile<D, BQ>(dOs, static_cast<const T*>(p.dout) + qbase, q0, p.sq);
  load_row_stats<BQ>(p, b, h, q0, lse_s, di_s);

  // kv tiles this q tile sees: the forward's active cells.
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + p.q_offset;
  int first = 0;
  int last = (p.kv_len + BKV - 1) / BKV - 1;
  if (p.causal) {
    last = min(last, q_last / BKV);
    if (p.window > 0) {
      const int lo = q_first - p.window + 1;
      first = lo > 0 ? lo / BKV : 0;
    }
  }

  float dq[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq[i][j] = 0.f;

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();
    load_tile<D, BKV>(Ks, k, k0, p.kv_len);
    load_tile<D, BKV>(Vs, v, k0, p.kv_len);
    __syncthreads();

    constexpr int RJ = BKV / 16;
    float s[4][RJ], ds[4][RJ];
    scores_and_ds<D, BQ, BKV>(p, b, h, q0, k0, Qs, Ks, dOs, Vs, lse_s, di_s,
                              s, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        dSs[(ty * 4 + i) * PS + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();

    // dQ += dS K: thread q rows ty*4+i, cols tx+16*j.
    for (int t = 0; t < BKV; t += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(&dSs[(ty * 4 + i) * PS + t]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int c = tx + 16 * j;
        const float k0v = Ks[(t + 0) * DS + c], k1v = Ks[(t + 1) * DS + c];
        const float k2v = Ks[(t + 2) * DS + c], k3v = Ks[(t + 3) * DS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = dq[i][j];
          a = fmaf(sv[i].x, k0v, a);
          a = fmaf(sv[i].y, k1v, a);
          a = fmaf(sv[i].z, k2v, a);
          a = fmaf(sv[i].w, k3v, a);
          dq[i][j] = a;
        }
      }
    }
  }

  T* dq_out = static_cast<T*>(p.out1) + qbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq_out[(long long)qi * D + tx + 16 * j] = from_f<T>(dq[i][j]);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (the design is in the note at the top),
// on the primitives of tc.cuh.
namespace tc {

// dK/dV block: BKV kv rows, BQ q rows a step. A warp owns 16 kv rows and
// DW = D / DSPLIT columns of their dK and dV; at DSPLIT 2 (d 256, whose
// 16 x 256 dK and dV sums would not fit one thread's registers) two
// warps share 16 kv rows and each recomputes their S^T and dP^T.
template <int D_, int BKV_, int BQ_, int DSPLIT_>
struct DkvTiles {
  static constexpr int D = D_, BKV = BKV_, BQ = BQ_, DSPLIT = DSPLIT_;
  static constexpr int WARPS = BKV / 16 * DSPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 8;  // row stride (elements)
  static constexpr int DW = D / DSPLIT;
  // K, V; Q and dO twice (double buffer); lse and di twice.
  static constexpr size_t smem =
      sizeof(bf16) * (2 * BKV + 4 * BQ) * LD + sizeof(float) * 4 * BQ;
  static_assert(smem <= 232448, "over the card's 227 KB a block");
};

// dQ block: BQ q rows, BKV kv rows a step; a warp owns 16 q rows.
template <int D_, int BQ_, int BKV_>
struct DqTiles {
  static constexpr int D = D_, BQ = BQ_, BKV = BKV_;
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 8;
  // Q, dO; K and V twice (double buffer).
  static constexpr size_t smem = sizeof(bf16) * (2 * BQ + 4 * BKV) * LD;
  static_assert(smem <= 232448, "over the card's 227 KB a block");
};

// The tiles of each head width (see the note at the top of the file).
template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  using Dkv = DkvTiles<64, 64, 32, 1>;
  using Dq = DqTiles<64, 64, 32>;
};
template <>
struct Tiles<128> {
  using Dkv = DkvTiles<128, 64, 32, 1>;
  using Dq = DqTiles<128, 64, 32>;
};
template <>
struct Tiles<256> {
  using Dkv = DkvTiles<256, 32, 32, 2>;
  using Dq = DqTiles<256, 64, 16>;
};

// Whether a (q tile, kv tile) step needs the masks: segment ids, a q or kv
// tail, the causal diagonal or the window's edge crossing it. Other steps
// skip the mask arithmetic.
__device__ __forceinline__ bool needs_mask(const BwdParams& p, int q0, int bq,
                                           int k0, int bkv) {
  if (p.q_seg != nullptr || q0 + bq > p.sq || k0 + bkv > p.kv_len)
    return true;
  if (!p.causal) return false;
  const int qlo = q0 + p.q_offset, qhi = qlo + bq - 1;
  return k0 + bkv - 1 > qlo || (p.window > 0 && k0 <= qhi - p.window);
}

// One score's s (the raw q.k sum) -> p and dp -> rounded-later dS, the
// CUDA-core kernels' arithmetic (scores_and_ds).
__device__ __forceinline__ void p_and_ds(const BwdParams& p, int b, int qi,
                                         int kpos, float lse, float di,
                                         float slope, bool masked, float& s,
                                         float& dp) {
  const int qpos = qi + p.q_offset;
  float x = s * p.scale;
  float dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x * p.inv_softcap);
    x = p.softcap * t;
    dcap = 1.f - t * t;
  }
  if (p.alibi != nullptr) x += slope * (float)(kpos - qpos);
  bool valid = true;
  if (masked) {
    valid = qi < p.sq && kpos < p.kv_len;
    if (p.causal) {
      valid = valid && kpos <= qpos;
      if (p.window > 0) valid = valid && kpos > qpos - p.window;
    }
    if (valid && p.q_seg != nullptr) {
      valid = p.q_seg[(long long)b * p.sq + qi] ==
              p.kv_seg[(long long)b * p.skv + kpos];
    }
  }
  const float pp = valid ? expf(x - lse) : 0.f;
  float ds = pp * (dp - di);
  if (p.softcap > 0.f) ds = ds * dcap;
  s = pp;
  dp = ds * p.scale;
}

// dK/dV: one block per (BKV kv rows, q head, batch), looping over the q
// tiles that see them. Per step, kv-major: S^T = K Q^T and dP^T = V dO^T,
// so P^T and dS^T land in the accumulator layout and go straight, rounded
// to bf16, into dV += P^T dO and dK += dS^T Q (dO and Q read through
// ldmatrix.trans).
template <class G>
__global__ void __launch_bounds__(G::THREADS)
    flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int D = G::D, BKV = G::BKV, BQ = G::BQ, DSPLIT = G::DSPLIT;
  constexpr int LD = G::LD, DW = G::DW, NT = G::THREADS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);  // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                  // [BKV][LD]
  bf16* Qs = Vs + BKV * LD;                  // [2][BQ][LD]
  bf16* dOs = Qs + 2 * BQ * LD;              // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int k0 = kt * BKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp / DSPLIT * 16;  // the warp's kv rows in the tile
  const int wc = warp % DSPLIT * DW;  // and its dK/dV columns
  const long long qrow = ((long long)b * p.hq + h) * p.sq;
  const bf16* q = static_cast<const bf16*>(p.q) + qrow * D;
  const bf16* dout = static_cast<const bf16*>(p.dout) + qrow * D;
  const float* lse = p.lse + qrow;
  const float* di = p.di + qrow;
  const long long kvbase = ((long long)b * p.hkv + hk) * p.skv * D;

  load_rows<D, BKV, NT, LD>(Ks, static_cast<const bf16*>(p.k) + kvbase, k0,
                            p.kv_len);
  load_rows<D, BKV, NT, LD>(Vs, static_cast<const bf16*>(p.v) + kvbase, k0,
                            p.kv_len);

  // q tiles that can see this kv tile (none past the kv tail).
  const int n_qt = (p.sq + BQ - 1) / BQ;
  int first = 0, last = k0 < p.kv_len ? n_qt - 1 : -1;
  if (p.causal) {
    const int lo = k0 - p.q_offset;  // first q row at or past k0
    first = lo > 0 ? lo / BQ : 0;
    if (p.window > 0) {
      const int hi = k0 + BKV - 1 + p.window - 1 - p.q_offset;
      last = hi < 0 ? -1 : min(last, hi / BQ);
    }
  }

  auto stage = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    load_rows<D, BQ, NT, LD>(Qs + buf * BQ * LD, q, q0, p.sq);
    load_rows<D, BQ, NT, LD>(dOs + buf * BQ * LD, dout, q0, p.sq);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool ok = q0 + r < p.sq;
      cp_async4(lse_s + buf * BQ + r, ok ? lse + q0 + r : lse, ok);
      cp_async4(di_s + buf * BQ + r, ok ? di + q0 + r : di, ok);
    }
  };
  if (first <= last) stage(first, 0);
  cp_async_commit();

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int kr0 = k0 + wr + gr;  // the thread's kv rows: kr0, kr0 + 8
  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
  const uint32_t ks = smem_addr(Ks), vs = smem_addr(Vs);

  for (int qt = first; qt <= last; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt < last) stage(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = qt * BQ;
    const uint32_t qs = smem_addr(Qs + buf * BQ * LD);
    const uint32_t os = smem_addr(dOs + buf * BQ * LD);
    const float* lse_b = lse_s + buf * BQ;
    const float* di_b = di_s + buf * BQ;

    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ka[4], va[4];
      ldsm(ka, ks + a_off<LD>(lane, wr, kk));
      ldsm(va, vs + a_off<LD>(lane, wr, kk));
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t qb[4], ob[4];
        ldsm(qb, qs + b_off<LD>(lane, j * 8, kk));
        ldsm(ob, os + b_off<LD>(lane, j * 8, kk));
        mma(s[j], ka, qb[0], qb[1]);
        mma(s[j + 1], ka, qb[2], qb[3]);
        mma(dp[j], va, ob[0], ob[1]);
        mma(dp[j + 1], va, ob[2], ob[3]);
      }
    }

    const bool masked = needs_mask(p, q0, BQ, k0, BKV);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * tq + (e & 1);
        p_and_ds(p, b, q0 + ql, kr0 + (e >> 1) * 8, lse_b[ql], di_b[ql],
                 slope, masked, s[j][e], dp[j][e]);
      }

#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      uint32_t pa[4], sa[4];
      to_a(pa, s, c);   // P^T, rounded (the dV product's bf16 P)
      to_a(sa, dp, c);  // dS^T, rounded
#pragma unroll
      for (int n = 0; n < DW; n += 16) {
        uint32_t ob[4], qb[4];
        ldsm_t(ob, os + a_off<LD>(lane, c * 16, wc + n));
        ldsm_t(qb, qs + a_off<LD>(lane, c * 16, wc + n));
        mma(dv[n / 8], pa, ob[0], ob[1]);
        mma(dv[n / 8 + 1], pa, ob[2], ob[3]);
        mma(dk[n / 8], sa, qb[0], qb[1]);
        mma(dk[n / 8 + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // the next stage overwrites this step's buffers
  }
  cp_async_wait<0>();

  const long long obase = ((long long)b * p.hq + h) * p.skv * D;
  bf16* dk_out = static_cast<bf16*>(p.out1) + obase;
  bf16* dv_out = static_cast<bf16*>(p.out2) + obase;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = kr0 + 8 * half;
    if (kr >= p.skv) continue;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      const long long at = (long long)kr * D + wc + n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(dk_out + at) =
          pack(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + at) =
          pack(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// dQ: one block per (BQ q rows, q head, batch), looping over its live kv
// tiles, the last q tiles (the most kv tiles under a causal mask) first.
// Per step: S = Q K^T, dP = dO V^T, then dS, rounded to bf16 in registers,
// goes straight into dQ += dS K (K read through ldmatrix.trans).
template <class G>
__global__ void __launch_bounds__(G::THREADS)
    flash_bwd_dq_kernel(BwdParams p) {
  constexpr int D = G::D, BQ = G::BQ, BKV = G::BKV;
  constexpr int LD = G::LD, NT = G::THREADS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                  // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                  // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;              // [2][BKV][LD]

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  const long long qrow = ((long long)b * p.hq + h) * p.sq;
  const long long kvbase = ((long long)b * p.hkv + hk) * p.skv * D;
  const bf16* k = static_cast<const bf16*>(p.k) + kvbase;
  const bf16* v = static_cast<const bf16*>(p.v) + kvbase;

  load_rows<D, BQ, NT, LD>(Qs, static_cast<const bf16*>(p.q) + qrow * D, q0,
                           p.sq);
  load_rows<D, BQ, NT, LD>(dOs, static_cast<const bf16*>(p.dout) + qrow * D,
                           q0, p.sq);

  // kv tiles this q tile sees: the forward's active cells.
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + p.q_offset;
  int first = 0;
  int last = (p.kv_len + BKV - 1) / BKV - 1;
  if (p.causal) {
    last = min(last, q_last / BKV);
    if (p.window > 0) {
      const int lo = q_first - p.window + 1;
      first = lo > 0 ? lo / BKV : 0;
    }
  }

  auto stage = [&](int kt, int buf) {
    load_rows<D, BKV, NT, LD>(Ks + buf * BKV * LD, k, kt * BKV, p.kv_len);
    load_rows<D, BKV, NT, LD>(Vs + buf * BKV * LD, v, kt * BKV, p.kv_len);
  };
  if (first <= last) stage(first, 0);
  cp_async_commit();

  // The thread's q rows qr0 and qr0 + 8, with their lse and di (0 past sq).
  const int qr0 = q0 + wr + gr;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qr0 + 8 * half;
    lse_r[half] = qi < p.sq ? p.lse[qrow + qi] : 0.f;
    di_r[half] = qi < p.sq ? p.di[qrow + qi] : 0.f;
  }
  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
  const uint32_t qs = smem_addr(Qs), os = smem_addr(dOs);

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = first; kt <= last; ++kt) {
    const int buf = (kt - first) & 1;
    if (kt < last) stage(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * BKV;
    const uint32_t ks = smem_addr(Ks + buf * BKV * LD);
    const uint32_t vs = smem_addr(Vs + buf * BKV * LD);

    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[4], oa[4];
      ldsm(qa, qs + a_off<LD>(lane, wr, kk));
      ldsm(oa, os + a_off<LD>(lane, wr, kk));
#pragma unroll
      for (int j = 0; j < BKV / 8; j += 2) {
        uint32_t kb[4], vb[4];
        ldsm(kb, ks + b_off<LD>(lane, j * 8, kk));
        ldsm(vb, vs + b_off<LD>(lane, j * 8, kk));
        mma(s[j], qa, kb[0], kb[1]);
        mma(s[j + 1], qa, kb[2], kb[3]);
        mma(dp[j], oa, vb[0], vb[1]);
        mma(dp[j + 1], oa, vb[2], vb[3]);
      }
    }

    const bool masked = needs_mask(p, q0, BQ, k0, BKV);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        p_and_ds(p, b, qr0 + 8 * half, k0 + j * 8 + 2 * tq + (e & 1),
                 lse_r[half], di_r[half], slope, masked, s[j][e], dp[j][e]);
      }

#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      uint32_t sa[4];
      to_a(sa, dp, c);  // dS, rounded
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t kb[4];
        ldsm_t(kb, ks + a_off<LD>(lane, c * 16, n));
        mma(dq[n / 8], sa, kb[0], kb[1]);
        mma(dq[n / 8 + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dq_out = static_cast<bf16*>(p.out1) + qrow * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qr0 + 8 * half;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq_out + (long long)qi * D + n * 8 +
                                   2 * tq) =
          pack(dq[n][2 * half], dq[n][2 * half + 1]);
  }
}

template <int D>
int launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  using G = typename Tiles<D>::Dkv;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<G>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.skv + G::BKV - 1) / G::BKV, p.hq, batch);
  flash_bwd_dkv_kernel<G><<<grid, G::THREADS, G::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  using G = typename Tiles<D>::Dq;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<G>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.sq + G::BQ - 1) / G::BQ, p.hq, batch);
  flash_bwd_dq_kernel<G><<<grid, G::THREADS, G::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace {

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* out1, void* out2, const void* alibi,
                      const void* q_seg, const void* kv_seg, int hq, int hkv,
                      int sq, int skv, int kv_len, float scale, int causal,
                      int q_offset, int window, float softcap,
                      float inv_softcap) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.out1 = out1;
  p.out2 = out2;
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

template <typename T, int D>
int launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::dkv_smem;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((p.skv + 63) / 64, p.hq, batch);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::dq_smem;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((p.sq + 63) / 64, p.hq, batch);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool served(int dtype, int head_dim) {
  return (dtype == 0 || dtype == 1) &&
         (head_dim == 64 || head_dim == 128 || head_dim == 256);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the
// tensor-core kernels); q, k, v, dO and the outputs share it.
// flash_bwd_dkv writes dK to out1 and dV to out2; flash_bwd_dq writes dQ
// to out1 (out2 unused). Each returns cudaGetLastError() after its launch;
// 1 (cudaErrorInvalidValue) for a dtype or head_dim (64, 128, 256) this
// build does not serve.
#define FLASH_BWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *lse, const void *di, void *out1, void *out2,              \
      const void *alibi, const void *q_seg, const void *kv_seg, int dtype, \
      int batch, int hq, int hkv, int sq, int skv, int kv_len,              \
      int head_dim, float scale, int causal, int q_offset, int window,      \
      float softcap, float inv_softcap, void *stream
#define FLASH_BWD_PARAMS                                                   \
  make_params(q, k, v, dout, lse, di, out1, out2, alibi, q_seg, kv_seg, hq, \
              hkv, sq, skv, kv_len, scale, causal, q_offset, window,        \
              softcap, inv_softcap)

extern "C" int flash_bwd_dkv(FLASH_BWD_ARGS) {
  if (!served(dtype, head_dim)) return (int)cudaErrorInvalidValue;
  const BwdParams p = FLASH_BWD_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (head_dim == 64) return launch_dkv<float, 64>(p, batch, s);
    if (head_dim == 256) return launch_dkv<float, 256>(p, batch, s);
    return launch_dkv<float, 128>(p, batch, s);
  }
  if (head_dim == 64) return tc::launch_dkv<64>(p, batch, s);
  if (head_dim == 256) return tc::launch_dkv<256>(p, batch, s);
  return tc::launch_dkv<128>(p, batch, s);
}

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS) {
  if (!served(dtype, head_dim)) return (int)cudaErrorInvalidValue;
  const BwdParams p = FLASH_BWD_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (head_dim == 64) return launch_dq<float, 64>(p, batch, s);
    if (head_dim == 256) return launch_dq<float, 256>(p, batch, s);
    return launch_dq<float, 128>(p, batch, s);
  }
  if (head_dim == 64) return tc::launch_dq<64>(p, batch, s);
  if (head_dim == 256) return tc::launch_dq<256>(p, batch, s);
  return tc::launch_dq<128>(p, batch, s);
}
