// attn_weights: the attention probabilities P = exp(s - lse) for Hopper
// (sm_90a), the debug surface of the flash forward.
//
// Replaces the Pallas TPU kernel tpu_flash/ops/flash/debug.py::
// _weights_kernel (:40, launched by attention_weights :96). Given the
// forward's own lse (flash_fwd with lse, sinks folded in), it re-walks the
// score tiles with the forward's arithmetic and writes f32 P:
//   s = round_T(q * sm_scale) k^T in f32; softcap; ALiBi slope * (kv_pos -
//   q_pos); causal (with q_offset) and window masks to MASK_VALUE;
//   P = lse == -inf ? 0 : exp(s - lse), for kv positions < kv_len, exp
//   on the special-function unit (tc::exp_sfu), well inside the per-row
//   bar of 2^-12.
//
// What bounds it on this card: bytes. It writes 4 bytes of P per (query,
// key) pair and does 2 d operations for each (at b 1, 32 heads, 2048 x
// 2048, d 128: 537 MB written, 0.16 ms at 3.35 TB/s, against 34 GFLOP).
// Design:
//  - one block of 4 warps per (64 q rows, q head, batch) walks the kv
//    tiles of its rows, K double-buffered by cp.async, so each K tile is
//    read once a (q tile, q head); a warp owns 16 q rows; the last q
//    tiles (the most live kv tiles under a causal mask) start first;
//  - scores on the tensor cores: bf16 q and k on mma.sync m16n8k16 (bf16
//    in, f32 sums), the TPU kernel's own arithmetic (its bf16 dot runs at
//    Precision.DEFAULT, one bf16 pass); f32 q and k on the three-pass TF32
//    product of tc.cuh, the counterpart of Precision.HIGHEST. q is scaled
//    and rounded to its own type when it is staged (f32 q also split
//    into its hi and lo parts there, once a block);
//  - a kv tile that the causal mask or the window hides from all 64 rows is
//    written with no load and no product: each row's elements there are
//    the row's exp(MASK_VALUE - lse), taken once a row with expf. That is
//    0 for a row that sees a key, and 1 for a row that sees none (a window
//    past kv_len), whose lse is MASK_VALUE as in the plain version. Masks
//    are applied only on tiles that cross an edge;
//  - P goes out through a per-warp shared-memory tile as 16-byte streaming
//    stores (st.global.cs: written once, never read back), so one store
//    instruction of a warp covers whole 128-byte lines.
// Tiles (WTiles): 64 kv columns a step where a K row is at most 256 bytes
// (bf16 d 64 and 128, f32 d 64), else 32. Each launch runs on the caller's
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

using tc::bf16;

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

template <typename T, int D>
struct WTiles {
  static constexpr bool BF16 = sizeof(T) == 2;
  // f32 q at d <= 128: each lane keeps its A fragments of the warp's 16
  // rows, split, in registers (D of them), so Q takes no shared memory
  // and K steps 64 columns.
  static constexpr bool QREG = !BF16 && D <= 128;
  static constexpr int BQ = 64, WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int BK = !QREG && D * (int)sizeof(T) > 256 ? 32 : 64;
  static constexpr int LD = BF16 ? D + 8 : D + 4;  // row stride (elements)
  static constexpr int PLD = BK + 8;  // P tile row stride (floats), 8 mod 32
  // Q's planes in shared memory: bf16, or f32 hi and lo, or none (QREG).
  static constexpr int QP = BF16 ? 1 : QREG ? 0 : 2;
  // Q; K twice (double buffer); a 16 x BK P tile a warp.
  static constexpr size_t smem =
      sizeof(T) * (QP * BQ + 2 * BK) * LD + sizeof(float) * WARPS * 16 * PLD;
  // With the static fill of the rows (BQ floats).
  static_assert(smem + sizeof(float) * BQ <= 232448,
                "over the card's 227 KB a block");
};

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 round_to<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [k0, k0 + BK) of K into a [BK][LD] tile (zeros past kv_len).
template <typename T, int D, class G>
__device__ __forceinline__ void stage_k(T* dst, const T* k, int k0,
                                        int kv_len) {
  if constexpr (G::BF16)
    tc::load_rows<D, G::BK, G::THREADS, G::LD>(dst, k, k0, kv_len);
  else
    tc::load_rows_f32<D, G::BK, G::THREADS, G::LD>(dst, k, k0, kv_len);
}

// S (the warp's 16 rows x BK columns) = Qs Kb^T in f32 sums (f32: Qs holds
// q's hi plane, then its lo plane).
template <typename T, int D, class G>
__device__ __forceinline__ void scores(float (&s)[G::BK / 8][4], const T* Qs,
                                       const T* Kb, int lane, int wr) {
  constexpr int LD = G::LD, BK = G::BK;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (G::BF16) {
    const uint32_t qs = tc::smem_addr(Qs), ks = tc::smem_addr(Kb);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[4];
      tc::ldsm(qa, qs + tc::a_off<LD>(lane, wr, kk));
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t kb[4];
        tc::ldsm(kb, ks + tc::b_off<LD>(lane, j * 8, kk));
        tc::mma(s[j], qa, kb[0], kb[1]);
        tc::mma(s[j + 1], qa, kb[2], kb[3]);
      }
    }
  } else {
    const uint32_t* qh = reinterpret_cast<const uint32_t*>(Qs);
    float s_lo[BK / 8][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      tc::Split<4> qa;
      tc::tf32_lda<LD>(qa, qh, qh + G::BQ * LD, lane, wr, kk);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        tc::Split<2> kb[2];
        tc::tf32_ldb2<LD>(kb[0], kb[1], Kb, lane, j * 8, kk);
        tc::mma3(s[j], s_lo[j], qa, kb[0]);
        tc::mma3(s[j + 1], s_lo[j + 1], qa, kb[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_lo[j][e];
  }
}

// The same for QREG: q's A fragments from registers.
template <int D, class G>
__device__ __forceinline__ void scores_qreg(float (&s)[G::BK / 8][4],
                                            const tc::Split<4> (&qf)[D / 8],
                                            const float* Kb, int lane) {
  constexpr int LD = G::LD, BK = G::BK;
  float s_lo[BK / 8][4] = {};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
      tc::Split<2> kb[2];
      tc::tf32_ldb2<LD>(kb[0], kb[1], Kb, lane, j * 8, kk);
      tc::mma3(s[j], s_lo[j], qf[kk / 8], kb[0]);
      tc::mma3(s[j + 1], s_lo[j + 1], qf[kk / 8], kb[1]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += s_lo[j][e];
}

// Columns [c0, c1) of rows [r0, r1) of P, hidden from every row: row r
// takes fill[r - r0], the block's threads on consecutive 16-byte pieces
// where the rows allow.
__device__ __forceinline__ void fill_hidden(const WParams& p, float* w,
                                            const float* fill, int r0,
                                            int r1, int c0, int c1, int nt) {
  if (c0 >= c1 || r0 >= r1) return;
  if (p.kv_len % 4 == 0) {  // c0 and c1 are multiples of 4 too
    const int per = (c1 - c0) / 4;
    for (int i = threadIdx.x; i < (r1 - r0) * per; i += nt) {
      const int r = i / per, c = c0 + 4 * (i % per);
      const float f = fill[r];
      __stcs(reinterpret_cast<float4*>(w + (long long)(r0 + r) * p.kv_len +
                                       c),
             make_float4(f, f, f, f));
    }
  } else {
    const int per = c1 - c0;
    for (int i = threadIdx.x; i < (r1 - r0) * per; i += nt)
      w[(long long)(r0 + i / per) * p.kv_len + c0 + i % per] = fill[i / per];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(WTiles<T, D>::THREADS)
    attn_weights_kernel(WParams p) {
  using G = WTiles<T, D>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, PLD = G::PLD;
  constexpr int NT = G::THREADS;
  extern __shared__ __align__(16) unsigned char w_smem[];
  __shared__ float fill[BQ];  // each row's P on a hidden tile
  T* Qs = reinterpret_cast<T*>(w_smem);  // [QP][BQ][LD] scaled q
  T* Ks = Qs + G::QP * BQ * LD;          // [2][BK][LD]
  float* Ps = reinterpret_cast<float*>(Ks + 2 * BK * LD);  // [4][16][PLD]

  const int qt = gridDim.x - 1 - blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * BQ, q_end = min(q0 + BQ, p.sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  const T* q = static_cast<const T*>(p.q) + (long long)bh * p.sq * D;
  const T* k = static_cast<const T*>(p.k) +
               ((long long)b * p.hkv + hk) * (long long)p.skv * D;
  float* w = p.w + (long long)bh * p.sq * p.kv_len;

  // The kv tiles some row of the block sees; the rest take fill.
  const int n_kt = (p.kv_len + BK - 1) / BK;
  int first = 0, last = n_kt - 1;
  if (p.causal) {
    const int hi = q_end - 1 + p.q_offset;  // the last row's position
    last = hi < 0 ? -1 : min(last, hi / BK);
    if (p.window > 0) {
      const int lo = q0 + p.q_offset - p.window + 1;
      first = lo > 0 ? lo / BK : 0;
    }
  }
  if (first <= last) stage_k<T, D, G>(Ks, k, first * BK, p.kv_len);
  tc::cp_async_commit();

  tc::Split<4> qf[G::QREG ? D / 8 : 1];
  if constexpr (G::QREG) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (gr, tq), (gr + 8, tq), then + 4 cols
        const int r = q0 + wr + gr + 8 * (e & 1);
        const float x =
            r < p.sq ? q[(long long)r * D + c * 8 + tq + 4 * (e >> 1)] *
                           p.scale
                     : 0.f;
        tc::tf32_split(x, qf[c].hi[e], qf[c].lo[e]);
      }
  } else {
    for (int i = threadIdx.x; i < BQ * D; i += NT) {
      const int r = i / D, c = i % D;
      const T x = round_to<T>(
          q0 + r < p.sq ? to_f(q[(long long)(q0 + r) * D + c]) * p.scale
                        : 0.f);
      if constexpr (G::BF16) {
        Qs[r * LD + c] = x;
      } else {
        uint32_t* qh = reinterpret_cast<uint32_t*>(Qs) + r * LD + c;
        tc::tf32_split(x, qh[0], qh[BQ * LD]);
      }
    }
  }
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    const float l = qi < p.sq ? p.lse[(long long)bh * p.sq + qi] : 0.f;
    fill[threadIdx.x] = l == -INFINITY ? 0.f : expf(__fsub_rn(MASK_VALUE, l));
  }
  __syncthreads();
  if (first > last) {
    fill_hidden(p, w, fill, q0, q_end, 0, p.kv_len, NT);
  } else {
    fill_hidden(p, w, fill, q0, q_end, 0, first * BK, NT);
    fill_hidden(p, w, fill, q0, q_end, min((last + 1) * BK, p.kv_len),
                p.kv_len, NT);
  }

  // The thread's rows (gr, gr + 8 of the warp's 16) and their lse.
  float lse_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + wr + gr + 8 * half;
    lse_r[half] = qi < p.sq ? p.lse[(long long)bh * p.sq + qi] : 0.f;
  }
  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
  float* Pw = Ps + warp * 16 * PLD;
  const bool vec = p.kv_len % 4 == 0;

  for (int kt = first; kt <= last; ++kt) {
    const int buf = (kt - first) & 1;
    if (kt < last)
      stage_k<T, D, G>(Ks + (buf ^ 1) * BK * LD, k, (kt + 1) * BK, p.kv_len);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * BK;

    float s[BK / 8][4];
    if constexpr (G::QREG)
      scores_qreg<D, G>(s, qf, Ks + buf * BK * LD, lane);
    else
      scores<T, D, G>(s, Qs, Ks + buf * BK * LD, lane, wr);

    // Masks only where the causal diagonal or the window's edge crosses
    // the tile.
    const bool masked =
        p.causal && (k0 + BK - 1 > q0 + p.q_offset ||
                     (p.window > 0 && k0 <= q_end - 1 + p.q_offset - p.window));
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int qpos = q0 + wr + gr + 8 * half + p.q_offset;
        const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
        float x = s[j][e];
        if (p.softcap > 0.f)
          x = __fmul_rn(p.softcap, tanhf(__fmul_rn(x, p.inv_softcap)));
        if (p.alibi != nullptr)
          x = __fadd_rn(x, __fmul_rn(slope, (float)(kpos - qpos)));
        if (masked) {
          bool valid = kpos <= qpos;
          if (p.window > 0) valid = valid && kpos > qpos - p.window;
          if (!valid) x = MASK_VALUE;
        }
        s[j][e] = lse_r[half] == -INFINITY
                      ? 0.f
                      : tc::exp_sfu(__fsub_rn(x, lse_r[half]));
      }
      *reinterpret_cast<float2*>(Pw + gr * PLD + j * 8 + 2 * tq) =
          make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(Pw + (gr + 8) * PLD + j * 8 + 2 * tq) =
          make_float2(s[j][2], s[j][3]);
    }
    __syncwarp();
    const bool full = vec && k0 + BK <= p.kv_len;
#pragma unroll
    for (int i = lane; i < 16 * BK / 4; i += 32) {
      const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
      const int qi = q0 + wr + r;
      if (qi >= p.sq) continue;
      const float4 v4 = *reinterpret_cast<const float4*>(Pw + r * PLD + c);
      float* dst = w + (long long)qi * p.kv_len + k0 + c;
      if (full) {
        __stcs(reinterpret_cast<float4*>(dst), v4);
      } else {
        const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k0 + c + t < p.kv_len) dst[t] = vs[t];
      }
    }
    __syncwarp();     // the P tile is rewritten next step
    __syncthreads();  // the next stage overwrites this step's K
  }
  tc::cp_async_wait<0>();
}

template <typename T, int D>
int launch(const WParams& p, int batch, cudaStream_t stream) {
  using G = WTiles<T, D>;
  cudaFuncSetAttribute(attn_weights_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.sq + G::BQ - 1) / G::BQ, batch * p.hq);
  attn_weights_kernel<T, D><<<grid, G::THREADS, G::smem, stream>>>(p);
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
                    : launch_width<bf16>(p, head_dim, batch, s);
}
