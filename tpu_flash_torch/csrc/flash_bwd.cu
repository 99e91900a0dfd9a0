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
// f32: the same two kernels on the tensor cores (namespace tc::tf32), in
// three-pass TF32 (tc.cuh: each f32 operand split into hi = tf32(x) and
// lo = tf32(x - hi), each product lo hi + hi lo + hi hi on mma.sync
// m16n8k8, lo lo dropped), the counterpart of the TPU kernel's f32 dots
// at Precision.HIGHEST, a multi-pass bf16 product (backward.py:38-43).
// All seven products take it; dS and P are not rounded; S and dP sum
// their small terms apart from hi hi; p's exp runs on the special-function
// unit (exp_sfu). Operands stay f32 in shared memory (rows of D + 4
// floats), read by ldmatrix (an 8 x 4 block of floats is an 8 x 8 b16
// matrix whose lanes get the tf32 fragment's layout) and split in
// registers, four integer and float operations a value; the dK/dV
// kernel's Q and dO, which its 4 warps each read twice a step, are split
// once as they are staged (their lo parts into planes beside them). S^T
// and dP^T come out kv-major as in bf16, and P^T and dS^T go from the
// accumulators into the A operand with no shuffle (tf32_to_a takes the k
// order the accumulator holds, tf32_ldb_t reads Q and dO in that order).
// One thing three-pass sums do not give: where dP - di cancels, dS keeps
// the f32 rounding noise of dP and di, which the plain version leaves in
// the order of cuBLAS's f32 product (a sequential FMA chain over d) and
// a per-row bar of 2^-12 holds in a row of few keys. So such an element
// takes its dP again on the CUDA cores in that order (exact_dot; the
// rule is at p_and_ds). Tiles (tf32::Tiles<D>, the fastest of
// tools/torch_bwd_sweep.py --dtype float32): dK/dV owns 64 kv rows (at d
// 256 two warps a 16 rows, as in bf16) and steps 16 q rows, each step's Q
// and dO staged in turn with their lo planes (101.5 KB at d 128, two
// blocks an SM; 200 KB at d 256); dQ owns 64 q rows and steps 32 kv rows,
// each step's K and V staged in turn (101 KB at d 128).
//
// Later work (ROADMAP item 17): wgmma with TMA and warp specialisation,
// summing each GQA group inside the kernel (per-q-head dK/dV cost hq/hkv
// times their bytes).
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

// The q tiles [first, last] of bq rows that see kv rows [k0, k0 + bkv)
// (none past the kv tail): the triangular grid's active cells.
__device__ __forceinline__ void dkv_steps(const BwdParams& p, int k0, int bkv,
                                          int bq, int& first, int& last) {
  const int n_qt = (p.sq + bq - 1) / bq;
  first = 0;
  last = k0 < p.kv_len ? n_qt - 1 : -1;
  if (p.causal) {
    const int lo = k0 - p.q_offset;  // first q row at or past k0
    first = lo > 0 ? lo / bq : 0;
    if (p.window > 0) {
      const int hi = k0 + bkv - 1 + p.window - 1 - p.q_offset;
      last = hi < 0 ? -1 : min(last, hi / bq);
    }
  }
}

// The kv tiles [first, last] of bkv rows that q rows [q0, q0 + bq) see:
// the forward's active cells.
__device__ __forceinline__ void dq_steps(const BwdParams& p, int q0, int bq,
                                         int bkv, int& first, int& last) {
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + bq, p.sq) - 1 + p.q_offset;
  first = 0;
  last = (p.kv_len + bkv - 1) / bkv - 1;
  if (p.causal) {
    last = min(last, q_last / bkv);
    if (p.window > 0) {
      const int lo = q_first - p.window + 1;
      first = lo > 0 ? lo / bkv : 0;
    }
  }
}

// dO_i . V_j as a sequential f32 FMA chain over d from 0, the order of
// cuBLAS's f32 product in the plain version's dP (f32 kernels only).
template <int D>
__device__ __forceinline__ float exact_dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// One score's s (the raw q.k sum) -> p and dp -> rounded-later dS, the
// plain version's arithmetic (the f32 kernels take p's exp on the
// special-function unit, exp_sfu). EXACT_D > 0 (the f32 kernels): where
// dp - di cancels far enough for the three-pass sums' error in dp to
// weigh on a row of dQ or dK, dp = exact_dot(orow, vrow) (its dO and V
// rows in shared memory): p > 1/2 (a row's P near 1 on one key); p > 1/64
// with |dp - di| under 1/8 of max(|dp|, |di|); and on a masked step (the
// diagonal, a window edge, segment ids), where rows of few keys and kv
// rows of few q rows hold one element's dS nearly alone, any p with
// |dp - di| under 1/64 of it. FLASH_BWD_RETAKE_DP 0 builds the kernels
// without this rule (tools/torch_bwd_sweep.py --seeds counts, over seeds,
// the rows each build leaves past their bar).
#ifndef FLASH_BWD_RETAKE_DP
#define FLASH_BWD_RETAKE_DP 1
#endif
template <int EXACT_D = 0>
__device__ __forceinline__ void p_and_ds(const BwdParams& p, int b, int qi,
                                         int kpos, float lse, float di,
                                         float slope, bool masked, float& s,
                                         float& dp,
                                         const float* orow = nullptr,
                                         const float* vrow = nullptr) {
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
  const float pp = !valid        ? 0.f
                   : EXACT_D > 0 ? exp_sfu(x - lse)
                                 : expf(x - lse);
  if (EXACT_D > 0 && FLASH_BWD_RETAKE_DP &&
      (pp > 0.015625f || (masked && pp > 0.f))) {
    const float gap = fabsf(dp - di), top = fmaxf(fabsf(dp), fabsf(di));
    const float near = pp > 0.015625f ? 0.125f : 0.015625f;
    if (pp > 0.5f || gap < near * top) dp = exact_dot<EXACT_D>(orow, vrow);
  }
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

  int first, last;  // the q tiles that see this kv tile
  dkv_steps(p, k0, BKV, BQ, first, last);

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

  int first, last;  // the kv tiles this q tile sees
  dq_steps(p, q0, BQ, BKV, first, last);

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

// ---------------------------------------------------------------------------
// f32: the same kernels in three-pass TF32 (tc.cuh), operands f32 in shared
// memory and split as their fragments are read (the note at the top).
namespace tf32 {

// dK/dV block: as tc::DkvTiles, over f32 tiles. Each step's Q and dO are
// staged in turn (not the next step's while this one runs: that room
// holds their lo parts, split once as they are staged rather than by
// each warp at each of its two reads).
template <int D_, int BKV_, int BQ_, int DSPLIT_>
struct DkvTiles {
  static constexpr int D = D_, BKV = BKV_, BQ = BQ_, DSPLIT = DSPLIT_;
  static constexpr int WARPS = BKV / 16 * DSPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 4;  // row stride (floats)
  static constexpr int DW = D / DSPLIT;
  // K, V; Q, dO and their lo planes; lse and di.
  static constexpr size_t smem =
      sizeof(float) * ((2 * BKV + 4 * BQ) * LD + 2 * BQ);
  static_assert(smem <= 232448, "over the card's 227 KB a block");
  static_assert(BQ % 16 == 0, "q rows a step come in pairs of n-tiles");
  static_assert(LD % 32 == 4, "fragment reads of 8 rows meet 32 banks");
};

// dQ block: as tc::DqTiles, over f32 tiles, each step's K and V staged in
// turn (the room of a second stage buys wider steps).
template <int D_, int BQ_, int BKV_>
struct DqTiles {
  static constexpr int D = D_, BQ = BQ_, BKV = BKV_;
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 4;
  // Q, dO; K and V.
  static constexpr size_t smem = sizeof(float) * (2 * BQ + 2 * BKV) * LD;
  static_assert(smem <= 232448, "over the card's 227 KB a block");
  static_assert(BKV % 16 == 0, "kv rows a step come in pairs of n-tiles");
  static_assert(LD % 32 == 4, "fragment reads of 8 rows meet 32 banks");
};

// The tiles of each head width (see the note at the top of the file).
template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  using Dkv = DkvTiles<64, 64, 16, 1>;
  using Dq = DqTiles<64, 64, 32>;
};
template <>
struct Tiles<128> {
  using Dkv = DkvTiles<128, 64, 16, 1>;
  using Dq = DqTiles<128, 64, 32>;
  // Two blocks an SM (228 KB, 1 KB of it reserved a block).
  static_assert(2 * (Dkv::smem + 1024) <= 233472 &&
                    2 * (Dq::smem + 1024) <= 233472,
                "two blocks an SM at d 128");
};
template <>
struct Tiles<256> {
  using Dkv = DkvTiles<256, 64, 16, 2>;
  using Dq = DqTiles<256, 64, 32>;
};

// dK/dV: tc::flash_bwd_dkv_kernel's walk and products in three-pass
// TF32; P^T and dS^T stay f32.
template <class G>
__global__ void __launch_bounds__(G::THREADS)
    flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int D = G::D, BKV = G::BKV, BQ = G::BQ, DSPLIT = G::DSPLIT;
  constexpr int LD = G::LD, DW = G::DW, NT = G::THREADS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Ks = reinterpret_cast<float*>(tc_smem);  // [BKV][LD]
  float* Vs = Ks + BKV * LD;                     // [BKV][LD]
  float* Qs = Vs + BKV * LD;                     // [BQ][LD]
  float* dOs = Qs + BQ * LD;                     // [BQ][LD]
  uint32_t* Ql = reinterpret_cast<uint32_t*>(dOs + BQ * LD);  // Q's lo
  uint32_t* Ol = Ql + BQ * LD;                                // dO's lo
  float* lse_s = reinterpret_cast<float*>(Ol + BQ * LD);      // [BQ]
  float* di_s = lse_s + BQ;                                   // [BQ]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int k0 = kt * BKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp / DSPLIT * 16;  // the warp's kv rows in the tile
  const int wc = warp % DSPLIT * DW;  // and its dK/dV columns
  const long long qrow = ((long long)b * p.hq + h) * p.sq;
  const float* q = static_cast<const float*>(p.q) + qrow * D;
  const float* dout = static_cast<const float*>(p.dout) + qrow * D;
  const float* lse = p.lse + qrow;
  const float* di = p.di + qrow;
  const long long kvbase = ((long long)b * p.hkv + hk) * p.skv * D;

  load_rows_f32<D, BKV, NT, LD>(Ks, static_cast<const float*>(p.k) + kvbase,
                                k0, p.kv_len);
  load_rows_f32<D, BKV, NT, LD>(Vs, static_cast<const float*>(p.v) + kvbase,
                                k0, p.kv_len);
  cp_async_commit();
  int first, last;  // the q tiles that see this kv tile
  dkv_steps(p, k0, BKV, BQ, first, last);

  auto stage = [&](int qt) {
    const int q0 = qt * BQ;
    load_rows_f32<D, BQ, NT, LD>(Qs, q, q0, p.sq);
    load_rows_f32<D, BQ, NT, LD>(dOs, dout, q0, p.sq);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool ok = q0 + r < p.sq;
      cp_async4(lse_s + r, ok ? lse + q0 + r : lse, ok);
      cp_async4(di_s + r, ok ? di + q0 + r : di, ok);
    }
  };

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int kr0 = k0 + wr + gr;  // the thread's kv rows: kr0, kr0 + 8
  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;

  for (int qt = first; qt <= last; ++qt) {
    stage(qt);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tf32_lo_rows<D, 2 * BQ, NT, LD>(Ql, Qs);  // Q and dO, adjacent
    __syncthreads();
    const int q0 = qt * BQ;

    float s[BQ / 8][4], dp[BQ / 8][4], s_lo[BQ / 8][4], dp_lo[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = dp[j][e] = s_lo[j][e] = dp_lo[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 8) {
      Split<4> ka, va;
      tf32_lda<LD>(ka, Ks, lane, wr, kk);
      tf32_lda<LD>(va, Vs, lane, wr, kk);
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        Split<2> qb[2], ob[2];
        tf32_ldb2<LD>(qb[0], qb[1], Qs, Ql, lane, j * 8, kk);
        tf32_ldb2<LD>(ob[0], ob[1], dOs, Ol, lane, j * 8, kk);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma3(s[j + t], s_lo[j + t], ka, qb[t]);
          mma3(dp[j + t], dp_lo[j + t], va, ob[t]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += s_lo[j][e];
        dp[j][e] += dp_lo[j][e];
      }

    const bool masked = needs_mask(p, q0, BQ, k0, BKV);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * tq + (e & 1);
        const int kl = wr + gr + (e >> 1) * 8;
        p_and_ds<D>(p, b, q0 + ql, k0 + kl, lse_s[ql], di_s[ql], slope,
                    masked, s[j][e], dp[j][e], dOs + ql * LD, Vs + kl * LD);
      }

#pragma unroll
    for (int c = 0; c < BQ / 8; ++c) {
      Split<4> pa, sa;
      tf32_to_a(pa, s[c]);   // P^T
      tf32_to_a(sa, dp[c]);  // dS^T
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
        Split<2> ob, qb;
        tf32_ldb_t<LD>(ob, dOs, Ol, lane, c * 8, wc + n * 8);
        tf32_ldb_t<LD>(qb, Qs, Ql, lane, c * 8, wc + n * 8);
        mma3(dv[n], pa, ob);
        mma3(dk[n], sa, qb);
      }
    }
    __syncthreads();  // the next stage overwrites this step's buffers
  }
  cp_async_wait<0>();

  const long long obase = ((long long)b * p.hq + h) * p.skv * D;
  float* dk_out = static_cast<float*>(p.out1) + obase;
  float* dv_out = static_cast<float*>(p.out2) + obase;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = kr0 + 8 * half;
    if (kr >= p.skv) continue;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      const long long at = (long long)kr * D + wc + n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(dk_out + at) =
          make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<float2*>(dv_out + at) =
          make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// dQ: tc::flash_bwd_dq_kernel's walk and products in three-pass TF32; dS
// stays f32.
template <class G>
__global__ void __launch_bounds__(G::THREADS)
    flash_bwd_dq_kernel(BwdParams p) {
  constexpr int D = G::D, BQ = G::BQ, BKV = G::BKV;
  constexpr int LD = G::LD, NT = G::THREADS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Qs = reinterpret_cast<float*>(tc_smem);  // [BQ][LD]
  float* dOs = Qs + BQ * LD;                     // [BQ][LD]
  float* Ks = dOs + BQ * LD;                     // [BKV][LD]
  float* Vs = Ks + BKV * LD;                     // [BKV][LD]

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  const long long qrow = ((long long)b * p.hq + h) * p.sq;
  const long long kvbase = ((long long)b * p.hkv + hk) * p.skv * D;
  const float* k = static_cast<const float*>(p.k) + kvbase;
  const float* v = static_cast<const float*>(p.v) + kvbase;

  load_rows_f32<D, BQ, NT, LD>(Qs, static_cast<const float*>(p.q) + qrow * D,
                               q0, p.sq);
  load_rows_f32<D, BQ, NT, LD>(
      dOs, static_cast<const float*>(p.dout) + qrow * D, q0, p.sq);
  cp_async_commit();
  int first, last;  // the kv tiles this q tile sees
  dq_steps(p, q0, BQ, BKV, first, last);

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

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * BKV;
    load_rows_f32<D, BKV, NT, LD>(Ks, k, k0, p.kv_len);
    load_rows_f32<D, BKV, NT, LD>(Vs, v, k0, p.kv_len);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[BKV / 8][4], dp[BKV / 8][4], s_lo[BKV / 8][4], dp_lo[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = dp[j][e] = s_lo[j][e] = dp_lo[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      Split<4> qa, oa;
      tf32_lda<LD>(qa, Qs, lane, wr, kk);
      tf32_lda<LD>(oa, dOs, lane, wr, kk);
#pragma unroll
      for (int j = 0; j < BKV / 8; j += 2) {
        Split<2> kb[2], vb[2];
        tf32_ldb2<LD>(kb[0], kb[1], Ks, lane, j * 8, kk);
        tf32_ldb2<LD>(vb[0], vb[1], Vs, lane, j * 8, kk);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma3(s[j + t], s_lo[j + t], qa, kb[t]);
          mma3(dp[j + t], dp_lo[j + t], oa, vb[t]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += s_lo[j][e];
        dp[j][e] += dp_lo[j][e];
      }

    const bool masked = needs_mask(p, q0, BQ, k0, BKV);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, kl = j * 8 + 2 * tq + (e & 1);
        p_and_ds<D>(p, b, qr0 + 8 * half, k0 + kl, lse_r[half], di_r[half],
                    slope, masked, s[j][e], dp[j][e],
                    dOs + (wr + gr + 8 * half) * LD, Vs + kl * LD);
      }

#pragma unroll
    for (int c = 0; c < BKV / 8; ++c) {
      Split<4> sa;
      tf32_to_a(sa, dp[c]);  // dS
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        Split<2> kb;
        tf32_ldb_t<LD>(kb, Ks, lane, c * 8, n * 8);
        mma3(dq[n], sa, kb);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* dq_out = static_cast<float*>(p.out1) + qrow * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qr0 + 8 * half;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dq_out + (long long)qi * D + n * 8 +
                                 2 * tq) =
          make_float2(dq[n][2 * half], dq[n][2 * half + 1]);
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

}  // namespace tf32

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

bool served(int dtype, int head_dim) {
  return (dtype == 0 || dtype == 1) &&
         (head_dim == 64 || head_dim == 128 || head_dim == 256);
}

}  // namespace

// dtype: 0 = float32 (three-pass TF32), 1 = bfloat16; q, k, v, dO and the
// outputs share it.
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
    if (head_dim == 64) return tc::tf32::launch_dkv<64>(p, batch, s);
    if (head_dim == 256) return tc::tf32::launch_dkv<256>(p, batch, s);
    return tc::tf32::launch_dkv<128>(p, batch, s);
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
    if (head_dim == 64) return tc::tf32::launch_dq<64>(p, batch, s);
    if (head_dim == 256) return tc::tf32::launch_dq<256>(p, batch, s);
    return tc::tf32::launch_dq<128>(p, batch, s);
  }
  if (head_dim == 64) return tc::launch_dq<64>(p, batch, s);
  if (head_dim == 256) return tc::launch_dq<256>(p, batch, s);
  return tc::launch_dq<128>(p, batch, s);
}
