// prefill_tile.cuh: the order-exact tile shared by paged_prefill.cu (K5),
// ragged_prefill.cu (K6) and flash_fwd.cu's order-exact forward (dense
// K/V: flash_fwd_exact, and flash_fwd in f32), on Hopper's CUDA cores.
//
// A thread block owns R query rows of one (batch row, kv head): the
// q_per_kv query heads of that kv head stacked over `qp = R / q_per_kv`
// chunk positions (GQA folding), so every K/V row a block reads serves all
// of its heads (the forward splits a group wider than R into blocks of
// whole heads). R is ROWS (64) for chunks and ROWS_VERIFY (16) for short
// calls whose 64-row grid would not fill the card (speculative verify: 9
// rows over ~2K history); the wrapper picks.
//
// The order contract. Every element keeps the f32 operation chain of the
// plain version's products on the card: S[r][t] is `fmaf` over d in index
// order from 0 (q scaled and rounded to the q dtype, K rounded to it);
// O[r][c] is `acc *= alpha` once per kv block, then `fmaf(P, V, acc)` over
// the block's kv rows in order. P = exp(S - m) is rounded to the value
// dtype after the TPU block's whole running max, as the TPU kernels round
// it; l sums the unrounded P per 128-column window (64 at d 256) in four
// sequential runs combined as (r0 + r1) + (r2 + r3). The forward (TORCH_L)
// sums each kv block's P in the order of PyTorch's CUDA row sum, which
// its plain version's `p.sum(-1)` takes (torch_row_sum), and so matches
// that l bit for bit. No tensor-core instruction is used: the tensor
// cores sum in an order of their own, and the serving engine's greedy
// tokens are held to the plain version's.
//
// The walk. kv *blocks* come in the TPU kernel's order and widths (K6 and
// the forward: `block_kv` columns; K5: history blocks of pages_per_block *
// page_size tokens, then chunk blocks of block_q rows). A block is cut
// into windows of SW columns; a window no row of the block can see is
// skipped (its P is exactly 0 after a real column, and a row whose whole
// block is masked is wiped by the next block's alpha = 0). A window is cut
// into steps of BK kv rows, staged in a ring of SLOTS shared-memory slots;
// a step no row can see is skipped the same way.
//
// What bounds it: the CUDA cores' f32 FMA rate (67 TFLOP/s on the data
// sheet). What the design does about it:
//  - K and V are staged in the q dtype (bf16: half the bytes of f32) by
//    cp.async, 16 bytes a thread, the next tile in flight while this one
//    computes; values become f32 in registers, which is exact from bf16.
//    Pages of another dtype (int8, int4, fp8 with per-token scales; f32
//    pages under bf16 q) are loaded, dequantized as value * scale in f32
//    and rounded to the q dtype once, synchronously, as they are staged.
//  - Q sits in shared memory as f32, S of one window as f32, K/V as bf16:
//    two blocks of 8 warps fit an SM at d 128 (Geo::SMEM; MIN_BLOCKS is
//    the bound the kernels are compiled for).
//  - A warp owns WR = R / 8 rows, in row groups of LS lanes for scores
//    and LO lanes for outputs (Geo): at d 128 a lane keeps 4 rows x 4
//    columns of a step's scores and 8 rows x 4 output columns in
//    registers; the lanes of a group read the same q and P rows
//    (broadcasts) and different K and V rows. The score loop loads half
//    a 16-byte piece of d for every row and column, then advances all
//    RT x CS chains by one element each, so they interleave. The lane
//    split (16 for scores, 32 for outputs) timed fastest against 16/16
//    and 32/32 (PERF.md); d 64 in bf16 takes 16 output lanes, so that a
//    lane's share of a row stays 8 bytes (OUT_LANES_NARROW).
//  - A block of one live window keeps S in shared memory. A block of
//    several (K5's history blocks of up to 2048 tokens and chunk blocks of
//    256 rows; every d 256 K6 and forward block) writes each window's f32
//    S to a scratch slot in device memory during the max pass and reads it
//    back to form P: 8 bytes of device-memory traffic a score against D
//    FMAs. Restaging K and recomputing S instead costs 1.5x the score work
//    and timed 25-40% slower (PERF.md). The wrapper sizes the scratch for
//    the blocks the card runs at once, not for the grid: a block takes a
//    free slot as it starts and frees it as it ends (take_scratch).
//  - Each row's running max stays in registers (warp shuffles); l sits in
//    shared memory, written by the P pass's threads.
//
// Loaders fetch K/V rows through a per-row source index (-1: a zero row),
// so garbage history columns never reach a sum. Token-packed int4 pages
// hold token j of a page in the low nibble of byte row j and token
// j + ps/2 in the high nibble, both sign-extended; masked scores take
// MASK_VALUE; ALiBi adds slope * (kv_pos - q_pos); sinks join the
// denominator once at the end; a row with l == 0 divides by 1 (lse -inf,
// where the forward asks for lse).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace prefill {

// The tile's geometry (tests/test_torch_prefill_tile.py reads these).
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;          // query rows a block (heads x positions)
constexpr int ROWS_VERIFY = 16;   // the same for short calls
constexpr int WINDOW = 128;       // kv columns a window at d <= 128
constexpr int WINDOW_D256 = 64;   // the same at d 256
constexpr int STEP = 64;          // kv rows a staged step, bf16 q
constexpr int STEP_F32 = 32;      // the same, f32 q
constexpr int SLOTS = 2;          // stages of the K/V ring
constexpr int SCORE_LANES = 16;  // lanes sharing a row group of S (Geo)
constexpr int OUT_LANES = 32;    // lanes sharing an output row group
constexpr int OUT_LANES_NARROW = 16;  // the same where a lane's share of
                                      // an output row would be under 8
                                      // bytes (d 64 in bf16)
constexpr int MAX_WINDOWS = 64;   // windows a kv block (live-mask bits)
constexpr int SMEM_BLOCK = 232448;  // shared memory a block may use (227 KB)
constexpr int SMEM_SM = 233472;     // an SM's, 1 KB of it reserved a block
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr int KK_UNROLL = 4;  // score loop unroll, 8-byte halves
constexpr int PV_UNROLL = 2;  // P V loop unroll, 4 kv rows each

// Parts of the tile a diagnostic build leaves out, one bit each (1 the
// score FMAs, 2 the P V FMAs, 4 the K/V staging, 8 forming P): only
// tools/torch_prefill_sweep.py --parts defines it, to time what each part
// costs. Its outputs are then wrong.
#ifndef PREFILL_OMIT
#define PREFILL_OMIT 0
#endif

// A tile shape: head width D, q dtype TQ, R query rows a block, steps of
// BK kv rows (the product's by dtype; tools/torch_prefill_sweep.py builds
// others). LS lanes share a score row group (a lane holds RT rows x CS
// columns of a step's S) and LO lanes an output row group (RO rows x CO
// columns of O).
template <int D_, typename TQ, int R, int BK_ = sizeof(TQ) == 4 ? STEP_F32
                                                                : STEP>
struct Geo {
  using T = TQ;
  static constexpr int D = D_;
  static constexpr int QB = sizeof(TQ);
  static constexpr int SW = D > 128 ? WINDOW_D256 : WINDOW;
  static constexpr int BK = BK_;
  static constexpr int LS = SCORE_LANES;
  static constexpr int LO =
      (D / OUT_LANES) * QB % 8 == 0 ? OUT_LANES : OUT_LANES_NARROW;
  static constexpr int KE = 16 / QB;       // q elements a 16-byte piece
  static constexpr int QS = D + 4;         // padded row strides: floats,
  static constexpr int SS = SW + 4;        // 16-byte aligned
  static constexpr int KP = D + KE;        // slot rows, elements (16 B pad)
  static constexpr int WR = R / WARPS;     // rows a warp
  static constexpr int RT = WR * LS / 32;  // score rows a lane
  static constexpr int CS = BK / LS;       // score columns a lane and step
  static constexpr int RO = WR * LO / 32;  // output rows a lane
  static constexpr int CO = D / LO;        // output columns a lane
  static constexpr int CW = SW / 4;        // P-pass columns a thread
  // slots, then Qs [R][QS], Ss [R][SS], row_l, row_m, row_pos and
  // row_slope [R].
  static constexpr int SMEM = SLOTS * BK * (D + 16 / QB) * QB +
                              4 * (R * (D + 4) + R * (SW + 4) + 4 * R);
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= SMEM_SM ? 2 : 1;
  static_assert(SMEM <= SMEM_BLOCK, "over the card's 227 KB a block");
  static_assert(R % WARPS == 0 && 4 * R <= THREADS && (4 * R) % 32 == 0,
                "rows a block");
  static_assert(RT >= 1 && RO >= 1 && WR <= 32 && BK % LS == 0 &&
                    D % LO == 0 && (CO * QB) % 8 == 0,
                "lanes a row group");
  static_assert(BK % 32 == 0 && SW % BK == 0, "steps");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// One byte of token-packed int4 pages (two tokens' nibbles).
struct Int4Tokens {
  int8_t bits;
};

template <typename T>
__device__ __forceinline__ float piece_elem(T x, bool) { return to_f(x); }
__device__ __forceinline__ float piece_elem(Int4Tokens x, bool hi) {
  const int b = x.bits;  // sign-extended byte
  return (float)(hi ? (b >> 4) : ((int)((unsigned)b << 28) >> 28));
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

// N elements of T (N * sizeof(T) a multiple of 8 bytes, as aligned) as
// f32: a bf16 is its bits shifted into an f32's high half, exactly.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float (&f)[N]) {
  constexpr int WORDS = N * (int)sizeof(T) / 4;
  uint32_t w[WORDS];
  if constexpr (WORDS % 4 == 0) {
#pragma unroll
    for (int k = 0; k < WORDS / 4; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = u.x, w[4 * k + 1] = u.y, w[4 * k + 2] = u.z,
      w[4 * k + 3] = u.w;
    }
  } else {
    static_assert(WORDS == 2, "8 or 16n bytes");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    if constexpr (sizeof(T) == 4) {
      f[k] = __uint_as_float(w[k]);
    } else {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// What every launch of either kernel shares.
struct RowParams {
  const void* q;       // [b, hq, q_len, d]
  void* o;             // like q
  const float* sinks;  // [hq] or nullptr
  const float* alibi;  // [hq] or nullptr
  float* scratch;      // score scratch (take_scratch), or nullptr
  int slots;           // its slots
  int hq, hkv, g, qp, q_len;
  int nwin;            // windows of the widest kv block
  float scale;         // sm_scale, already rounded to the q dtype
  int window;          // <= 0: none
  float softcap, inv_softcap;  // softcap <= 0: none
  int page_size;       // tokens a page (read by int4 pages only)
};

// Shared memory of one block.
template <typename G, typename TQ>
struct Smem {
  TQ* slots;     // [SLOTS][BK][KP] staged K or V rows
  float* Qs;     // [R][QS] scaled q
  float* Ss;     // [R][SS] a window's scores, then P
  float* row_l;      // [R] running sum
  float* row_m;      // [R] running max (for the P pass)
  int* row_pos;      // [R] chunk position, -1 for an inactive row
  float* row_slope;  // [R] ALiBi slope

  __device__ explicit Smem(unsigned char* base) {
    constexpr int R = G::WR * WARPS;
    slots = reinterpret_cast<TQ*>(base);
    Qs = reinterpret_cast<float*>(base + SLOTS * G::BK * G::KP * G::QB);
    Ss = Qs + R * G::QS;
    row_l = Ss + R * G::SS;
    row_m = row_l + R;
    row_pos = reinterpret_cast<int*>(row_m + R);
    row_slope = reinterpret_cast<float*>(row_pos + R);
  }
  __device__ TQ* slot(int i) const { return slots + i * G::BK * G::KP; }
};

// What a thread keeps across kv blocks: its outputs (O layout), the
// running max of its warp's row `lane` (lanes past WR hold nothing), the
// ring's next slot and what is staged in it ahead of its block.
template <typename G>
struct Thread {
  float acc[G::RO][G::CO];
  float m;
  int slot;
  int ahead;  // the kv block whose first tile is already staged, or -1
};

// Row r of a block: head kvh * g + r / qp at chunk position
// q_first + r % qp; inactive past the chunk or past g * qp rows.
struct Rows {
  int kvh, q_first, g, qp, q_len;
  __device__ int head_in_group(int r) const { return r / qp; }
  __device__ int pos(int r) const { return q_first + r % qp; }
  __device__ bool active(int r) const {
    return r / qp < g && q_first + r % qp < q_len;
  }
};

// What the mask needs of a score row: its chunk position, whether it is
// live, its ALiBi slope (load_q puts them in shared memory).
struct RowInfo {
  int pos;
  bool active;
  float slope;
};

// Q scaled in its own dtype into Qs; the running state cleared.
template <typename G, typename TQ, int D>
__device__ __forceinline__ void load_q(const RowParams& p, const Rows& rows,
                                       const Smem<G, TQ>& sm, Thread<G>& st,
                                       int b) {
  constexpr int R = G::WR * WARPS;
  const TQ* q = static_cast<const TQ*>(p.q);
  const int tid = threadIdx.x;
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (rows.active(r)) {
      const int h = rows.kvh * rows.g + rows.head_in_group(r);
      const long long off =
          (((long long)b * p.hq + h) * p.q_len + rows.pos(r)) * D + c;
      x = round_to<TQ>(to_f(q[off]) * p.scale);
    }
    sm.Qs[r * G::QS + c] = x;
  }
  if (tid < R) {
    const bool on = rows.active(tid);
    sm.row_l[tid] = 0.f;
    sm.row_pos[tid] = on ? rows.pos(tid) : -1;
    sm.row_slope[tid] =
        p.alibi != nullptr && on
            ? p.alibi[rows.kvh * rows.g + rows.head_in_group(tid)]
            : 0.f;
  }
#pragma unroll
  for (int i = 0; i < G::RO; ++i)
#pragma unroll
    for (int c = 0; c < G::CO; ++c) st.acc[i][c] = 0.f;
  st.m = -INFINITY;
  st.slot = 0;
  st.ahead = -1;
}

// 16 bytes of a stored K/V row as f32 (times its scale where scales are
// given). For int4 pages the source row is the token's (page * ps +
// offset), its scale's index; its byte row is (page * ps/2 + offset %
// (ps/2)).
template <int D, typename TK>
__device__ __forceinline__ void load_piece(const TK* base, long long s,
                                           int c0, const float* scale,
                                           int ps, float* out) {
  constexpr int CE = 16 / sizeof(TK);
  const TK* row = base + s * D;
  bool hi = false;
  if constexpr (std::is_same<TK, Int4Tokens>::value) {
    const int half = ps / 2, off = (int)(s % ps);
    hi = off >= half;
    row = base + ((s / ps) * half + off % half) * D;
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(row + c0);
  const TK* vals = reinterpret_cast<const TK*>(&raw);
  const float sc = scale != nullptr ? scale[s] : 1.f;
#pragma unroll
  for (int e = 0; e < CE; ++e) {
    const float x = piece_elem(vals[e], hi);
    out[e] = scale != nullptr ? x * sc : x;
  }
}

// Stage kv rows [t0, t0 + n) of a block into a slot: row t from source
// row src(t) of `base`; rows past n and rows with src -1 are zero. K/V
// stored in the q dtype go by cp.async (the caller waits); other pages
// are dequantized, rounded to the q dtype and stored here.
template <typename G, typename TQ, int D, typename TK, typename Src>
__device__ __forceinline__ void stage(TQ* slot, const TK* base,
                                      const float* scale, int ps, Src src,
                                      int t0, int n) {
  const int tid = threadIdx.x;
  if constexpr ((PREFILL_OMIT & 4) != 0) {
    tc::cp_async_commit();
  } else if constexpr (std::is_same<TK, TQ>::value) {
    constexpr int PR = D / G::KE;  // 16-byte pieces a row
    for (int idx = tid; idx < G::BK * PR; idx += THREADS) {
      const int r = idx / PR, c = (idx % PR) * G::KE;
      const long long s = r < n ? src(t0 + r) : -1LL;
      tc::cp_async16(slot + r * G::KP + c, s >= 0 ? base + s * D + c : base,
                     s >= 0);
    }
    tc::cp_async_commit();
  } else {
    constexpr int CE = 16 / sizeof(TK);  // stored elements a piece
    constexpr int PR = D / CE;
    for (int idx = tid; idx < G::BK * PR; idx += THREADS) {
      const int r = idx / PR, c0 = (idx % PR) * CE;
      const long long s = r < n ? src(t0 + r) : -1LL;
      float x[CE];
      if (s >= 0) {
        load_piece<D>(base, s, c0, scale, ps, x);
      } else {
#pragma unroll
        for (int e = 0; e < CE; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CE; ++e) slot[r * G::KP + c0 + e] = from_f<TQ>(x[e]);
    }
  }
}

// S of one step: Qs times the slot's K rows, softcapped and masked; columns
// past n are -inf (not part of the block). mask(row info, kv_col, s)
// returns the score with ALiBi added, or MASK_VALUE; a step `full`y
// visible to every active row without ALiBi skips it. Stores S at column
// col0 of `dst` (row stride `ld`; nullptr: not stored) and folds it into
// the lane's running max of each of its rows, bm.
template <typename G, typename TQ, int D, typename Mask>
__device__ __forceinline__ void scores(const RowParams& p,
                                       const Smem<G, TQ>& sm, const TQ* k,
                                       int t0, int n, bool full, float* dst,
                                       int ld, int col0, float (&bm)[G::RT],
                                       Mask mask) {
  const int lane = threadIdx.x % 32, sl = lane % G::LS;
  const int row0 = (threadIdx.x / 32) * G::WR + (lane / G::LS) * G::RT;
  float s[G::RT][G::CS];
#pragma unroll
  for (int i = 0; i < G::RT; ++i)
#pragma unroll
    for (int j = 0; j < G::CS; ++j) s[i][j] = 0.f;
  const float* qrows = sm.Qs + row0 * G::QS;
  // Half a 16-byte piece of d at a time: K of every column and q of
  // every row for those elements, then one FMA of every (row, column)
  // chain per element, so the RT x CS chains interleave.
  constexpr int HE = G::KE / 2;
#pragma unroll KK_UNROLL
  for (int kk = 0; kk < ((PREFILL_OMIT & 1) ? 0 : D); kk += HE) {
    float kf[G::CS][HE], qf[G::RT][HE];
#pragma unroll
    for (int j = 0; j < G::CS; ++j)
      load_vals<TQ, HE>(k + (sl + G::LS * j) * G::KP + kk, kf[j]);
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
      load_vals<float, HE>(qrows + i * G::QS + kk, qf[i]);
#pragma unroll
    for (int e = 0; e < HE; ++e)
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int j = 0; j < G::CS; ++j)
          s[i][j] = fmaf(qf[i][e], kf[j][e], s[i][j]);
  }
  const bool plain = full && p.alibi == nullptr;
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int r = row0 + i;
    RowInfo ri{0, true, 0.f};
    if (!plain) {
      ri.pos = sm.row_pos[r];
      ri.active = ri.pos >= 0;
      ri.slope = sm.row_slope[r];
    }
#pragma unroll
    for (int j = 0; j < G::CS; ++j) {
      const int t = sl + G::LS * j;
      float x = s[i][j];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_softcap);
      x = t < n ? (plain ? x : mask(ri, t0 + t, x)) : -INFINITY;
      bm[i] = fmaxf(bm[i], x);
      if (dst != nullptr) dst[r * ld + col0 + t] = x;
    }
  }
}

// torch_row_sum's tree for one of a thread's 8 partials (j): offsets 16
// and 8 across the row's threads, then offset 4 into part 0's b[j % 4].
__device__ __forceinline__ void tree_add(float (&b)[4], int j, float a) {
  a = a + __shfl_xor_sync(0xffffffffu, a, 2);  // offset 16
  a = a + __shfl_xor_sync(0xffffffffu, a, 1);  // offset 8
  const int k = j & 3;
  const float cur = k == 0 ? b[0] : k == 1 ? b[1] : k == 2 ? b[2] : b[3];
  const float v = j < 4 ? a : cur + a;  // offset 4
  if (k == 0) b[0] = v;
  if (k == 1) b[1] = v;
  if (k == 2) b[2] = v;
  if (k == 3) b[3] = v;
}

// TORCH_L: row r's sum of the unrounded P of one kv block of `width`
// columns (1 to 128) in the order of PyTorch's CUDA row sum (its
// Reduce.cuh, checked on the card against torch 2.11): 32 partials, each
// the sequential sum of 4 columns -- neighbours 4t..4t+3 where the row is
// 128 wide (vectorised loads), else t, t+32, t+64, t+96 (narrower widths
// take 2^floor(log2 width) strided partials; the extra zeros here are
// exact) -- then a tree over the partials at halving offsets. P is
// exp(S - m) again, from Ss (`scratch` nullptr: a block of one live
// window) or from the block's scratch; columns of dead steps (bits of
// `live`, one a step across the block) and past the block are 0. A row's
// four threads (part 0..3) each take partials 8 part .. 8 part + 7; the
// sum is part 0's.
template <typename G, typename TQ>
__device__ __forceinline__ float torch_row_sum(const Smem<G, TQ>& sm,
                                               const float* scratch, int r,
                                               int part, float m, int width,
                                               unsigned live) {
  constexpr int R = G::WR * WARPS, SW = G::SW;
  const int ct = width >= 128 ? 4 : 1, ci = width >= 128 ? 1 : 32;
  float b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    const int t = 8 * part + j;
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = t * ct + i * ci;
      float x = 0.f;
      if (c < width && (live >> (c / G::BK)) & 1u) {
        const float sc = scratch != nullptr
                             ? scratch[(long long)(c / SW) * R * SW +
                                       r * SW + c % SW]
                             : sm.Ss[r * G::SS + c % SW];
        x = expf(sc - m);
      }
      a = i == 0 ? x : a + x;
    }
    tree_add(b, j, a);
  }
  return (b[0] + b[2]) + (b[1] + b[3]);
}

// P = exp(S - m) of a window's live steps (bits of `steps`) into Ss
// rounded to TQ (the value dtype), l += sum(P) unrounded: four threads a
// row, each a sequential run of CW columns (inside one step), combined
// (r0 + r1) + (r2 + r3); a dead step's run adds its exact 0. S comes from
// Ss (`from` nullptr) or from the block's scratch. TORCH_L: l takes the
// whole kv block's sum in PyTorch's order once: a full block of one window
// in the same pass (its threads' float4 chunks are the order's partials),
// any other at its first live window (`first`), by torch_row_sum over
// `width` columns of steps `live` (S from `scratch` where the block spans
// windows), before P overwrites S.
template <typename G, typename TQ, bool TORCH_L = false>
__device__ __forceinline__ void softmax_p(const Smem<G, TQ>& sm,
                                          const float* from,
                                          unsigned steps, bool first,
                                          const float* scratch, int width,
                                          unsigned live) {
  constexpr int R = G::WR * WARPS;
  const int tid = threadIdx.x;
  if (tid >= 4 * R) return;
  const int r = tid / 4, part = tid % 4;
  const float m = sm.row_m[r];
  const float* srow = from != nullptr ? from + r * G::SW : sm.Ss + r * G::SS;
  float* prow = sm.Ss + r * G::SS;
  const int c0 = part * G::CW;
  const bool on = (PREFILL_OMIT & 8) == 0 && (steps >> (c0 / G::BK)) & 1u;
  if constexpr (TORCH_L) {
    if constexpr (G::CW == 32) {
      // A full block of one window: the thread's 8 float4 chunks are its
      // partials t = 8 part + j in order, so P and l come in one pass.
      if (width >= 128) {
        float b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = 0.f;
          if (on) {
            const int c = c0 + 4 * j;
            const float4 x = *reinterpret_cast<const float4*>(srow + c);
            const float p0 = expf(x.x - m), p1 = expf(x.y - m);
            const float p2 = expf(x.z - m), p3 = expf(x.w - m);
            a = ((p0 + p1) + p2) + p3;
            *reinterpret_cast<float4*>(prow + c) =
                make_float4(round_to<TQ>(p0), round_to<TQ>(p1),
                            round_to<TQ>(p2), round_to<TQ>(p3));
          }
          tree_add(b, j, a);
        }
        if (part == 0) sm.row_l[r] += (b[0] + b[2]) + (b[1] + b[3]);
        return;
      }
    }
    if (first) {
      const float l = torch_row_sum(sm, scratch, r, part, m, width, live);
      if (part == 0) sm.row_l[r] += l;
    }
    __syncwarp();  // the row's S is read before P overwrites it
  }
  const int c1 = on ? c0 + G::CW : c0;
  float lsum = 0.f;
  for (int c = c0; c < c1; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(srow + c);
    const float p0 = expf(x.x - m), p1 = expf(x.y - m);
    const float p2 = expf(x.z - m), p3 = expf(x.w - m);
    lsum += p0;
    lsum += p1;
    lsum += p2;
    lsum += p3;
    *reinterpret_cast<float4*>(prow + c) =
        make_float4(round_to<TQ>(p0), round_to<TQ>(p1), round_to<TQ>(p2),
                    round_to<TQ>(p3));
  }
  if constexpr (!TORCH_L) {
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    if (part == 0) sm.row_l[r] += lsum;
  }
}

// acc += P V over one step: the slot's V rows against Ss columns
// [col0, col0 + BK).
template <typename G, typename TQ>
__device__ __forceinline__ void accumulate(const Smem<G, TQ>& sm,
                                           const TQ* v, int col0,
                                           Thread<G>& st) {
  const int lane = threadIdx.x % 32, ol = lane % G::LO;
  const int row0 = (threadIdx.x / 32) * G::WR + (lane / G::LO) * G::RO;
  const float* prows = sm.Ss + row0 * G::SS + col0;
#pragma unroll PV_UNROLL
  for (int t = 0; t < ((PREFILL_OMIT & 2) ? 0 : G::BK); t += 4) {
    float vf[4][G::CO];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      load_vals<TQ, G::CO>(v + (t + u) * G::KP + ol * G::CO, vf[u]);
#pragma unroll
    for (int i = 0; i < G::RO; ++i) {
      const float4 pq = *reinterpret_cast<const float4*>(prows + i * G::SS + t);
      const float pu[4] = {pq.x, pq.y, pq.z, pq.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < G::CO; ++c)
          st.acc[i][c] = fmaf(pu[u], vf[u][c], st.acc[i][c]);
    }
  }
}

// One online-softmax step over the kv block [blk0, blk0 + width).
// live(j0, j1): some column of [j0, j1) is visible to some row; full(j0,
// j1): every column of it to every active row. `scratch`
// is this block's slot of nwin * R * SW floats (nullptr where no block is
// wider than one window). `next` is the start of the walk's
// next block of the same width and sources (-1: none), whose first tile
// is staged while this block's last one computes (when it is the first
// step of that block's window 0).
//
// The tiles it stages, in order, through the ring: the K steps of every
// live window (pass 1: S and the block's row max), then per live window
// its V steps (pass 2: P and P V). Each acquire waits for its tile and
// starts the next into the other slot. TORCH_L: l takes each block's sum
// in PyTorch's row-sum order (softmax_p).
template <typename G, typename TQ, int D, bool TORCH_L = false, typename TK,
          typename Src, typename Live, typename Full, typename Mask>
__device__ __forceinline__ void attend_block(
    const RowParams& p, const Smem<G, TQ>& sm, Thread<G>& st,
    float* scratch, int blk0, int width, const TK* kbase, const TK* vbase,
    const float* kscale, const float* vscale, Src src, Live live, Full full,
    Mask mask, int next) {
  constexpr int R = G::WR * WARPS, SW = G::SW, BK = G::BK;
  const int nwin = (width + SW - 1) / SW;
  // Live steps of window w of the block at b0, one bit each (a step no
  // row can see is skipped as a window is).
  auto steps_at = [&](int b0, int w) {
    unsigned m = 0;
    const int t0 = b0 + w * SW, end = min(SW, width - w * SW);
    for (int s = 0; s * BK < end; ++s)
      if (live(t0 + s * BK, t0 + min(s * BK + BK, end))) m |= 1u << s;
    return m;
  };
  auto steps = [&](int w) { return steps_at(blk0, w); };
  auto first_step = [&](int w) { return __ffs(steps(w)) - 1; };
  // Live windows: those with a live step (live() may pass a range that
  // straddles two regions while none of its steps is live).
  uint64_t lv = 0;
  for (int w = 0; w < nwin; ++w)
    if (steps(w)) lv |= 1ull << w;
  const bool staged = st.ahead == blk0;
  st.ahead = -1;
  if (lv == 0) return;
  const bool multi = (lv & (lv - 1)) != 0;
  const int first = __ffsll((long long)lv) - 1;
  auto next_live = [&](int w) {
    const uint64_t rest = lv & ~((2ull << w) - 1ull);
    return rest ? __ffsll((long long)rest) - 1 : -1;
  };

  // The ring: `pend` is the tile staged into slot st.slot, not yet taken.
  struct Tile {
    int pass, w, s;
    bool v;
  };
  Tile pend{0, first, first_step(first), false};
  auto advance = [&](Tile& t) {
    const unsigned later = steps(t.w) >> (t.s + 1);
    if (later) {
      t.s += __ffs(later);
      return true;
    }
    const int nw = next_live(t.w);
    if (t.pass == 0) {
      if (nw >= 0) {
        t.w = nw;
      } else {
        t.pass = 1, t.w = first, t.v = true;
      }
    } else if (nw < 0) {
      return false;
    } else {
      t.w = nw;
    }
    t.s = first_step(t.w);
    return true;
  };
  auto start = [&](int b0, const Tile& t, int slot) {
    const int t0 = b0 + t.w * SW + t.s * BK;
    const int n = min(BK, b0 + width - t0);
    if (t.v)
      stage<G, TQ, D>(sm.slot(slot), vbase, vscale, p.page_size, src, t0, n);
    else
      stage<G, TQ, D>(sm.slot(slot), kbase, kscale, p.page_size, src, t0, n);
  };
  auto acquire = [&]() {
    tc::cp_async_wait<0>();
    __syncthreads();
    const TQ* here = sm.slot(st.slot);
    st.slot ^= 1;
    if (advance(pend)) {
      start(blk0, pend, st.slot);
    } else if (next >= 0) {
      // This block's last tile: stage the next block's first K step behind
      // it, when that block's walk starts in its window 0.
      const unsigned m = steps_at(next, 0);
      if (m) {
        start(next, Tile{0, 0, __ffs(m) - 1, false}, st.slot);
        st.ahead = next;
      }
    }
    return here;
  };
  if (!staged) start(blk0, pend, st.slot);

  // Pass 1: S of every live window, and the block's row max.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float bm[G::RT];  // the lane's part of its rows' block max
#pragma unroll
  for (int i = 0; i < G::RT; ++i) bm[i] = -INFINITY;
  for (int w = first; w >= 0; w = next_live(w)) {
    float* dst = multi ? scratch + (long long)w * R * SW : sm.Ss;
    const int ld = multi ? SW : G::SS;
    for (unsigned ms = steps(w); ms; ms &= ms - 1) {
      const int s = __ffs(ms) - 1;
      const TQ* k = acquire();
      const int t0 = blk0 + w * SW + s * BK;
      const int n = min(BK, blk0 + width - t0);
      scores<G, TQ, D>(p, sm, k, t0, n, full(t0, t0 + n), dst, ld, s * BK,
                       bm, mask);
    }
  }
  {
    // Each row's max over its score group's lanes, into lane (row in
    // warp) of the warp.
    float b = -INFINITY;
    const int from = ((lane % G::WR) / G::RT) * G::LS;
#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      float x = bm[i];
#pragma unroll
      for (int o = G::LS / 2; o >= 1; o /= 2)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
      x = __shfl_sync(0xffffffffu, x, from);
      if (lane % G::RT == i) b = x;
    }
    const float m_next = fmaxf(st.m, b);
    const float alpha = expf(st.m - m_next);
    st.m = m_next;
    if (lane < G::WR) {
      sm.row_m[warp * G::WR + lane] = m_next;
      sm.row_l[warp * G::WR + lane] *= alpha;
    }
    const int orow = (lane / G::LO) * G::RO;  // the lane's first O row
#pragma unroll
    for (int i = 0; i < G::RO; ++i) {
      const float a = __shfl_sync(0xffffffffu, alpha, orow + i);
#pragma unroll
      for (int c = 0; c < G::CO; ++c) st.acc[i][c] *= a;
    }
  }

  // Pass 2: P of each live window with the block's max, then P V.
  unsigned block_live = 0;  // TORCH_L: live steps across the block
  if constexpr (TORCH_L)
    for (int w = first; w >= 0; w = next_live(w))
      block_live |= steps(w) << (w * (SW / BK));
  for (int w = first; w >= 0; w = next_live(w)) {
    const unsigned live_steps = steps(w);
    __syncthreads();  // S in Ss, row_m and row_l written; last P V done
    softmax_p<G, TQ, TORCH_L>(
        sm, multi ? scratch + (long long)w * R * SW : nullptr, live_steps,
        w == first, multi ? scratch : nullptr, width, block_live);
    for (unsigned ms = live_steps; ms; ms &= ms - 1) {
      const int s = __ffs(ms) - 1;
      const TQ* v = acquire();
      accumulate<G, TQ>(sm, v, s * BK, st);
    }
  }
}

// The final scale of a row's O and its lse, from its running max m and sum
// l (the sink logit of head h folded in once). TORCH_L: the sink's sum
// l * scale_m + exp(sk - m2) in two roundings, as the plain version's two
// torch ops (else nvcc contracts it into an FMA).
template <bool TORCH_L = false>
__device__ __forceinline__ void finish_row(const float* sinks, int h,
                                           float m, float l, float& mult,
                                           float& lse) {
  if (sinks != nullptr) {
    const float sk = sinks[h];
    const float m2 = fmaxf(m, sk);
    const float scale_m = expf(m - m2);
    const float l_tot =
        TORCH_L ? __fadd_rn(__fmul_rn(l, scale_m), expf(sk - m2))
                : l * scale_m + expf(sk - m2);
    mult = scale_m / l_tot;
    lse = m2 + logf(l_tot);
  } else {
    mult = (l == 0.f) ? 1.f : 1.f / l;
    lse = (m == -INFINITY) ? -INFINITY : m + logf(l);
  }
}

// Deferred normalisation (the sink logit folded in once; TORCH_L as
// finish_row) and the store; each row's lse into `lse` [b, hq, q_len]
// where it is given.
template <typename G, typename TQ, int D, bool TORCH_L = false>
__device__ __forceinline__ void store_rows(const RowParams& p,
                                           const Rows& rows,
                                           const Smem<G, TQ>& sm,
                                           const Thread<G>& st, int b,
                                           float* lse = nullptr) {
  __syncthreads();
  const int lane = threadIdx.x % 32, ol = lane % G::LO;
  const int orow = (lane / G::LO) * G::RO;  // in the warp
  TQ* o = static_cast<TQ*>(p.o);
#pragma unroll
  for (int i = 0; i < G::RO; ++i) {
    const int r = (threadIdx.x / 32) * G::WR + orow + i;
    const float m = __shfl_sync(0xffffffffu, st.m, orow + i);
    const float l = sm.row_l[r];
    if (!rows.active(r)) continue;
    const int h = rows.kvh * rows.g + rows.head_in_group(r);
    float mult, row_lse;
    finish_row<TORCH_L>(p.sinks, h, m, l, mult, row_lse);
    const long long row = ((long long)b * p.hq + h) * p.q_len + rows.pos(r);
#pragma unroll
    for (int c = 0; c < G::CO; ++c)
      o[row * D + ol * G::CO + c] = from_f<TQ>(st.acc[i][c] * mult);
    if (lse != nullptr && ol == 0) lse[row] = row_lse;
  }
}

// The score scratch: `slots` flag words (padded to 16 bytes), then
// `slots` slots of nwin * R * SW floats.
inline __host__ __device__ long long flag_floats(int slots) {
  return (slots + 3) / 4 * 4;
}

// The block's slot of the score scratch (nullptr where no kv block is
// wider than one window): the first free one from a start that differs
// by SM. Only a running block holds a slot, and it waits for nothing
// until it frees it (give_scratch), so a block spinning here waits only
// for running blocks to end, however few the slots.
template <typename G>
__device__ float* take_scratch(const RowParams& p) {
  if (p.scratch == nullptr) return nullptr;
  __shared__ int taken;
  if (threadIdx.x == 0) {
    int* flags = reinterpret_cast<int*>(p.scratch);
    unsigned sm_id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_id));
    int i = (int)(sm_id * G::MIN_BLOCKS % (unsigned)p.slots);
    while (atomicCAS(flags + i, 0, 1) != 0) {
      i = i + 1 == p.slots ? 0 : i + 1;
      __nanosleep(64);
    }
    __threadfence();
    taken = i;
  }
  __syncthreads();
  return p.scratch + flag_floats(p.slots) +
         (long long)taken * p.nwin * (G::WR * WARPS) * G::SW;
}

// Free the block's slot (`scratch`, from take_scratch) once every thread
// is done with it.
template <typename G>
__device__ void give_scratch(const RowParams& p, const float* scratch) {
  if (scratch == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long at = scratch - (p.scratch + flag_floats(p.slots));
    const int slot =
        (int)(at / ((long long)p.nwin * (G::WR * WARPS) * G::SW));
    __threadfence();
    atomicExch(reinterpret_cast<int*>(p.scratch) + slot, 0);
  }
}

// Host side: whether a launch whose widest kv block is `widest` columns
// has what it needs (a kv block of several windows needs a scratch of at
// least one slot); sets p.nwin. Returns 0 or a CUDA error code.
template <typename G>
inline int check_scratch(RowParams& p, int widest, long long scratch_floats) {
  p.nwin = (widest + G::SW - 1) / G::SW;
  if (p.nwin > MAX_WINDOWS) return (int)cudaErrorInvalidValue;
  if (p.nwin > 1) {
    const long long need =
        flag_floats(p.slots) +
        (long long)p.slots * p.nwin * (G::WR * WARPS) * G::SW;
    if (p.scratch == nullptr || p.slots < 1 || scratch_floats < need)
      return (int)cudaErrorInvalidValue;
  } else {
    p.scratch = nullptr;
  }
  return 0;
}

}  // namespace prefill
