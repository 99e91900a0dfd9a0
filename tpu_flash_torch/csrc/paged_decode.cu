// paged_decode: single-token GQA decode over a paged KV cache, for Hopper
// (sm_90a), every page tier.
//
// Replaces the Pallas TPU kernel _paged_attn_kernel
// (tpu_flash/ops/decode/paged.py:122) together with its _MultiPageCopy
// page walk (:50): the TPU kernel DMAs the pages of each kv block into
// VMEM by hand; here the thread blocks of one cluster walk the page table
// themselves and stream the live page rows through shared memory.
//
// Computes, per (batch row, kv head) -- all q_per_kv query rows of that
// kv head -- the TPU kernel's arithmetic:
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
//     d / 32 channel groups of 32): score = sum over g in order of
//     (bf16(q'_g) . k4_g) * s_g + sum(q'_g) * z_g; PV channel c of group
//     g = bf16(p * s_g) . v4_c + sum(p * z_g).
//   Rounding is half to even (rintf, and the e4m3 conversion's RNE), as
//   jnp.round and astype; divisions are IEEE (no fast math).
// Every dot and sum is order-free: integer products sum in int32 (the
// mxu tiers' dots, by dp4a for the scores), the others' products (exact
// in f64: f32 times a bf16/f32/e4m3/integer value) in f64, rounded to f32
// once; every other f32 step rounds on its own (__fmul_rn/__fadd_rn, no
// FMA contraction) in the order the plain version takes. So the kernel
// gives the plain version's output bit for bit whatever the split (f64
// sums of bf16, e4m3 and integer products are exact; of f32 products
// they round some 2^-29 of an f32 ulp apart). A summation-order ulp would
// otherwise flip e4m3 and int8 roundings downstream and reach greedy
// tokens.
//
// What bounds it on this card: bytes. Decode reads every live K/V byte
// once per step and does ~2 operations per byte per query row, far below
// the ~295 FLOP/byte ridge, so the bound is HBM at 3.35 TB/s. The design:
//   * Only live tokens are read: a kv block's tokens at or past the page
//     limit, or before the window, score DEFAULT_MASK_VALUE in the plain
//     version, so p = exp(MASK - m) = 0 exactly and they add nothing to
//     l, to any sum or to the mxu P scale (a max over values >= 0). The
//     one exception is a kv block with no live token at all (the ring
//     with L <= W): there the plain version runs p = 1 on every token and
//     the ring's alpha = exp(MASK - m_ring) = 0 then wipes that state;
//     the kernel sets the state it leaves (m = MASK, l = bk) directly.
//   * One thread-block cluster per (batch row, kv head), `slices` blocks
//     wide: each kv block's live tokens are cut into `slices` contiguous
//     runs, one a block, so b * hkv * slices blocks stream pages at once
//     (512 at b 8 x 8 kv heads, 8 slices). The blocks of a cluster swap
//     their row maxima (then, for the mxu and fp8-native tiers, their P
//     maxima) and their partial sums through distributed shared memory
//     between cluster barriers; each partial (int32, or f64) is summed
//     over the slices in rank order, so no floating-point atomic decides
//     a bit. Block j's state update (m_next, alpha, l = l * alpha +
//     sum(p), acc = acc * alpha + pv(p)) is replayed in the plain
//     version's f32 order, each block owning 1/slices of the G x d
//     accumulator. The ring joins the last kv block's round (its m_next
//     follows the block's), so a serving call is one round of three
//     cluster barriers (two where P takes no quantization scale).
//   * K and V rows go by cp.async, 16 bytes a thread, into a ring of
//     STAGES 32-token stages (scales and int4g32's group rows with
//     them), the next stages in flight while one is computed. V's first
//     stages load while the cluster swaps maxima. The page ids of a
//     block's run are read into shared memory once a round. Scores take
//     8 lanes a token (dp4a for the mxu tiers); P V takes, for every q
//     row of the group, a quad of columns by dp4a over quads of tokens
//     (int8 P; the byte transpose by __byte_perm) for the mxu tiers, a
//     pair of columns in f64 for the others; the softmax and the P
//     quantization take one thread a token.
//
// Head widths: d = 128 and d = 256, each its own template instance.
//
// Layout: q/o [b, hq, d]; pages [hkv, num_pages, rows, d] with rows = ps
// (ps / 2 for int4 and int4g32); scales f32 [hkv, num_pages, ps], or
// [hkv, num_pages, 2 d / 32, ps] for int4g32 (d / 32 scale rows, then as
// many zero rows);
// lengths int32 [b]; page_indices int32 [b, pps]; ring [b, hkv, W, d]
// bf16; m/l out f32 [b, hq]; all contiguous, pages 16-byte aligned.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace cg = cooperative_groups;

// Parts of the kernel a timing build leaves out (tools/torch_decode_sweep.py
// --parts; outputs then wrong): 1 the score dots, 2 the P V products, 4 the
// K/V staging copies, 8 the softmax and P quantization. 0 in the product.
#ifndef DECODE_OMIT
#define DECODE_OMIT 0
#endif
// Staged tiles in the cp.async ring (2..4); the sweep builds the others.
#ifndef DECODE_STAGES
#define DECODE_STAGES 3
#endif

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;      // q heads per kv head
constexpr int MAX_SLICES = 8;  // the portable cluster size
constexpr int STAGES = DECODE_STAGES;
static_assert(STAGES >= 2 && STAGES <= 4, "DECODE_STAGES: 2..4");
constexpr int STAGE_TOKENS = 32;  // tokens a staged K or V tile
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

// Bytes of one stored row (a packed byte row holds two tokens) and f32
// scale words of one token.
template <int T, int D>
__host__ __device__ constexpr int row_bytes() {
  return Tr<T>::packed ? D : D * (int)sizeof(typename Store<T>::type);
}
template <int T, int D>
__host__ __device__ constexpr int scale_words() {
  return Tr<T>::group ? 2 * (D / 32) : (Tr<T>::token_scaled ? 1 : 0);
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

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
// The integer value of stored element x of an mxu tier.
template <int T>
__device__ __forceinline__ int ielem(int8_t x, bool hi) {
  const int b = static_cast<int>(x);
  if constexpr (Tr<T>::packed) {
    return hi ? (b >> 4) : ((int)((unsigned)b << 28) >> 28);
  } else {
    return b;
  }
}
// Four int8 elements of an mxu tier from one word of a row: int8 as
// stored, int4 nibbles sign-extended into bytes.
template <int T>
__device__ __forceinline__ int int8x4(uint32_t w, bool hi) {
  if constexpr (Tr<T>::packed) {
    const uint32_t n = (hi ? (w >> 4) : w) & 0x0F0F0F0Fu;
    return (int)__vsub4(n ^ 0x08080808u, 0x08080808u);
  } else {
    return (int)w;
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

// The cluster of one (batch row, kv head): its barrier (every thread of
// every block; orders shared-memory writes before it for the others) and
// another block's copy of a shared array.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }
template <typename T>
__device__ __forceinline__ T* remote(T* local, int rank) {
  return cg::this_cluster().map_shared_rank(local, rank);
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
  int slices;              // thread blocks a (batch row, kv head): cluster
  int tcap, rcap;          // page / ring tokens one block takes a round
};

// One side's pages of one kv head: where token `pos` of a sequence lives.
// Page ids come from `table`, the block's shared copy of its batch row's
// page table.
template <int T, int D>
struct Pages {
  static constexpr bool PAGED = true;
  static constexpr int NG = D / 32;
  static constexpr int ROW = row_bytes<T, D>();
  static constexpr int SW = scale_words<T, D>();
  const char* base;     // this head's pages
  const float* scales;  // this head's scales (nullptr: none)
  const int* table = nullptr;
  int ps;

  __device__ Pages(const void* all_pages, const float* all_scales, int h,
                   const DecodeParams& p)
      : ps(p.ps) {
    const long long rows = Tr<T>::packed ? p.ps / 2 : p.ps;
    base = static_cast<const char*>(all_pages) +
           (long long)h * p.num_pages * rows * ROW;
    const long long srows = Tr<T>::group ? 2 * NG : 1;
    scales = all_scales != nullptr
                 ? all_scales + (long long)h * p.num_pages * srows * p.ps
                 : nullptr;
  }
  // The stored row of the token at offset `off` of the table's page pi.
  __device__ __forceinline__ const char* row(int pi, int off) const {
    const long long page = table[pi];
    if constexpr (Tr<T>::packed) {
      const int half = ps / 2;
      return base + (page * half + (off < half ? off : off - half)) * ROW;
    } else {
      return base + (page * ps + off) * ROW;
    }
  }
  // Its scale word j: the per-token scale (j = 0), or row j of int4g32's
  // (scale, zero) rows.
  __device__ __forceinline__ const float* scale_word(int pi, int off,
                                                     int j) const {
    const long long page = table[pi];
    return scales + (page * (Tr<T>::group ? 2 * NG : 1) + j) * ps + off;
  }
};

// The exact recent ring of one (batch row, kv head): bf16 rows by slot.
template <int D>
struct RingRows {
  static constexpr bool PAGED = false;
  static constexpr int ROW = 2 * D;
  static constexpr int SW = 0;
  const char* base;
  __device__ __forceinline__ const char* row(int, int j) const {
    return base + (long long)j * ROW;
  }
  __device__ __forceinline__ const float* scale_word(int, int, int) const {
    return nullptr;
  }
};

// P V thread shapes. The mxu tiers: one thread a quad of columns and a
// quad of tokens at a time (dp4a over the tokens), TGM token quads side
// by side. The others: one thread a pair of columns, TGF tokens side by
// side. Each thread sums every q row of the group.
template <int D> constexpr int TGM = THREADS / (D / 4);
template <int D> constexpr int TGF = THREADS / (D / 2);

// Where element i of a q row sits in the f64 score operand: the scores
// give lane `sub` of 8 the elements (ch * 8 + sub) * CE + [0, CE) of a
// row (CE to a 16-byte piece of K), in pairs; pair e / 2 of piece ch of
// all 8 lanes lies in 128 contiguous bytes, so the lanes' 16-byte loads
// meet no bank twice.
template <int CE>
__host__ __device__ __forceinline__ int qperm(int i) {
  const int e = i % CE, sub = (i / CE) % 8, ch = i / (8 * CE);
  return ((ch * (CE / 2) + e / 2) * 8 + sub) * 2 + (e & 1);
}

// Shared memory of one block, in bytes from the start (every region
// 16-byte aligned). The host sizes the launch with the same function.
struct Layout {
  int ring, stage, srow, red, part, rpart, zred, zpart, xl, qs, acc, qd,
      qrd, q8, sc, pd, vtok, table, hib, rows, total;
};
__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// `tcap` page and `rcap` ring tokens a block at most in one round; `pps`
// page table entries.
template <int KT, int VT, int D>
__host__ __device__ inline Layout layout(int g, int tcap, int rcap,
                                         int pps) {
  constexpr int NG = D / 32;
  Layout o;
  o.srow = cmax(cmax(row_bytes<KT, D>(), row_bytes<VT, D>()), 2 * D);
  const int sw = cmax(scale_words<KT, D>(), scale_words<VT, D>());
  o.stage = STAGE_TOKENS * (o.srow + 4 * sw);
  o.ring = 0;
  o.red = o.ring + align16(STAGES * o.stage);
  // P V partials of the block's thread groups: [TG][g][D], int32 (mxu V)
  // or f64; then the block's sums of them for the pages and the ring,
  // [g][D] in 8-byte slots.
  o.part = o.red + align16(cmax(TGM<D> * 4, TGF<D> * 8) * g * D);
  o.rpart = o.part + align16(g * D * 8);
  o.zred = o.rpart + align16(g * D * 8);
  // int4g32's sum(p z): [TGF][MAX_G][NG] f64, then [MAX_G][NG].
  o.zpart = o.zred + align16(TGF<D> * MAX_G * NG * 8);
  o.xl = o.zpart + align16(MAX_G * NG * 8);
  o.qs = o.xl + align16(2 * MAX_G * 8);  // sum(p) partials; then q'
  o.acc = o.qs + align16(g * D * 4);     // the accumulator (owned entries)
  o.qd = o.acc + align16(g * D * 4);     // the score operand of q' (f64)
  o.qrd = o.qd + align16(g * D * 8);     // bf16(q') for the ring (f64)
  o.q8 = o.qrd + align16(g * D * 8);     // int8 q' (mxu)
  // Scores, then P (f32) [t][g]: the pages' tcap tokens, the ring's rcap.
  o.sc = o.q8 + align16(g * D);
  // The P operand [t][g]: f64, or int8 [g][tcap] (mxu); pages, then ring.
  o.pd = o.sc + align16((tcap + rcap) * g * 4);
  o.vtok = o.pd + align16((tcap + rcap) * g * 8);  // V's token scales
  o.table = o.vtok + align16(tcap * 4);            // the page table row
  o.hib = o.table + align16(pps * 4);  // packed tokens: high nibble
  o.rows = o.hib + align16(tcap / 8);
  // m, l, alpha, m_next, q scale, P scale, max and P max out (pages);
  // then alpha, m_next and max out of the ring: 11 rows; sum(q'_g): MAX_G
  // * NG; warp partials of two rows each: f64 and f32.
  o.total =
      o.rows + align16(4 * (11 * MAX_G + MAX_G * NG) + 24 * WARPS * MAX_G);
  return o;
}

// What every round of one block shares.
struct Ctx {
  const DecodeParams* p;
  int G, C, rank, h, L, eff;
  char* ring;
  int stage, srow;
  void* red;
  void* part;
  void* rpart;
  double* zred;
  double* zpart;
  double* xl;  // [2][MAX_G]: pages, ring
  float* qs;
  float* acc;
  double* qd;
  double* qrd;
  int8_t* q8;
  float* sc;
  double* pd;
  float* vtok;
  int* table;
  uint32_t* hib;
  float *row_m, *row_l, *row_alpha, *row_mnext, *row_qscale, *row_pscale,
      *xmax, *xpmax, *ring_alpha, *ring_mnext, *ring_xmax, *row_qsum;
  double* wred;
  float* wredf;
};

__device__ __forceinline__ bool high(const Ctx& c, int t) {
  return (c.hib[t >> 5] >> (t & 31)) & 1u;
}

// Stages tokens [pos0, pos0 + cnt) of `src` into `slot`: rows of ROW
// bytes at a stride of the layout's widest row, then SW scale words a
// token. `vsc`, if not null, takes V's per-token scales of the same
// tokens (`vs`'s scale word 0).
template <class Src, class VSrc>
__device__ __forceinline__ void load_stage(const Ctx& c, const Src& src,
                                           char* slot, int pos0, int cnt,
                                           const VSrc& vs, float* vsc) {
  constexpr int CPR = Src::ROW / 16;
  if constexpr ((DECODE_OMIT & 4) != 0) return;
  int pi0 = 0, off0 = pos0;
  if constexpr (Src::PAGED) {
    pi0 = pos0 / c.p->ps;
    off0 = pos0 - pi0 * c.p->ps;
  }
  // Token t's page and offset, stepping from the stage's first token.
  auto locate = [&](int t, int& pi, int& off) {
    pi = pi0;
    off = off0 + t;
    if constexpr (Src::PAGED) {
      while (off >= c.p->ps) {
        off -= c.p->ps;
        ++pi;
      }
    }
  };
  for (int i = threadIdx.x; i < cnt * CPR; i += THREADS) {
    const int t = i / CPR, k = i % CPR;
    int pi, off;
    locate(t, pi, off);
    tc::cp_async16(slot + t * c.srow + k * 16, src.row(pi, off) + k * 16,
                   true);
  }
  if constexpr (Src::SW > 0) {
    float* sw = reinterpret_cast<float*>(slot + STAGE_TOKENS * c.srow);
    for (int i = threadIdx.x; i < cnt * Src::SW; i += THREADS) {
      const int t = i / Src::SW, j = i % Src::SW;
      int pi, off;
      locate(t, pi, off);
      tc::cp_async4(sw + i, src.scale_word(pi, off, j), true);
    }
  }
  if (vsc != nullptr) {
    for (int t = threadIdx.x; t < cnt; t += THREADS) {
      int pi, off;
      locate(t, pi, off);
      tc::cp_async4(vsc + t, vs.scale_word(pi, off, 0), true);
    }
  }
}

__device__ __forceinline__ void wait_stages() {
  // Every stage but the newest STAGES - 2 has landed.
  tc::cp_async_wait<STAGES - 2>();
}

// Scores of one staged K tile (tokens [pos0, pos0 + cnt), index t_base +
// t of `sc`): 8 lanes a token, 4 tokens a warp. Each token's G scores go
// to sc; `mloc` keeps the largest a lane wrote.
template <int KT, int D, bool RING>
__device__ __forceinline__ void stage_scores(const Ctx& c, const char* slot,
                                             int pos0, int cnt, int t_base,
                                             float* sc, float (&mloc)[MAX_G]) {
  using KS = typename Store<KT>::type;
  constexpr int NG = D / 32;
  constexpr int SW = RING ? 0 : scale_words<KT, D>();
  const DecodeParams& p = *c.p;
  const int G = c.G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % 8, t = warp * 4 + lane / 8;
  const bool live = t < cnt;
  const bool hi = Tr<KT>::packed && live && high(c, t_base + t);
  const char* row = slot + t * c.srow;
  const float* sw =
      reinterpret_cast<const float*>(slot + STAGE_TOKENS * c.srow) + t * SW;
  // int4g32: a lane's slice is D / 128 pieces of 16 channels, piece c in
  // group c * 4 + sub / 2, so a lane keeps one sum a piece (CG) and a
  // lane pair sums one group; the others sum the whole row.
  constexpr int CG = Tr<KT>::group ? D / 128 : 1;
  double dot[CG][MAX_G];
  int idot[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
    for (int k = 0; k < CG; ++k) dot[k][g] = 0.0;
    idot[g] = 0;
  }
  if constexpr ((DECODE_OMIT & 1) != 0) {
  } else if constexpr (Tr<KT>::mxu) {
    // int8 q' . int8 k, four products a dp4a; 16 elements a 16-byte piece.
#pragma unroll
    for (int ch = 0; ch < D / 128; ++ch) {
      const int e0 = (ch * 8 + sub) * 16;
      const uint4 kr = *reinterpret_cast<const uint4*>(row + e0);
      const int k0 = int8x4<KT>(kr.x, hi), k1 = int8x4<KT>(kr.y, hi);
      const int k2 = int8x4<KT>(kr.z, hi), k3 = int8x4<KT>(kr.w, hi);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const uint4 qw = *reinterpret_cast<const uint4*>(c.q8 + g * D + e0);
          int s = __dp4a((int)qw.x, k0, idot[g]);
          s = __dp4a((int)qw.y, k1, s);
          s = __dp4a((int)qw.z, k2, s);
          idot[g] = __dp4a((int)qw.w, k3, s);
        }
      }
    }
  } else {
    constexpr int CE = 16 / sizeof(KS);  // elements a 16-byte piece
    constexpr int CHUNKS = D / 8 / CE;
    const double* qd = RING ? c.qrd : c.qd;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
      const int e0 = (ch * 8 + sub) * CE;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(row + e0 * sizeof(KS));
      const KS* vals = reinterpret_cast<const KS*>(&raw);
#pragma unroll
      for (int e = 0; e < CE; e += 2) {
        const double k0 = elem<KT>(vals[e], hi);
        const double k1 = elem<KT>(vals[e + 1], hi);
        const int at = ((ch * (CE / 2) + e / 2) * 8 + sub) * 2;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const double2 q2 =
                *reinterpret_cast<const double2*>(qd + g * D + at);
            double& d = dot[Tr<KT>::group ? ch : 0][g];
            d = fma(q2.y, k1, fma(q2.x, k0, d));
          }
        }
      }
    }
  }
  constexpr int OFF0 = Tr<KT>::group ? 2 : 8;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
    for (int o = 1; o < OFF0; o <<= 1) {
      if constexpr (Tr<KT>::mxu) {
        idot[g] += __shfl_xor_sync(0xffffffffu, idot[g], o);
      } else {
#pragma unroll
        for (int k = 0; k < CG; ++k)
          dot[k][g] += __shfl_xor_sync(0xffffffffu, dot[k][g], o);
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
        gdot[g][gi] = __shfl_sync(0xffffffffu, dot[gi / 4][g],
                                  lane0 + 2 * (gi % 4));
  }
  if (!live || sub != 0) return;
  const int pos = pos0 + t;
  float kscale = 1.f;
  if constexpr (Tr<KT>::token_scaled) kscale = sw[0];
  int rel;  // ALiBi's distance to the decoding token
  if constexpr (RING) {
    const int last = c.L - 1;
    rel = -((last - pos) % p.ring_w);  // slot pos holds last - (last-pos)%W
  } else {
    rel = pos - (c.eff - 1);
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    float s;
    if constexpr (Tr<KT>::mxu) {
      s = mul(mul((float)idot[g], c.row_qscale[g]), kscale);
    } else if constexpr (Tr<KT>::native8) {
      s = mul(mul((float)dot[0][g], c.row_qscale[g]), kscale);
    } else if constexpr (Tr<KT>::group) {
      s = 0.f;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
        s = add(add(s, mul((float)gdot[g][gi], sw[gi])),
                mul(c.row_qsum[g * NG + gi], sw[NG + gi]));
    } else if constexpr (Tr<KT>::token_scaled) {
      s = mul((float)dot[0][g], kscale);
    } else {
      s = (float)dot[0][g];
    }
    if (p.softcap > 0.f) s = mul(p.softcap, tanhf(mul(s, p.inv_softcap)));
    if (p.alibi != nullptr)
      s = add(s, mul(p.alibi[c.h * G + g], (float)rel));
    sc[(t_base + t) * G + g] = s;
    mloc[g] = fmaxf(mloc[g], s);
  }
}

// Block reductions of per-thread row values (warps in order; every
// thread calls them): two f32 maxima into ma[g] and mb[g]; two f64 sums
// and one f32 maximum into sa[g], sb[g] and mx[g].
__device__ __forceinline__ void block_max2(const Ctx& c, float (&a)[MAX_G],
                                           float (&b)[MAX_G], float* ma,
                                           float* mb) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // the previous reduction's readers are done
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < c.G) {
      const float x = warp_max(a[g]), y = warp_max(b[g]);
      if (lane == 0) {
        c.wredf[warp * 2 * MAX_G + g] = x;
        c.wredf[warp * 2 * MAX_G + MAX_G + g] = y;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < c.G) {
    float x = -INFINITY, y = -INFINITY;
    for (int w = 0; w < WARPS; ++w) {
      x = fmaxf(x, c.wredf[w * 2 * MAX_G + threadIdx.x]);
      y = fmaxf(y, c.wredf[w * 2 * MAX_G + MAX_G + threadIdx.x]);
    }
    ma[threadIdx.x] = x;
    mb[threadIdx.x] = y;
  }
}
__device__ __forceinline__ void block_sum2_max(const Ctx& c,
                                               double (&a)[MAX_G],
                                               double (&b)[MAX_G],
                                               float (&m)[MAX_G], double* sa,
                                               double* sb, float* mx) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // the previous reduction's readers are done
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < c.G) {
      const double x = warp_sum(a[g]), y = warp_sum(b[g]);
      const float z = warp_max(m[g]);
      if (lane == 0) {
        c.wred[warp * 2 * MAX_G + g] = x;
        c.wred[warp * 2 * MAX_G + MAX_G + g] = y;
        c.wredf[warp * 2 * MAX_G + g] = z;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < c.G) {
    double x = 0.0, y = 0.0;
    float z = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      x += c.wred[w * 2 * MAX_G + threadIdx.x];
      y += c.wred[w * 2 * MAX_G + MAX_G + threadIdx.x];
      z = fmaxf(z, c.wredf[w * 2 * MAX_G + threadIdx.x]);
    }
    sa[threadIdx.x] = x;
    sb[threadIdx.x] = y;
    mx[threadIdx.x] = z;
  }
}

// Four tokens' words of four int8 columns (w[j]: token j) as four
// columns' words of four tokens.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           int (&col)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = (int)__byte_perm(lo01, lo23, 0x5410);
  col[1] = (int)__byte_perm(lo01, lo23, 0x7632);
  col[2] = (int)__byte_perm(hi01, hi23, 0x5410);
  col[3] = (int)__byte_perm(hi01, hi23, 0x7632);
}

// The softmax of one segment's n tokens (scores in sc, this round's
// m_next in mnext): sum(p) and the largest p * v_scale of each row into
// lsum / pmax; P (or, for the mxu, fp8-native and int4g32 V tiers, the
// values they quantize or scale) back into sc or into pd.
template <int VT, bool RING>
__device__ __forceinline__ void softmax_pass(const Ctx& c, int n, float* sc,
                                             double* pd, const float* mnext,
                                             double (&lsum)[MAX_G],
                                             float (&pmax)[MAX_G]) {
  constexpr bool QUANT_P = Tr<VT>::mxu || Tr<VT>::native8;
  const int G = c.G;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    lsum[g] = 0.0;
    pmax[g] = 0.f;
  }
  for (int t = threadIdx.x; t < ((DECODE_OMIT & 8) ? 0 : n); t += THREADS) {
    float vsc = 1.f;
    if constexpr (!RING && Tr<VT>::token_scaled) vsc = c.vtok[t];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        float pp = expf(sc[t * G + g] - mnext[g]);
        lsum[g] += pp;
        if constexpr (VT == kBF16) {
          pp = round_bf16(pp);
        } else if constexpr (Tr<VT>::token_scaled) {
          pp = mul(pp, vsc);
          pmax[g] = fmaxf(pmax[g], pp);
        }
        if constexpr (QUANT_P || Tr<VT>::group)
          sc[t * G + g] = pp;
        else
          pd[t * G + g] = pp;
      }
    }
  }
}

// The P V products of the staged V tiles s in [s0, s1) of the round
// (issue(s) stages tile s; tile s holds the segment's tokens from
// (s - s0) * 32, whose P is in sc / pd) into `part` ([g][D], int32 for
// the mxu tiers, else f64) and, for int4g32, sum(p z) into c.zpart.
template <int VT, int D, class Issue>
__device__ __forceinline__ void pv_pass(const Ctx& c, int s0, int s1, int n,
                                        int nst, const float* sc,
                                        const double* pd, void* part,
                                        Issue issue) {
  using VS = typename Store<VT>::type;
  constexpr int NG = D / 32;
  constexpr int VSW = scale_words<VT, D>();
  const int G = c.G, S = STAGES, tid = threadIdx.x;
  const int tcap = c.p->tcap;
  auto slot = [&](int s) { return c.ring + (s % S) * c.stage; };
  auto count = [&](int s) {
    return min(STAGE_TOKENS, n - (s - s0) * STAGE_TOKENS);
  };
  auto next = [&](int s) {
    wait_stages();
    __syncthreads();
    if (s + S - 1 < nst) issue(s + S - 1);
    tc::cp_async_commit();
  };
  if constexpr (Tr<VT>::mxu) {
    constexpr int CQ = D / 4;
    const int cq = tid % CQ, tq = tid / CQ;
    int ip[MAX_G][4];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
#pragma unroll
      for (int k = 0; k < 4; ++k) ip[g][k] = 0;
    for (int s = s0; s < s1; ++s) {
      next(s);
      const char* sl = slot(s);
      const int cnt = (DECODE_OMIT & 2) ? 0 : count(s);
      const int tb = (s - s0) * STAGE_TOKENS;
      for (int t4 = tq * 4; t4 < cnt; t4 += TGM<D> * 4) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t4 + j;
          w[j] = 0u;
          if (t < cnt) {
            const uint32_t raw =
                *reinterpret_cast<const uint32_t*>(sl + t * c.srow + cq * 4);
            w[j] = (uint32_t)int8x4<VT>(raw,
                                        Tr<VT>::packed && high(c, tb + t));
          }
        }
        int col[4];
        transpose4(w, col);
        const int8_t* p8 = reinterpret_cast<const int8_t*>(pd) + tb + t4;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const int pw = *reinterpret_cast<const int*>(p8 + g * tcap);
#pragma unroll
            for (int k = 0; k < 4; ++k) ip[g][k] = __dp4a(pw, col[k], ip[g][k]);
          }
        }
      }
    }
    int* red = static_cast<int*>(c.red);
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          red[(tq * G + g) * D + cq * 4 + k] = ip[g][k];
    __syncthreads();
    int* out = static_cast<int*>(part);
    for (int i = tid; i < G * D; i += THREADS) {
      int s = 0;
      for (int k = 0; k < TGM<D>; ++k) s += red[k * G * D + i];
      out[2 * i] = s;
    }
  } else {
    constexpr int CP = D / 2;
    const int cp = tid % CP, tq = tid / CP;
    const int gi = (2 * cp) / 32;  // both columns' channel group
    const int zg = cp % 16;        // int4g32: the row whose sum(p z) of
                                   // group gi this thread takes
    double dp[MAX_G][2];
    double zp = 0.0;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) dp[g][0] = dp[g][1] = 0.0;
    for (int s = s0; s < s1; ++s) {
      next(s);
      const char* sl = slot(s);
      const float* sw =
          reinterpret_cast<const float*>(sl + STAGE_TOKENS * c.srow);
      const int cnt = (DECODE_OMIT & 2) ? 0 : count(s);
      const int tb = (s - s0) * STAGE_TOKENS;
      for (int t = tq; t < cnt; t += TGF<D>) {
        const int ti = tb + t;
        const VS* vr = reinterpret_cast<const VS*>(sl + t * c.srow) + 2 * cp;
        const bool nib = Tr<VT>::packed && high(c, ti);
        const double v0 = elem<VT>(vr[0], nib), v1 = elem<VT>(vr[1], nib);
        if constexpr (Tr<VT>::group) {
          const float s_g = sw[t * VSW + gi];
#pragma unroll
          for (int g = 0; g < MAX_G; ++g) {
            if (g < G) {
              const double pg = round_bf16(mul(sc[ti * G + g], s_g));
              dp[g][0] = fma(pg, v0, dp[g][0]);
              dp[g][1] = fma(pg, v1, dp[g][1]);
            }
          }
          if (zg < G)
            zp = fma((double)sc[ti * G + zg], (double)sw[t * VSW + NG + gi],
                     zp);
        } else {
#pragma unroll
          for (int g = 0; g < MAX_G; ++g) {
            if (g < G) {
              const double pv = pd[ti * G + g];
              dp[g][0] = fma(pv, v0, dp[g][0]);
              dp[g][1] = fma(pv, v1, dp[g][1]);
            }
          }
        }
      }
    }
    double* red = static_cast<double*>(c.red);
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) {
        red[(tq * G + g) * D + 2 * cp] = dp[g][0];
        red[(tq * G + g) * D + 2 * cp + 1] = dp[g][1];
      }
    if (Tr<VT>::group && zg < G) c.zred[(tq * MAX_G + zg) * NG + gi] = zp;
    __syncthreads();
    double* out = static_cast<double*>(part);
    for (int i = tid; i < G * D; i += THREADS) {
      double s = 0.0;
      for (int k = 0; k < TGF<D>; ++k) s += red[k * G * D + i];
      out[i] = s;
    }
    if constexpr (Tr<VT>::group) {
      if (tid < G * NG) {
        const int g = tid / NG, k0 = tid % NG;
        double s = 0.0;
        for (int k = 0; k < TGF<D>; ++k) s += c.zred[(k * MAX_G + g) * NG + k0];
        c.zpart[g * NG + k0] = s;
      }
    }
  }
  __syncthreads();  // red is free again
}

// This block's contiguous run of a segment's tokens [lo, hi): the
// segment cut into C runs of whole stages, in rank order.
__device__ __forceinline__ void my_run(const Ctx& c, int lo, int hi, int& a,
                                       int& n) {
  const int per = ((hi - lo + c.C - 1) / c.C + STAGE_TOKENS - 1) /
                  STAGE_TOKENS * STAGE_TOKENS;
  a = min(lo + c.rank * per, hi);
  n = min(per, hi - a);
}

// The plain version's state updates over live tokens [lo, hi) of one kv
// block of the pages, then (rn > 0) over live ring slots [0, rn), in one
// round of three cluster barriers (two without the mxu / fp8-native P
// scale): the cluster's blocks each take a contiguous run of each
// segment; the ring's m_next follows the page block's.
template <int KT, int VT, int D>
__device__ void run_round(const Ctx& c, const Pages<KT, D>& ks,
                          const Pages<VT, D>& vs, const RingRows<D>& rk,
                          const RingRows<D>& rv, int lo, int hi, int rn) {
  constexpr int NG = D / 32;
  constexpr bool QUANT_P = Tr<VT>::mxu || Tr<VT>::native8;
  const DecodeParams& p = *c.p;
  const int G = c.G, S = STAGES, tid = threadIdx.x;
  const bool pages = lo < hi, ring = rn > 0;
  int a = 0, n = 0, ar = 0, nr = 0;
  if (pages) my_run(c, lo, hi, a, n);
  if (ring) my_run(c, 0, rn, ar, nr);
  // Stages [0, nsp) hold page tokens, [nsp, nst) ring slots.
  const int nsp = (n + STAGE_TOKENS - 1) / STAGE_TOKENS;
  const int nst = nsp + (nr + STAGE_TOKENS - 1) / STAGE_TOKENS;
  float* scr = c.sc + p.tcap * G;  // the ring's scores and P
  double* pdr = c.pd + p.tcap * G;
  auto slot = [&](int s) { return c.ring + (s % S) * c.stage; };
  auto issue_k = [&](int s) {
    if (s < nsp) {
      const int t0 = s * STAGE_TOKENS;
      load_stage(c, ks, slot(s), a + t0, min(STAGE_TOKENS, n - t0), vs,
                 Tr<VT>::token_scaled ? c.vtok + t0 : nullptr);
    } else {
      const int t0 = (s - nsp) * STAGE_TOKENS;
      load_stage(c, rk, slot(s), ar + t0, min(STAGE_TOKENS, nr - t0), rk,
                 nullptr);
    }
  };
  auto issue_v = [&](int s) {
    if (s < nsp) {
      const int t0 = s * STAGE_TOKENS;
      load_stage(c, vs, slot(s), a + t0, min(STAGE_TOKENS, n - t0), vs,
                 nullptr);
    } else {
      const int t0 = (s - nsp) * STAGE_TOKENS;
      load_stage(c, rv, slot(s), ar + t0, min(STAGE_TOKENS, nr - t0), rv,
                 nullptr);
    }
  };

  if constexpr (Tr<KT>::packed || Tr<VT>::packed) {
    // Which of the run's page tokens sit in a high nibble.
    const int half = p.ps / 2;
    for (int w = tid; w * 32 < n; w += THREADS) {
      int off = (a + w * 32) % p.ps;
      uint32_t bits = 0u;
      for (int j = 0; j < 32; ++j) {
        if (off >= half) bits |= 1u << j;
        if (++off == p.ps) off = 0;
      }
      c.hib[w] = bits;
    }
    __syncthreads();
  }

  // -- scores, K streamed --------------------------------------------------
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) issue_k(s);
    tc::cp_async_commit();
  }
  float mloc[MAX_G], mlr[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) mloc[g] = mlr[g] = -INFINITY;
  for (int s = 0; s < nst; ++s) {
    wait_stages();
    __syncthreads();
    if (s + S - 1 < nst) issue_k(s + S - 1);
    tc::cp_async_commit();
    if (s < nsp)
      stage_scores<KT, D, false>(c, slot(s), a + s * STAGE_TOKENS,
                                 min(STAGE_TOKENS, n - s * STAGE_TOKENS),
                                 s * STAGE_TOKENS, c.sc, mloc);
    else
      stage_scores<kBF16, D, true>(
          c, slot(s), ar + (s - nsp) * STAGE_TOKENS,
          min(STAGE_TOKENS, nr - (s - nsp) * STAGE_TOKENS),
          (s - nsp) * STAGE_TOKENS, scr, mlr);
  }
  __syncthreads();  // every K tile read: the ring takes V's first tiles
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) issue_v(s);
    tc::cp_async_commit();
  }
  block_max2(c, mloc, mlr, c.xmax, c.ring_xmax);
  cluster_sync();  // every block's row maxima are out

  // -- the kv block's max, alpha; the ring's; P -------------------------------
  if (tid < G) {
    float m = -INFINITY, mr = -INFINITY;
    for (int r = 0; r < c.C; ++r) {
      m = fmaxf(m, remote(c.xmax, r)[tid]);
      mr = fmaxf(mr, remote(c.ring_xmax, r)[tid]);
    }
    float m_prev = c.row_m[tid];
    if (pages) {
      const float m_next = fmaxf(m_prev, m);
      c.row_mnext[tid] = m_next;
      c.row_alpha[tid] = expf(m_prev - m_next);
      m_prev = m_next;
    }
    if (ring) {
      const float m_next = fmaxf(m_prev, mr);
      c.ring_mnext[tid] = m_next;
      c.ring_alpha[tid] = expf(m_prev - m_next);
    }
  }
  __syncthreads();
  double lsum[MAX_G], lsr[MAX_G];
  float pmax[MAX_G], pmr[MAX_G];
  softmax_pass<VT, false>(c, n, c.sc, c.pd, c.row_mnext, lsum, pmax);
  softmax_pass<kBF16, true>(c, nr, scr, pdr, c.ring_mnext, lsr, pmr);
  block_sum2_max(c, lsum, lsr, pmax, c.xl, c.xl + MAX_G, c.xpmax);
  if constexpr (QUANT_P) {
    cluster_sync();  // every block's P maxima are out
    if (tid < G) {
      float m = 0.f;
      for (int r = 0; r < c.C; ++r) m = fmaxf(m, remote(c.xpmax, r)[tid]);
      const float top = Tr<VT>::mxu ? 127.f : 448.f;
      c.row_pscale[tid] = (m == 0.f) ? 1.f : m / top;
    }
    __syncthreads();
    int8_t* p8 = reinterpret_cast<int8_t*>(c.pd);
    for (int i = tid; i < ((DECODE_OMIT & 8) ? 0 : n * G); i += THREADS) {
      const int t = i / G, g = i % G;
      const float x = c.sc[i] / c.row_pscale[g];
      if constexpr (Tr<VT>::mxu)
        p8[g * p.tcap + t] = (int8_t)fminf(fmaxf(rintf(x), 0.f), 127.f);
      else
        c.pd[i] = round_e4m3(x);
    }
  }

  // -- P V partials, V streamed ----------------------------------------------
  pv_pass<VT, D>(c, 0, nsp, n, nst, c.sc, c.pd, c.part, issue_v);
  pv_pass<kBF16, D>(c, nsp, nst, nr, nst, scr, pdr, c.rpart, issue_v);
  cluster_sync();  // every block's partials are out

  // -- the merge: this block's share of the accumulator ---------------------
  const int total = G * D, share = (total + c.C - 1) / c.C;
  for (int i = tid; i < share; i += THREADS) {
    const int idx = c.rank * share + i;
    if (idx >= total) break;
    const int g = idx / D, cc = idx % D;
    float acc = c.acc[idx];
    if (pages) {
      float out;
      if constexpr (Tr<VT>::mxu) {
        int s = 0;
        for (int r = 0; r < c.C; ++r)
          s += remote(static_cast<int*>(c.part), r)[2 * idx];
        out = mul((float)s, c.row_pscale[g]);
      } else {
        double s = 0.0, z = 0.0;
        for (int r = 0; r < c.C; ++r) {
          s += remote(static_cast<double*>(c.part), r)[idx];
          if constexpr (Tr<VT>::group)
            z += remote(c.zpart, r)[g * NG + cc / 32];
        }
        out = (float)s;
        if constexpr (Tr<VT>::native8) out = mul(out, c.row_pscale[g]);
        if constexpr (Tr<VT>::group) out = add(out, (float)z);
      }
      acc = add(mul(acc, c.row_alpha[g]), out);
    }
    if (ring) {
      double s = 0.0;
      for (int r = 0; r < c.C; ++r)
        s += remote(static_cast<double*>(c.rpart), r)[idx];
      acc = add(mul(acc, c.ring_alpha[g]), (float)s);
    }
    c.acc[idx] = acc;
  }
  if (tid < G) {
    double s = 0.0, sr = 0.0;
    for (int r = 0; r < c.C; ++r) {
      const double* x = remote(c.xl, r);
      s += x[tid];
      sr += x[MAX_G + tid];
    }
    float l = c.row_l[tid];
    if (pages) {
      l = add(mul(l, c.row_alpha[tid]), (float)s);
      c.row_m[tid] = c.row_mnext[tid];
    }
    if (ring) {
      l = add(mul(l, c.ring_alpha[tid]), (float)sr);
      c.row_m[tid] = c.ring_mnext[tid];
    }
    c.row_l[tid] = l;
  }
  // The next round's first cluster barrier orders these updates before
  // any read; its K tiles go to ring slots no block reads any more.
  __syncthreads();
}

template <typename TQ, int KT, int VT, int D>
__global__ void __launch_bounds__(THREADS, 2)
paged_decode_kernel(DecodeParams p) {
  constexpr int NG = D / 32;
  extern __shared__ __align__(16) char smem[];
  Ctx c;
  c.p = &p;
  c.G = p.g;
  c.C = p.slices;
  c.rank = (int)cg::this_cluster().block_rank();
  c.h = blockIdx.x / p.slices;
  const int G = c.G, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Layout lay = layout<KT, VT, D>(G, p.tcap, p.rcap, p.pps);
  c.ring = smem + lay.ring;
  c.stage = lay.stage;
  c.srow = lay.srow;
  c.red = smem + lay.red;
  c.part = smem + lay.part;
  c.rpart = smem + lay.rpart;
  c.zred = reinterpret_cast<double*>(smem + lay.zred);
  c.zpart = reinterpret_cast<double*>(smem + lay.zpart);
  c.xl = reinterpret_cast<double*>(smem + lay.xl);
  c.qs = reinterpret_cast<float*>(smem + lay.qs);
  c.acc = reinterpret_cast<float*>(smem + lay.acc);
  c.qd = reinterpret_cast<double*>(smem + lay.qd);
  c.qrd = reinterpret_cast<double*>(smem + lay.qrd);
  c.q8 = reinterpret_cast<int8_t*>(smem + lay.q8);
  c.sc = reinterpret_cast<float*>(smem + lay.sc);
  c.pd = reinterpret_cast<double*>(smem + lay.pd);
  c.vtok = reinterpret_cast<float*>(smem + lay.vtok);
  c.table = reinterpret_cast<int*>(smem + lay.table);
  c.hib = reinterpret_cast<uint32_t*>(smem + lay.hib);
  float* rows = reinterpret_cast<float*>(smem + lay.rows);
  c.row_m = rows;
  c.row_l = rows + MAX_G;
  c.row_alpha = rows + 2 * MAX_G;
  c.row_mnext = rows + 3 * MAX_G;
  c.row_qscale = rows + 4 * MAX_G;
  c.row_pscale = rows + 5 * MAX_G;
  c.xmax = rows + 6 * MAX_G;
  c.xpmax = rows + 7 * MAX_G;
  c.ring_alpha = rows + 8 * MAX_G;
  c.ring_mnext = rows + 9 * MAX_G;
  c.ring_xmax = rows + 10 * MAX_G;
  c.row_qsum = rows + 11 * MAX_G;
  c.wred = reinterpret_cast<double*>(rows + 11 * MAX_G + MAX_G * NG);
  c.wredf = reinterpret_cast<float*>(c.wred + 2 * WARPS * MAX_G);

  const int h = c.h, b = blockIdx.y;
  const TQ* q = static_cast<const TQ*>(p.q) + ((long long)b * p.hq + h * G) * D;
  Pages<KT, D> ks(p.k_pages, p.k_scales, h, p);
  Pages<VT, D> vs(p.v_pages, p.v_scales, h, p);
  ks.table = vs.table = c.table;
  const int* table = p.page_indices + (long long)b * p.pps;
  for (int i = tid; i < p.pps; i += THREADS) c.table[i] = table[i];

  const int L = p.lengths[b];
  c.L = L;
  c.eff = p.ring_w > 0 ? max(L - p.ring_w, 1) : L;
  const int page_limit = p.ring_w > 0 ? max(L - p.ring_w, 0) : L;
  const int num_active = (c.eff + p.bk - 1) / p.bk;
  int first = 0, win_lo = 0;
  if (p.window > 0 && c.eff - p.window > 0) {
    win_lo = c.eff - p.window;
    first = win_lo / p.bk;
  }

  using KS = typename Store<KT>::type;
  constexpr int CE = 16 / sizeof(KS);
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, i = idx % D;
    const float x = mul(to_f(q[idx]), p.scale);
    c.qs[idx] = x;
    c.qd[g * D + qperm<CE>(i)] =
        (KT == kBF16 || KT == kInt4G32) ? round_bf16(x) : x;
    c.qrd[g * D + qperm<8>(i)] = round_bf16(x);
    c.acc[idx] = 0.f;
  }
  // With a ring and L <= W the pages hold no live token, yet the plain
  // version runs its one kv block fully masked: m = MASK, p = 1 on all bk
  // tokens, l = bk. The ring's alpha = exp(MASK - m_ring) = 0 then wipes
  // l and acc, so that state is set here and the block is not read.
  const bool masked_block = p.ring_w > 0 && page_limit == 0;
  if (tid < G) {
    c.row_m[tid] = masked_block ? MASK_VALUE : -INFINITY;
    c.row_l[tid] = masked_block ? (float)p.bk : 0.f;
  }
  __syncthreads();
  if constexpr (Tr<KT>::mxu || Tr<KT>::native8) {
    // Per-row quantization of q': int8 (round half to even, then clip)
    // or e4m3 (RNE).
    for (int g = warp; g < G; g += WARPS) {
      float m = 0.f;
      for (int k = lane; k < D; k += 32) m = fmaxf(m, fabsf(c.qs[g * D + k]));
      m = warp_max(m);
      const float top = Tr<KT>::mxu ? 127.f : 448.f;
      const float qscale = (m == 0.f) ? 1.f : m / top;
      for (int k = lane; k < D; k += 32) {
        const float x = c.qs[g * D + k] / qscale;
        if constexpr (Tr<KT>::mxu)
          c.q8[g * D + k] = (int8_t)fminf(fmaxf(rintf(x), -127.f), 127.f);
        else
          c.qd[g * D + qperm<CE>(k)] = round_e4m3(x);
      }
      if (lane == 0) c.row_qscale[g] = qscale;
    }
  }
  if constexpr (Tr<KT>::group) {
    // sum(q'_g) in f64, rounded to f32 once; one thread per (row, group).
    if (tid < G * NG) {
      const int r = tid / NG, gi = tid % NG;
      double s = 0.0;
      for (int k = 0; k < 32; ++k) s += c.qs[r * D + gi * 32 + k];
      c.row_qsum[tid] = (float)s;
    }
  }
  __syncthreads();

  // The exact recent ring joins the last page round as a final block:
  // slot j holds position last - ((last - j) % W) (C remainder, as
  // lax.rem); the live slots are exactly j < min(L, W).
  const long long roff = ((long long)b * p.hkv + h) * (long long)p.ring_w * D;
  const RingRows<D> rk{reinterpret_cast<const char*>(p.ring_k + roff)};
  const RingRows<D> rv{reinterpret_cast<const char*>(p.ring_v + roff)};
  const int rn = p.ring_w > 0 ? min(L, p.ring_w) : 0;
  if (!masked_block && first < num_active) {
    // Every walked block holds a live token (the window's first one in
    // block `first`, the length's last in the last).
    for (int blk = first; blk < num_active; ++blk) {
      const int lo = max(blk * p.bk, win_lo);
      const int hi = min((blk + 1) * p.bk, page_limit);
      run_round<KT, VT, D>(c, ks, vs, rk, rv, lo, hi,
                           blk == num_active - 1 ? rn : 0);
    }
  } else if (rn > 0) {
    run_round<KT, VT, D>(c, ks, vs, rk, rv, 0, 0, rn);
  }

  // Deferred normalisation (sink logit folded in once), this block's
  // share of the output.
  TQ* o = static_cast<TQ*>(p.o) + ((long long)b * p.hq + h * G) * D;
  const int total = G * D, share = (total + c.C - 1) / c.C;
  for (int i = tid; i < share; i += THREADS) {
    const int idx = c.rank * share + i;
    if (idx >= total) break;
    const int g = idx / D;
    const float m = c.row_m[g], l = c.row_l[g];
    float mult;
    if (p.sinks != nullptr) {
      const float sk = p.sinks[h * G + g];
      const float m2 = fmaxf(m, sk);
      const float scale_m = expf(m - m2);
      mult = scale_m / add(mul(l, scale_m), expf(sk - m2));
    } else {
      mult = (l == 0.f) ? 1.f : 1.f / l;
    }
    o[idx] = from_f<TQ>(mul(c.acc[idx], mult));
  }
  if (p.m_out != nullptr && c.rank == 0 && tid < G) {
    p.m_out[(long long)b * p.hq + h * G + tid] = c.row_m[tid];
    p.l_out[(long long)b * p.hq + h * G + tid] = c.row_l[tid];
  }
  cluster_sync();  // no block leaves while another reads its partials
}

// Returned, before any launch, for a call whose block needs more shared
// memory than the card gives one block (ops/build.py::ERR_SHARED_MEMORY).
constexpr int kErrSharedMemory = -2;

// Tokens one block takes of a kv block's (or of the ring's) live tokens:
// their share over the slices, in whole stages.
inline int token_cap(int tokens, int slices) {
  const int per = (tokens + slices - 1) / slices;
  return (per + STAGE_TOKENS - 1) / STAGE_TOKENS * STAGE_TOKENS;
}

// The instance's launch attributes, set once a device (the serving loop
// launches it every layer of every step): its dynamic shared memory as
// wide as any call has asked.
constexpr int MAX_DEVICES = 64;

template <typename TQ, int KT, int VT, int D>
int prepare(const DecodeParams& p, size_t* smem_out) {
  static int limit[MAX_DEVICES], allowed[MAX_DEVICES];
  const size_t smem =
      layout<KT, VT, D>(p.g, p.tcap, p.rcap, p.pps).total;
  *smem_out = smem;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (limit[dev] == 0)
    cudaDeviceGetAttribute(&limit[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)limit[dev]) return kErrSharedMemory;
  auto kernel = paged_decode_kernel<TQ, KT, VT, D>;
  if ((int)smem > allowed[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    allowed[dev] = (int)smem;
  }
  return (int)cudaGetLastError();
}

inline cudaLaunchConfig_t launch_config(const DecodeParams& p, int batch,
                                        size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.slices * p.hkv, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Occupancy of one instance at a call's shape (`out`: shared bytes a
// block, blocks an SM, clusters the card runs at once), or the launch.
template <typename TQ, int KT, int VT, int D>
int launch(const DecodeParams& p, int batch, cudaStream_t stream,
           int* out) {
  size_t smem = 0;
  const int rc = prepare<TQ, KT, VT, D>(p, &smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, batch, smem, stream, attr);
  auto kernel = paged_decode_kernel<TQ, KT, VT, D>;
  if (out != nullptr) {
    out[0] = (int)smem;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, THREADS,
                                                  smem);
    cudaOccupancyMaxActiveClusters(&out[2], kernel, &cfg);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The (K tier, V tier) pairs this build serves: each tier with itself,
// and k8v4's int8 K with int4 V (exact and mxu).
template <typename TQ, int D>
int launch_tiers(const DecodeParams& p, int k_tier, int v_tier, int batch,
                 cudaStream_t stream, int* out) {
  if (k_tier == kInt8 && v_tier == kInt4)
    return launch<TQ, kInt8, kInt4, D>(p, batch, stream, out);
  if (k_tier == kInt8Mxu && v_tier == kInt4Mxu)
    return launch<TQ, kInt8Mxu, kInt4Mxu, D>(p, batch, stream, out);
  if (k_tier != v_tier) return (int)cudaErrorInvalidValue;
  switch (k_tier) {
    case kF32: return launch<TQ, kF32, kF32, D>(p, batch, stream, out);
    case kBF16: return launch<TQ, kBF16, kBF16, D>(p, batch, stream, out);
    case kInt8: return launch<TQ, kInt8, kInt8, D>(p, batch, stream, out);
    case kInt8Mxu:
      return launch<TQ, kInt8Mxu, kInt8Mxu, D>(p, batch, stream, out);
    case kInt4: return launch<TQ, kInt4, kInt4, D>(p, batch, stream, out);
    case kInt4Mxu:
      return launch<TQ, kInt4Mxu, kInt4Mxu, D>(p, batch, stream, out);
    case kInt4G32:
      return launch<TQ, kInt4G32, kInt4G32, D>(p, batch, stream, out);
    case kFp8: return launch<TQ, kFp8, kFp8, D>(p, batch, stream, out);
    case kFp8Native:
      return launch<TQ, kFp8Native, kFp8Native, D>(p, batch, stream, out);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(const DecodeParams& p, int q_dtype, int head_dim, int k_tier,
             int v_tier, int batch, cudaStream_t s, int* out) {
  if (q_dtype == 0)
    return head_dim == 256
               ? launch_tiers<float, 256>(p, k_tier, v_tier, batch, s, out)
               : launch_tiers<float, 128>(p, k_tier, v_tier, batch, s, out);
  return head_dim == 256
             ? launch_tiers<__nv_bfloat16, 256>(p, k_tier, v_tier, batch, s,
                                                out)
             : launch_tiers<__nv_bfloat16, 128>(p, k_tier, v_tier, batch, s,
                                                out);
}

bool valid(int q_dtype, int k_tier, int v_tier, int hq, int hkv,
           int page_size, int head_dim, int slices) {
  const bool packed = k_tier == kInt4 || k_tier == kInt4Mxu ||
                      k_tier == kInt4G32 || v_tier == kInt4 ||
                      v_tier == kInt4Mxu || v_tier == kInt4G32;
  return (head_dim == 128 || head_dim == 256) && hkv > 0 && hq % hkv == 0 &&
         hq / hkv <= MAX_G && (q_dtype == 0 || q_dtype == 1) &&
         !(packed && page_size % 2 != 0) && slices >= 1 &&
         slices <= MAX_SLICES;
}

DecodeParams shape_params(int hq, int hkv, int page_size, int pages_per_seq,
                          int block_tokens, int ring_w, int slices) {
  DecodeParams p = {};
  p.hq = hq;
  p.hkv = hkv;
  p.ps = page_size;
  p.pps = pages_per_seq;
  p.bk = block_tokens;
  p.ring_w = ring_w;
  p.g = hq / hkv;
  p.slices = slices;
  p.tcap = token_cap(block_tokens, slices);
  p.rcap = ring_w > 0 ? token_cap(ring_w, slices) : 0;
  return p;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q and o). k_tier / v_tier: 0 f32,
// 1 bf16, 2 int8 (exact dequant), 3 int8 (int8 q and P), 4 int4 (exact),
// 5 int4 (int8 q and P), 6 int4g32, 7 fp8 (exact), 8 fp8 (e4m3 q and P).
// slices: thread blocks a (batch row, kv head), one cluster (1..8).
// Returns cudaGetLastError() after
// the launch; 1 (cudaErrorInvalidValue) for a configuration this build
// does not serve; kErrSharedMemory for a kv block too wide for the card's
// shared memory.
extern "C" int paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* lengths,
    const void* page_indices, const void* ring_k, const void* ring_v,
    const void* sinks, const void* alibi, void* o, void* m_out, void* l_out,
    int q_dtype, int k_tier, int v_tier, int batch, int hq, int hkv,
    int num_pages, int page_size, int pages_per_seq, int block_tokens,
    int ring_w, int head_dim, float scale, int window, float softcap,
    float inv_softcap, int slices, void* stream) {
  if (!valid(q_dtype, k_tier, v_tier, hq, hkv, page_size, head_dim, slices))
    return (int)cudaErrorInvalidValue;
  DecodeParams p = shape_params(hq, hkv, page_size, pages_per_seq,
                                block_tokens, ring_w, slices);
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
  p.num_pages = num_pages;
  p.scale = scale;
  p.window = window;
  p.softcap = softcap;
  p.inv_softcap = inv_softcap;
  return dispatch(p, q_dtype, head_dim, k_tier, v_tier, batch,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The instance a call of this shape launches: its shared memory a block,
// blocks an SM and clusters the card holds at once, in out[0..2].
extern "C" int paged_decode_occupancy(int q_dtype, int k_tier, int v_tier,
                                      int hq, int hkv, int page_size,
                                      int pages_per_seq, int block_tokens,
                                      int ring_w, int head_dim, int slices,
                                      int batch, void* out) {
  if (!valid(q_dtype, k_tier, v_tier, hq, hkv, page_size, head_dim, slices))
    return (int)cudaErrorInvalidValue;
  const DecodeParams p = shape_params(hq, hkv, page_size, pages_per_seq,
                                      block_tokens, ring_w, slices);
  return dispatch(p, q_dtype, head_dim, k_tier, v_tier, batch, nullptr,
                  static_cast<int*>(out));
}
