// quant_fwd: attention forward over int8 / e4m3 Q, K, V for Hopper (sm_90a)
// on the tensor cores.
//
// Replaces the Pallas TPU kernels of tpu_flash/ops/flash/quantized.py:
//   _quant_fwd_kernel (:99; rectangular grid :772 and triangular grid
//   :761 of flash_attention_quantized) and _quant_onepass_kernel (:281,
//   the opt-in int8 staircase of _forward_onepass_quant :401). As for
//   flash_fwd, the TPU's sequential kv grid axis becomes a loop inside
//   the block that visits only live kv tiles, so one computation serves
//   both grids; the staircase differs in its arithmetic and is its own
//   kernel.
//
// What it computes, per (batch, q head, row); GQA by index; causal aligned
// at position 0 of q and kv (no q offset):
//   scores  s = (s_raw * (q_scale * sm_scale)) * k_scale, in that order;
//           s_raw = the exact dot rounded to f32 once: int8, the s32 dot of
//           mma.sync m16n8k32 (|s_raw| <= 2^22 at d <= 256: exact in f32);
//           e4m3, each value as 2^-9 times an integer of three s8 limbs,
//           the nine limb-pair dots on the same s8 mma.sync, summed in
//           int64 (the plain version's exact f64 sum; tensor-core f16 or
//           fp8 sums round inside the mma, so a score could sit an ulp
//           off and flip a rounding of P);
//           softcap; ALiBi slope * (kv_pos - q_pos) on the causal path;
//           causal, window and kv-tail masks to MASK_VALUE (finite).
//   tiled   online softmax over 128-column steps (P rounds after each
//           step's running max, as on the TPU with block_kv = 128): m_next
//           = max(m, step max), alpha = exp(m - m_next), p = exp(s -
//           m_next), l = l * alpha + sum p, the sum in the order of
//           PyTorch's CUDA row sum, as the plain version's;
//           int8 / fp8 software: P = bf16(p * v_scale);
//           fp8 native: c = max_row(p * v_scale), c = c == 0 ? 1 : c / 448,
//           P = e4m3(p * v_scale / c);
//           P V = mma.sync m16n8k16 bf16 (f32 sums) of P and V widened
//           exactly to bf16 (native: fp16, which holds e4m3 exactly and
//           takes one conversion from it), from zero each step;
//           acc = acc * alpha + P V
//           (native: + c * (P V)); out = acc / l (l == 0: 1), or the
//           sink-inclusive denominator. A row that sees no live column of
//           a step (above the diagonal, before its window) keeps m, l and
//           acc, as the plain version leaves it out of the step.
//   onepass int8, causal, q_len == kv_len: each 512-row stair splits into
//           a mask-free prefix [0, lo) and a masked diagonal [lo, lo+512);
//           each part has its own row max m, l = sum p, and quantizes its
//           P rows to int8 over the whole part (p_scale = max(p *
//           v_scale) / 127, clip(rint(p * v_scale / p_scale), 0, 127)),
//           P V the exact int32 dot (mma.sync m16n8k32 s8) times p_scale;
//           the parts merge once. The block walks K three times (row max;
//           l and max(p * v_scale); quantize and P V, the last in 64-column
//           slices of d): scores are exact, so recomputing them costs no
//           error.
// Every f32 step the plain version (ops/flash/quantized.py::
// quant_fwd_plain) rounds on its own is rounded on its own here (__fmul_rn,
// __fadd_rn, __fdiv_rn: no contraction; rintf rounds half to even), and
// scores are exact, so every P matches it, and so does the tiled route's
// l; the two differ in the order of the f32 sums of P V (and of the
// staircase's l).
//
// Design. A block holds 8 warps of 16 q rows each (4 for fp8 at d 256):
// consecutive (16 positions, q head) tiles of one kv head, positions
// outer, so the q heads of a kv head share each K/V tile (read once a
// block). K and V arrive as bytes by cp.async (one tile each in flight
// behind the other's work), with their scales double-buffered; fp8 q is
// split into limb tiles once a block, fp8 K once a step (a 256-entry
// table), V widened into a bf16 tile for P V (the staircase transposes
// V's bytes instead, for the s8 B operand). Scores, the softmax and P
// live in registers in the mma accumulator layout (quad shuffles for row
// max and sum); O in f32 registers. Causal blocks launch heaviest first
// over the whole grid.
//
// What bounds it on this card: operations. At a Llama-3-8B 8K causal
// prefill (32 q / 8 kv heads, d 128) it does 5.5e11 operations against
// about 120 MB of bytes: 0.417 ms at the int8 (QK^T) and bf16 (P V)
// tensor-core rates (H100 SXM data sheet, 700 W). Every score element takes
// two scalings, an exp and a rounding on the CUDA cores, the block's
// barriers separate its phases, and fp8's exact scores take nine s8
// products where int8 takes one.
//
// Layout: q [b, hq, sq, d] int8 or e4m3; q scales read at q_scales[b *
// sb + h * sh + row * sr] (a lane-replicated [b, hq, sq, 128] tensor, or a
// stride-0 expand of [b, hq, sq, 1]); k/v [b, hkv, skv, d] contiguous; k/v
// scales [b, hkv, 1, skv] f32 contiguous; o [b, hq, sq, d] bf16 or f32.
// d 64, 128 or 256; skv a multiple of 128; every pointer 16-byte aligned.
// Each launch runs on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

enum Mode { kInt8 = 0, kFp8Soft = 1, kFp8Native = 2, kInt8Onepass = 3 };

constexpr int BK = 128;  // kv columns a staged tile and online-softmax step
constexpr int NJ = BK / 8;  // 8-column n-tiles of a step's scores
constexpr int STAIR = 512;  // rows of one onepass stair
constexpr int DC = 64;            // d columns of one P V pass
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float kInt8Max = 127.f;
constexpr float kFp8Max = 448.f;

// Parts of the tiled step a diagnostic build leaves out, one bit each (1
// the exp, 2 the score products, 4 the P V products, 8 the score
// transform, 16 V's widening and fp8 K's limb split): only
// tools/torch_quant_parts.py defines it, to time what each part costs.
// Its outputs are then wrong.
#ifndef QUANT_FWD_OMIT
#define QUANT_FWD_OMIT 0
#endif

// Warps a block (16 q rows each): 8, 4 for fp8 at d 256, whose limb tiles
// would not fit 8 warps' rows. (Blocks of 4 warps, two an SM, stage and
// widen the same K/V tiles for half the rows.)
__host__ __device__ constexpr int warps_for(int d, bool fp8) {
  return d == 256 && fp8 ? 4 : 8;
}
// Whether a tiled step takes two barriers (split: fp8 K's limb tiles
// beside V's bf16 tile, int8 K's bytes in two buffers) or three (fp8 at
// d 256, whose limb tiles share the work tile with V).
__host__ __device__ constexpr bool split_for(int d, bool fp8) {
  return !(fp8 && d == 256);
}

// A block's geometry and shared memory, in bytes: q (int8 bytes, or fp8's
// three limb tiles), K's (KBUF buffers) and V's byte tiles (row stride
// LDB), split fp8's K limb tiles, the work tile (V in bf16, row stride LDW
// elements, after fp8 K's limb tiles where not split; on the staircase
// V's bytes transposed, row stride LDT), fp8's limb table, and k/v scales
// [2 buffers][k, v][BK].
template <int D_, int W_, bool FP8_, bool SPLIT_>
struct Geo {
  static constexpr int D = D_, WARPS = W_, THREADS = 32 * W_, ROWS = 16 * W_;
  static constexpr bool FP8 = FP8_, SPLIT = SPLIT_;
  static constexpr int LDB = D + 16;
  static constexpr int LDW = D + 8;
  static constexpr int LDT = BK + 16;
  static constexpr int LIMBS = FP8 ? 3 : 1;
  static constexpr int QL = ROWS * LDB;  // one q limb tile
  static constexpr int KL = BK * LDB;    // one K limb tile
  static constexpr int KBUF = SPLIT && !FP8 ? 2 : 1;
  static constexpr size_t KLB = SPLIT && FP8 ? 3 * KL : 0;
  static constexpr size_t WB = FP8 && !SPLIT && 3 * KL > 2 * BK * LDW
                                   ? 3 * KL : 2 * BK * LDW;
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + LIMBS * QL;
  static constexpr size_t V = K + KBUF * KL;
  static constexpr size_t KLIMB = V + KL;
  static constexpr size_t W = KLIMB + KLB;
  static constexpr size_t TAB = W + WB;
  static constexpr size_t SC = TAB + (FP8 ? 256 * sizeof(uint32_t) : 0);
  static constexpr size_t SMEM = SC + sizeof(float) * 2 * 2 * BK;
  static_assert(D % 64 == 0, "d a multiple of 64");
  static_assert(D * LDT <= 2 * BK * LDW, "V^T bytes fit the work tile");
  static_assert(SMEM <= 232448, "over the card's 227 KB a block");
};

struct QParams {
  const uint8_t* q;
  const float* q_scales;
  long long qs_sb, qs_sh, qs_sr;  // q scale strides (elements)
  const uint8_t* k;
  const float* k_scales;
  const uint8_t* v;
  const float* v_scales;
  void* o;
  const float* sinks;  // [hq] or nullptr
  const float* alibi;  // [hq] or nullptr
  int batch, hq, hkv, sq, skv, kv_len, nblk;
  float sm_scale;
  int causal, window;           // window <= 0: none
  float softcap, inv_softcap;   // softcap <= 0: none
};

// Two f32 rounded to nearest even e4m3 (saturating at 448), as an exact
// fp16 pair (lo in the low half): two conversions for two values.
__device__ __forceinline__ uint32_t e4m3_f16_pair(float lo, float hi) {
  return tc::e4m3x2_f16(
      __nv_cvt_float2_to_fp8x2(make_float2(lo, hi), __NV_SATFINITE,
                               __NV_E4M3),
      false);
}

// x / c rounded to nearest even, from r = 1 / c rounded to nearest:
// q0 = x r is within an ulp of x / c, x - q0 c is exact (one fma), and
// q0 + (x - q0 c) r rounds to x / c (Markstein's correction), for x / c
// normal. A quotient too small to be normal rounds to e4m3 zero either
// way, where this one serves (native P: x / c in [0, 448]). No branch,
// where __fdiv_rn takes one to its slow path.
__device__ __forceinline__ float div_by(float x, float c, float r) {
  const float q0 = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q0, c, x), r, q0);
}

// One warp's 16 q rows: positions p0 .. p0 + 15 of q head h, and the kv
// tiles [first, last] they see (first > last: none).
struct WarpRows {
  bool valid;
  int h, p0, first, last;
};

// The block's (batch, kv head, row group), heaviest causal group first.
struct BlockPos {
  int b, hk, grp;
};

__device__ __forceinline__ BlockPos block_pos(const QParams& p) {
  const int lanes = p.batch * p.hkv;
  const int id = blockIdx.x;
  BlockPos bp;
  bp.grp = p.nblk - 1 - id / lanes;
  bp.hk = (id % lanes) % p.hkv;
  bp.b = (id % lanes) / p.hkv;
  return bp;
}

// Warp w's rows: (position tile, q head of the group) tiles in that order.
template <int WARPS>
__device__ __forceinline__ WarpRows warp_rows(const QParams& p,
                                              const BlockPos& bp, int w,
                                              bool onepass) {
  const int g = p.hq / p.hkv;
  const int t = bp.grp * WARPS + w;
  WarpRows r;
  r.valid = t < ((p.sq + 15) / 16) * g;
  r.h = bp.hk * g + t % g;
  r.p0 = (t / g) * 16;
  const int p_last = min(r.p0 + 15, p.sq - 1);
  int lo = 0, hi = p.kv_len - 1;
  if (p.causal) {
    hi = min(hi, p_last);
    if (p.window > 0) lo = max(0, r.p0 - p.window + 1);
  }
  if (onepass) {  // both parts: the prefix from 0, the diagonal to p_last
    lo = 0;
    hi = p_last;
  }
  r.first = lo / BK;
  r.last = r.valid && hi >= lo ? hi / BK : -1;
  return r;
}

// The union of the block's warps' tiles.
template <int WARPS>
__device__ __forceinline__ void block_tiles(const QParams& p,
                                            const BlockPos& bp, bool onepass,
                                            int& first, int& last) {
  first = 1 << 30;
  last = -1;
  for (int w = 0; w < WARPS; ++w) {
    const WarpRows r = warp_rows<WARPS>(p, bp, w, onepass);
    if (r.first <= r.last) {
      first = min(first, r.first);
      last = max(last, r.last);
    }
  }
}

// The block's q row r: where it starts in q, or nullptr past sq.
template <class G>
__device__ __forceinline__ const uint8_t* q_row(const QParams& p,
                                                const BlockPos& bp, int r) {
  const WarpRows w = warp_rows<G::WARPS>(p, bp, r / 16, false);
  const int pos = w.p0 + r % 16;
  if (!w.valid || pos >= p.sq) return nullptr;
  return p.q + (((long long)bp.b * p.hq + w.h) * p.sq + pos) * G::D;
}

// int8: the block's q rows into Qb by cp.async.
template <class G>
__device__ __forceinline__ void stage_q(const QParams& p, const BlockPos& bp,
                                        uint8_t* Qb) {
  constexpr int CPR = G::D / 16;
  for (int i = threadIdx.x; i < G::ROWS * CPR; i += G::THREADS) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const uint8_t* row = q_row<G>(p, bp, r);
    tc::cp_async16(Qb + r * G::LDB + c, row ? row + c : p.q, row != nullptr);
  }
}

// fp8 scores as exact integers. An e4m3 value x is X / 2^9 with X an
// integer, |X| < 2^18; X = a 2^14 + b 2^7 + c with limbs of X's sign and
// at most 7 bits (|c|, |b| < 128, |a| <= 14), each an s8. The dot of two
// rows is then sum over limb pairs of 2^(7 (i + j)) times an s8 dot:
// nine exact int32 products on the tensor cores, summed exactly in int64.
// tab[byte] = (c, b, a) as the bytes 0, 1, 2 of a word.
__device__ __forceinline__ uint32_t e4m3_limbs(uint32_t byte) {
  const int x = __float2int_rn(tc::e4m3x2_f32(byte, false).x * 512.f);
  const int m = abs(x), sg = x < 0 ? -1 : 1;
  const int c = sg * (m & 127), b = sg * ((m >> 7) & 127), a = sg * (m >> 14);
  return (uint32_t)(c & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(a & 0xff) << 16);
}

// The limbs of 16 e4m3 bytes: out[0] c, out[1] b, out[2] a, byte for byte.
__device__ __forceinline__ void limbs16(uint4 raw, const uint32_t* tab,
                                        uint4 (&out)[3]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t t0 = tab[w[i] & 0xff], t1 = tab[(w[i] >> 8) & 0xff];
    const uint32_t t2 = tab[(w[i] >> 16) & 0xff], t3 = tab[w[i] >> 24];
    const uint32_t lo = __byte_perm(t0, t1, 0x5140);  // c0 c1 b0 b1
    const uint32_t hi = __byte_perm(t2, t3, 0x5140);  // c2 c3 b2 b3
    o[0][i] = __byte_perm(lo, hi, 0x5410);
    o[1][i] = __byte_perm(lo, hi, 0x7632);
    o[2][i] = __byte_perm(__byte_perm(t0, t1, 0x0062),
                          __byte_perm(t2, t3, 0x0062), 0x5410);
  }
#pragma unroll
  for (int l = 0; l < 3; ++l) out[l] = make_uint4(o[l][0], o[l][1], o[l][2], o[l][3]);
}

// fp8: the limb table, then the block's q rows as three limb tiles (loads
// from device memory; once a block).
template <class G>
__device__ __forceinline__ void q_limbs(const QParams& p, const BlockPos& bp,
                                        uint8_t* Qb, uint32_t* tab) {
  for (int i = threadIdx.x; i < 256; i += G::THREADS) tab[i] = e4m3_limbs(i);
  __syncthreads();
  constexpr int CPR = G::D / 16;
  for (int i = threadIdx.x; i < G::ROWS * CPR; i += G::THREADS) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const uint8_t* row = q_row<G>(p, bp, r);
    const uint4 raw = row ? *reinterpret_cast<const uint4*>(row + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    uint4 out[3];
    limbs16(raw, tab, out);
#pragma unroll
    for (int l = 0; l < 3; ++l)
      *reinterpret_cast<uint4*>(Qb + l * G::QL + r * G::LDB + c) = out[l];
  }
}

// fp8: K's bytes into three limb tiles (the work tile).
template <class G>
__device__ __forceinline__ void k_limbs(const uint8_t* Kb, uint8_t* Wt,
                                        const uint32_t* tab) {
  constexpr int CPR = G::D / 16;
  for (int i = threadIdx.x; i < BK * CPR; i += G::THREADS) {
    const int r = i / CPR, c = (i % CPR) * 16;
    uint4 out[3];
    limbs16(*reinterpret_cast<const uint4*>(Kb + r * G::LDB + c), tab, out);
#pragma unroll
    for (int l = 0; l < 3; ++l)
      *reinterpret_cast<uint4*>(Wt + l * G::KL + r * G::LDB + c) = out[l];
  }
}

// K's bytes of tile `tile` into Kb, its k and v scales into sc[0, 2 BK).
template <class G>
__device__ __forceinline__ void stage_k(const uint8_t* k, const float* ks,
                                        const float* vs, int tile,
                                        uint8_t* Kb, float* sc) {
  tc::load_bytes<G::D, BK, G::THREADS, G::LDB>(Kb, k, tile * BK, 1 << 30);
  const int t = threadIdx.x;
  if (t < BK / 2) {  // 32 pieces of k scales, 32 of v scales
    const float* src = (t < BK / 4 ? ks : vs) + tile * BK + (t % (BK / 4)) * 4;
    tc::cp_async16(sc + (t / (BK / 4)) * BK + (t % (BK / 4)) * 4, src, true);
  }
}

// V bytes -> 16 bits, in order: int8 or e4m3 to bf16 (MODE int8, fp8
// software), e4m3 to fp16 (fp8 native).
template <class G, int MODE>
__device__ __forceinline__ void widen_v(const uint8_t* Vb, uint8_t* Wt) {
  constexpr int CPR = G::D / 16;
  for (int i = threadIdx.x; i < BK * CPR; i += G::THREADS) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(Vb + r * G::LDB + c);
    uint4 lo, hi;
    if (MODE == kFp8Native) {
      lo = make_uint4(
          tc::e4m3x2_f16(raw.x, false), tc::e4m3x2_f16(raw.x, true),
          tc::e4m3x2_f16(raw.y, false), tc::e4m3x2_f16(raw.y, true));
      hi = make_uint4(
          tc::e4m3x2_f16(raw.z, false), tc::e4m3x2_f16(raw.z, true),
          tc::e4m3x2_f16(raw.w, false), tc::e4m3x2_f16(raw.w, true));
    } else {
      constexpr bool E4M3 = MODE == kFp8Soft;
      tc::widen4_bf16<E4M3>(raw.x, lo.x, lo.y);
      tc::widen4_bf16<E4M3>(raw.y, lo.z, lo.w);
      tc::widen4_bf16<E4M3>(raw.z, hi.x, hi.y);
      tc::widen4_bf16<E4M3>(raw.w, hi.z, hi.w);
    }
    uint4* dst = reinterpret_cast<uint4*>(Wt + 2 * (r * G::LDW + c));
    dst[0] = lo;
    dst[1] = hi;
  }
}

// Staircase: V's int8 bytes transposed, [d][kv] (row stride LDT), the kv
// order of each 32 permuted to match P's fragments (pass 3 of
// quant_onepass_kernel): stored column 32 q + 16 u + 4 t + i holds kv row
// 32 q + 16 u + 2 t + {0, 1, 8, 9}[i].
template <class G>
__device__ __forceinline__ void transpose_v(const uint8_t* Vb, uint8_t* Wt) {
  for (int i = threadIdx.x; i < G::D * BK / 4; i += G::THREADS) {
    const int d = i / (BK / 4), l0 = (i % (BK / 4)) * 4;
    const int base = (l0 / 16) * 16 + ((l0 % 16) / 4) * 2;
    const uint32_t w = (uint32_t)Vb[base * G::LDB + d] |
                       ((uint32_t)Vb[(base + 1) * G::LDB + d] << 8) |
                       ((uint32_t)Vb[(base + 8) * G::LDB + d] << 16) |
                       ((uint32_t)Vb[(base + 9) * G::LDB + d] << 24);
    *reinterpret_cast<uint32_t*>(Wt + d * G::LDT + l0) = w;
  }
}

// An int32 of magnitude at most 2^22 (an s8 dot of d <= 256) as f32,
// exactly: its bits added into those of 1.5 * 2^23, whose ulp is 1, then
// 1.5 * 2^23 taken off (an integer add and an f32 add, where I2F would
// take the quarter-rate conversion pipe).
__device__ __forceinline__ float exact_f32(int x) {
  return __int_as_float(0x4b400000 + x) - 12582912.f;
}

// The tiled kernel's kv order within a step: accumulator column 8 j + u
// (u = 2 tq + i) holds kv column kv_of(j, u), so that a thread holds kv
// columns 4 tq .. 4 tq + 3 of each 16 (PyTorch's row-sum partials,
// torch_row_sum): their first pair in n-tile 2 (j / 2) + tq / 2, the
// second in the other. ldmatrix takes a row address from each lane, so
// K's rows (B operand of the scores) and V's (of P V) are read in that
// order; the 8 rows of each 8 x 8 matrix differ mod 8, so they fall in 8
// bank groups at the tiles' odd multiples of 16 bytes a row.
__device__ __forceinline__ int kv_of(int j, int u) {
  return 16 * (j >> 1) + 4 * (u >> 1) + 2 * ((u >> 2) ^ (j & 1)) + (u & 1);
}
// b_off of the n-tiles j, j + 1 (j even) of a K tile in that order.
template <int LD>
__device__ __forceinline__ uint32_t k_off(int lane, int j, int c0) {
  return 2u * (kv_of(j + (lane >> 4), lane & 7) * LD + c0 +
               ((lane >> 3) & 1) * 8);
}
// a_off of P V's k slice c (16 kv rows) of a V tile in that order.
template <int LD>
__device__ __forceinline__ uint32_t v_off(int lane, int c, int n) {
  return 2u * (kv_of(2 * c + ((lane >> 3) & 1), lane & 7) * LD + n +
               (lane >> 4) * 8);
}

// The raw scores of the warp's rows (wr: its first row in the q tile)
// against the staged tile: s[j][e] for column 8 j + 2 tq + (e & 1) (in
// kv_of's order where PERM), row gr + 8 (e >> 1). int8: the s8 dot of q's
// and K's byte tiles.
template <class G, bool PERM>
__device__ __forceinline__ void int8_scores(float (&s)[NJ][4], uint32_t qt,
                                            uint32_t kt, int lane, int wr) {
  constexpr int LQ = G::LDB / 2;  // the byte tiles' stride in byte pairs
  int acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
  for (int kk = 0; kk < G::D; kk += 32) {
    uint32_t qa[4];
    tc::ldsm(qa, qt + tc::a_off<LQ>(lane, wr, kk / 2));
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t kb[4];
      tc::ldsm(kb, kt + (PERM ? k_off<LQ>(lane, j, kk / 2)
                              : tc::b_off<LQ>(lane, j * 8, kk / 2)));
      tc::imma(acc[j], qa, kb[0], kb[1]);
      tc::imma(acc[j + 1], qa, kb[2], kb[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exact_f32(acc[j][e]);
}

// fp8 (tiled, kv_of's order): the exact dot from the limb tiles of q (qt,
// tiles QL apart) and K (kt, KL apart), 16 columns at a time: five int32 sums by shift (the
// limb pairs of 2^0, 2^7, 2^14, 2^21, 2^28; each below 2^24 at d <= 256),
// then one int64, rounded to f32 once and times 2^-18 (exact).
template <class G>
__device__ __forceinline__ void fp8_scores(float (&s)[NJ][4], uint32_t qt,
                                           uint32_t kt, int lane, int wr) {
  constexpr int LQ = G::LDB / 2;
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    int acc[5][2][4];
#pragma unroll
    for (int g = 0; g < 5; ++g)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][t][e] = 0;
#pragma unroll
    for (int kk = 0; kk < G::D; kk += 32) {
      uint32_t qa[3][4], kb[3][4];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        tc::ldsm(qa[l], qt + l * G::QL + tc::a_off<LQ>(lane, wr, kk / 2));
        tc::ldsm(kb[l], kt + l * G::KL + k_off<LQ>(lane, j, kk / 2));
      }
#pragma unroll
      for (int lq = 0; lq < 3; ++lq)
#pragma unroll
        for (int lk = 0; lk < 3; ++lk) {
          tc::imma(acc[lq + lk][0], qa[lq], kb[lk][0], kb[lk][1]);
          tc::imma(acc[lq + lk][1], qa[lq], kb[lk][2], kb[lk][3]);
        }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = acc[4][t][e] * 16384 + acc[3][t][e] * 128 + acc[2][t][e];
        const int lo = acc[1][t][e] * 128 + acc[0][t][e];
        s[j + t][e] = __fmul_rn(__ll2float_rn((long long)hi * 16384 + lo),
                                3.814697265625e-06f);
      }
  }
}

// The scores of the warp's rows from their raw dots: dequant rescale,
// softcap, ALiBi and, where `masked`, the masks of the plain version
// (kv tail, and on the causal path causal and window); `full`: no element
// of the step is masked. mx: each row's max over the step (quad-reduced).
// Each option is one branch around a loop over the elements, so the
// elements' independent chains interleave. PERM: columns in kv_of's order.
template <bool PERM>
__device__ __forceinline__ void transform(float (&s)[NJ][4], const QParams& p,
                                          const WarpRows& w, const float* ksc,
                                          const float (&qs)[2], float slope,
                                          int k0, int gr, int tq, bool masked,
                                          bool full, float (&mx)[2]) {
  // Element (j, e)'s kv column in the step.
  auto col = [&](int j, int e) {
    return PERM ? kv_of(j, 2 * tq + (e & 1)) : 8 * j + 2 * tq + (e & 1);
  };
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = __fmul_rn(__fmul_rn(s[j][e], qs[e >> 1]), ksc[col(j, e)]);
  if (p.softcap > 0.f) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] =
            __fmul_rn(p.softcap, tanhf(__fmul_rn(s[j][e], p.inv_softcap)));
  }
  // kv_pos - q_pos of element (j, e).
  const int rel = k0 - w.p0 - gr;
  if (p.causal && p.alibi != nullptr) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = __fadd_rn(
            s[j][e],
            __fmul_rn(slope, (float)(rel + col(j, e) - 8 * (e >> 1))));
  }
  if (!full) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = rel + col(j, e) - 8 * (e >> 1);  // kv - q
        bool valid = k0 + col(j, e) < p.kv_len;
        if (p.causal && masked) {
          valid = valid && d <= 0;
          if (p.window > 0) valid = valid && d > -p.window;
        }
        s[j][e] = valid ? s[j][e] : MASK_VALUE;
      }
  }
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The sum of row h's 128 values of a step (accumulator columns in
// kv_of's order: this thread holds kv columns 16 m + 4 tq + 0, 1 in
// n-tile 2 m + tq / 2 and + 2, 3 in the other) in the order of PyTorch's
// CUDA row sum, which the plain version's p.sum(-1) takes
// (prefill_tile.cuh, torch_row_sum): 32 partials, partial t the
// sequential sum of columns 4 t .. 4 t + 3 (here t = 4 m + tq, a thread's
// own), then a tree at halving offsets: 16, 8 and 4 are m + 4, m + 2 and
// m + 1, 2 and 1 the lanes tq ^ 2 and tq ^ 1. Every thread of the quad
// returns the sum.
__device__ __forceinline__ float torch_row_sum(const float (&x)[NJ][4], int h,
                                               int tq) {
  const bool lo = tq & 2;  // a partial's first pair in n-tile 2 m + 1
  float part[NJ / 2];
#pragma unroll
  for (int m = 0; m < NJ / 2; ++m) {
    const float(&e)[4] = x[2 * m];
    const float(&o)[4] = x[2 * m + 1];
    const float a0 = lo ? o[2 * h] : e[2 * h];
    const float a1 = lo ? o[2 * h + 1] : e[2 * h + 1];
    const float b0 = lo ? e[2 * h] : o[2 * h];
    const float b1 = lo ? e[2 * h + 1] : o[2 * h + 1];
    part[m] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), b0), b1);
  }
#pragma unroll
  for (int off = NJ / 4; off >= 1; off /= 2)
#pragma unroll
    for (int m = 0; m < off; ++m) part[m] = __fadd_rn(part[m], part[m + off]);
  const float v = __fadd_rn(part[0], __shfl_xor_sync(0xffffffffu, part[0], 2));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
}

// q_scale * sm_scale of the thread's rows gr, gr + 8 (0 past sq).
__device__ __forceinline__ void row_scales(const QParams& p, int b,
                                           const WarpRows& w, int gr,
                                           float (&qs)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = w.p0 + gr + 8 * h;
    const float x = w.valid && pos < p.sq
                        ? p.q_scales[b * p.qs_sb + w.h * p.qs_sh +
                                     pos * p.qs_sr]
                        : 0.f;
    qs[h] = __fmul_rn(x, p.sm_scale);
  }
}

template <typename TO>
__device__ __forceinline__ void store_pair(TO* dst, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst,
                                                          float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = tc::pack(a, b);
}

// A row's output multiplier: 1 / l (l == 0: 1), or the sink-inclusive
// denominator.
__device__ __forceinline__ float out_mult(const QParams& p, int h, float m,
                                          float l) {
  if (p.sinks != nullptr) {
    const float sk = p.sinks[h];
    const float m2 = fmaxf(m, sk);
    const float scale_m = expf(__fsub_rn(m, m2));
    const float l_tot =
        __fadd_rn(__fmul_rn(l, scale_m), expf(__fsub_rn(sk, m2)));
    return __fdiv_rn(scale_m, l_tot);
  }
  return l == 0.f ? 1.f : __fdiv_rn(1.f, l);
}

// Columns [n0, n0 + 8 NW) of the thread's rows gr, gr + 8 (acc[n]: n-tile
// n0 / 8 + n, pairs of columns 8 n + 2 tq) times each row's multiplier.
template <int D, int NW, typename TO>
__device__ __forceinline__ void store_cols(const QParams& p, int b,
                                           const WarpRows& w, int gr, int tq,
                                           int n0, const float (&acc)[NW][4],
                                           const float (&mult)[2]) {
  if (!w.valid) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = w.p0 + gr + 8 * h;
    if (pos >= p.sq) continue;
    TO* row = static_cast<TO*>(p.o) +
              (((long long)b * p.hq + w.h) * p.sq + pos) * D + n0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < NW; ++n)
      store_pair<TO>(row + 8 * n, __fmul_rn(acc[n][2 * h], mult[h]),
                     __fmul_rn(acc[n][2 * h + 1], mult[h]));
  }
}

// The tiled routes (rectangular and triangular grids of the TPU kernel).
// A split step: barrier; V widened (and fp8 K split into limbs); barrier;
// the next tile's loads issued; scores, softmax and P V with no barrier,
// so one warp's softmax runs beside another's products. fp8 at d 256
// (not split): K's limbs, then V, take the work tile in turn, one barrier
// more.
template <int D, int MODE, typename TO>
__global__ void __launch_bounds__(
    32 * warps_for(D, MODE == kFp8Soft || MODE == kFp8Native), 1)
    quant_fwd_kernel(QParams p) {
  constexpr bool FP8 = MODE == kFp8Soft || MODE == kFp8Native;
  constexpr bool SPLIT = split_for(D, FP8);
  using G = Geo<D, warps_for(D, FP8), FP8, SPLIT>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qb = smem + G::Q;
  uint8_t* Vb = smem + G::V;
  uint8_t* Kl = smem + (SPLIT ? G::KLIMB : G::W);  // fp8 K's limb tiles
  uint8_t* Wt = smem + G::W;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + G::TAB);
  float* sc = reinterpret_cast<float*>(smem + G::SC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const BlockPos bp = block_pos(p);
  const WarpRows w = warp_rows<G::WARPS>(p, bp, warp, false);
  int first, last;
  block_tiles<G::WARPS>(p, bp, false, first, last);
  const long long kv_off = ((long long)bp.b * p.hkv + bp.hk) * p.skv;
  const uint8_t* k = p.k + kv_off * D;
  const uint8_t* v = p.v + kv_off * D;
  const float* ks = p.k_scales + kv_off;
  const float* vs = p.v_scales + kv_off;
  // K's byte buffer of a tile, its scales.
  auto kbuf = [&](int tile) { return smem + G::K + (tile % G::KBUF) * G::KL; };
  auto scales = [&](int tile) { return sc + (tile & 1) * 2 * BK; };

  if (!FP8) stage_q<G>(p, bp, Qb);
  if (first <= last) stage_k<G>(k, ks, vs, first, kbuf(first), scales(first));
  tc::cp_async_commit();
  if (first <= last)
    tc::load_bytes<D, BK, G::THREADS, G::LDB>(Vb, v, first * BK, 1 << 30);
  tc::cp_async_commit();
  if (FP8) q_limbs<G>(p, bp, Qb, tab);

  float qs[2];
  row_scales(p, bp.b, w, gr, qs);
  const float slope = p.alibi != nullptr ? p.alibi[w.h] : 0.f;
  const int p_last = w.p0 + 15;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qt = tc::smem_addr(Qb), klt = tc::smem_addr(Kl);
  const uint32_t wt = tc::smem_addr(Wt);

  for (int tile = first; tile <= last; ++tile) {
    const int k0 = tile * BK;
    const float* ksc = scales(tile);
    const bool more = tile < last;
    if (SPLIT) {
      tc::cp_async_wait<0>();  // this tile's K, V and scales are in
      __syncthreads();         // and every warp is past the last step
      if constexpr ((QUANT_FWD_OMIT & 16) == 0) {
        widen_v<G, MODE>(Vb, Wt);
        if (FP8) k_limbs<G>(kbuf(tile), Kl, tab);
      }
      __syncthreads();
      if (more) {
        stage_k<G>(k, ks, vs, tile + 1, kbuf(tile + 1), scales(tile + 1));
        tc::load_bytes<D, BK, G::THREADS, G::LDB>(Vb, v, k0 + BK, 1 << 30);
      }
      tc::cp_async_commit();
    } else {
      tc::cp_async_wait<1>();  // this tile's K and scales are in
      __syncthreads();
      k_limbs<G>(kbuf(tile), Kl, tab);
      __syncthreads();  // K's bytes are free
      if (more) stage_k<G>(k, ks, vs, tile + 1, kbuf(tile + 1), scales(tile + 1));
      tc::cp_async_commit();
    }
    const bool live = w.first <= tile && tile <= w.last;
    float s[NJ][4];
    float alpha[2] = {1.f, 1.f}, cc[2] = {1.f, 1.f};
    if (live) {
      if constexpr ((QUANT_FWD_OMIT & 2) != 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = (float)(j + e);
      } else if (FP8) {
        fp8_scores<G>(s, qt, klt, lane, warp * 16);
      } else {
        int8_scores<G, true>(s, qt, tc::smem_addr(kbuf(tile)), lane,
                             warp * 16);
      }
      const bool full = k0 + BK <= p.kv_len &&
                        (!p.causal || (k0 + BK - 1 <= w.p0 &&
                                       (p.window <= 0 ||
                                        k0 > p_last - p.window)));
      float mx[2];
      if constexpr ((QUANT_FWD_OMIT & 8) != 0) {
        mx[0] = quad_max(fmaxf(s[0][0], s[1][1]));
        mx[1] = quad_max(fmaxf(s[0][2], s[1][3]));
      } else {
        transform<true>(s, p, w, ksc, qs, slope, k0, gr, tq, true, full, mx);
      }
      float cmax[2] = {0.f, 0.f}, mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A row with no live column of this step is left as it was: its
        // p are exp(MASK_VALUE - inf) = 0 and alpha 1.
        mu[h] = INFINITY;
        if (mx[h] > MASK_VALUE) {
          const float mn = fmaxf(m[h], mx[h]);
          alpha[h] = expf(__fsub_rn(m[h], mn));
          m[h] = mu[h] = mn;
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = (QUANT_FWD_OMIT & 1) ? __fsub_rn(s[j][e], mu[e >> 1])
                                         : expf(__fsub_rn(s[j][e], mu[e >> 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), torch_row_sum(s, h, tq));
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv =
              __fmul_rn(s[j][e], ksc[BK + kv_of(j, 2 * tq + (e & 1))]);
          s[j][e] = pv;
          if (MODE == kFp8Native) cmax[e >> 1] = fmaxf(cmax[e >> 1], pv);
        }
      if (MODE == kFp8Native) {
#pragma unroll
        float rc[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float c = quad_max(cmax[h]);
          cc[h] = c == 0.f ? 1.f : __fdiv_rn(c, kFp8Max);
          rc[h] = __frcp_rn(cc[h]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = div_by(s[j][e], cc[e >> 1], rc[e >> 1]);
      }
    }
    if (!SPLIT) {
      // This V is in; every warp is past its scores (the work tile is
      // free).
      tc::cp_async_wait<1>();
      __syncthreads();
      widen_v<G, MODE>(Vb, Wt);
      __syncthreads();  // V's bytes are free
      if (more)
        tc::load_bytes<D, BK, G::THREADS, G::LDB>(Vb, v, k0 + BK, 1 << 30);
      tc::cp_async_commit();
    }
    if (live) {
      // P's A fragments: bf16(p * v_scale); native, e4m3(p * v_scale / c)
      // as fp16 (exact), with V in fp16.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        if (MODE == kFp8Native) {
          pa[c][0] = e4m3_f16_pair(s[2 * c][0], s[2 * c][1]);
          pa[c][1] = e4m3_f16_pair(s[2 * c][2], s[2 * c][3]);
          pa[c][2] = e4m3_f16_pair(s[2 * c + 1][0], s[2 * c + 1][1]);
          pa[c][3] = e4m3_f16_pair(s[2 * c + 1][2], s[2 * c + 1][3]);
        } else {
          tc::to_a(pa[c], s, c);
        }
      }
      // acc = acc * alpha + P V (native: + c * P V), P V from zero.
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += DC) {
        float t[DC / 8][4];
#pragma unroll
        for (int n = 0; n < DC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < BK / 16; ++c)
#pragma unroll
          for (int n = 0; n < DC; n += 16) {
            uint32_t vb[4];
            tc::ldsm_t(vb, wt + v_off<G::LDW>(lane, c, n0 + n));
            if constexpr ((QUANT_FWD_OMIT & 4) != 0) {
              t[n / 8][0] += __uint_as_float(vb[0] ^ pa[c][0]);
              t[n / 8 + 1][1] += __uint_as_float(vb[2] ^ pa[c][1]);
            } else if (MODE == kFp8Native) {
              tc::mma_f16(t[n / 8], pa[c], vb[0], vb[1]);
              tc::mma_f16(t[n / 8 + 1], pa[c], vb[2], vb[3]);
            } else {
              tc::mma(t[n / 8], pa[c], vb[0], vb[1]);
              tc::mma(t[n / 8 + 1], pa[c], vb[2], vb[3]);
            }
          }
#pragma unroll
        for (int n = 0; n < DC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float term = MODE == kFp8Native
                                   ? __fmul_rn(t[n][e], cc[e >> 1])
                                   : t[n][e];
            float& a = o[n0 / 8 + n][e];
            a = __fadd_rn(__fmul_rn(a, alpha[e >> 1]), term);
          }
      }
    }
  }
  tc::cp_async_wait<0>();
  float mult[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) mult[h] = out_mult(p, w.h, m[h], l[h]);
  store_cols<D, D / 8, TO>(p, bp.b, w, gr, tq, 0, o, mult);
}

// Staircase: stage tile `tile` (K, scales and, with `with_v`, V's bytes
// transposed) and wait for it; every thread returns with it in place.
template <class G>
__device__ __forceinline__ void onepass_stage(const uint8_t* k,
                                              const uint8_t* v,
                                              const float* ks,
                                              const float* vs, int tile,
                                              bool with_v, uint8_t* Kb,
                                              uint8_t* Vb, uint8_t* Wt,
                                              float* sc) {
  __syncthreads();  // the last tile's readers are done
  stage_k<G>(k, ks, vs, tile, Kb, sc);
  if (with_v)
    tc::load_bytes<G::D, BK, G::THREADS, G::LDB>(Vb, v, tile * BK, 1 << 30);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (with_v) {
    transpose_v<G>(Vb, Wt);
    __syncthreads();
  }
}

// The int8 staircase (onepass route): causal, q_len == kv_len.
template <int D, typename TO>
__global__ void __launch_bounds__(32 * warps_for(D, false), 1)
    quant_onepass_kernel(QParams p) {
  using G = Geo<D, warps_for(D, false), false, false>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qb = smem + G::Q;
  uint8_t* Kb = smem + G::K;
  uint8_t* Vb = smem + G::V;
  uint8_t* Wt = smem + G::W;
  float* sc = reinterpret_cast<float*>(smem + G::SC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const BlockPos bp = block_pos(p);
  const WarpRows w = warp_rows<G::WARPS>(p, bp, warp, true);
  int first, last;
  block_tiles<G::WARPS>(p, bp, true, first, last);
  const long long kv_off = ((long long)bp.b * p.hkv + bp.hk) * p.skv;
  const uint8_t* k = p.k + kv_off * D;
  const uint8_t* v = p.v + kv_off * D;
  const float* ks = p.k_scales + kv_off;
  const float* vs = p.v_scales + kv_off;
  stage_q<G>(p, bp, Qb);
  tc::cp_async_commit();

  float qs[2];
  row_scales(p, bp.b, w, gr, qs);
  const float slope = p.alibi != nullptr ? p.alibi[w.h] : 0.f;
  // Part 0: the prefix [0, lo) (tiles below `split`, unmasked); part 1:
  // the diagonal [lo, lo + 512) up to the warp's last row (masked).
  const int split = (w.p0 / STAIR) * STAIR / BK;
  const uint32_t qt = tc::smem_addr(Qb), kt = tc::smem_addr(Kb);
  const uint32_t wt = tc::smem_addr(Wt);

  // The scores of one tile for the warp (its part in `part`), or false.
  auto scores = [&](int tile, float (&s)[NJ][4], int& part, float (&mx)[2]) {
    if (!(w.first <= tile && tile <= w.last)) return false;
    part = tile < split ? 0 : 1;
    int8_scores<G, false>(s, qt, kt, lane, warp * 16);
    transform<false>(s, p, w, sc, qs, slope, tile * BK, gr, tq, part == 1,
                     false, mx);
    return true;
  };

  // Pass 1: each part's row max.
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  for (int tile = first; tile <= last; ++tile) {
    onepass_stage<G>(k, v, ks, vs, tile, false, Kb, Vb, Wt, sc);
    float s[NJ][4], mx[2];
    int part;
    if (scores(tile, s, part, mx)) {
      m[part][0] = fmaxf(m[part][0], mx[0]);
      m[part][1] = fmaxf(m[part][1], mx[1]);
    }
  }
  // Pass 2: l and max(p * v_scale).
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int tile = first; tile <= last; ++tile) {
    onepass_stage<G>(k, v, ks, vs, tile, false, Kb, Vb, Wt, sc);
    float s[NJ][4], mx[2];
    int part;
    if (scores(tile, s, part, mx)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float pp = expf(__fsub_rn(s[j][e], m[part][h]));
          l[part][h] += pp;
          ps[part][h] = fmaxf(
              ps[part][h], __fmul_rn(pp, sc[BK + 8 * j + 2 * tq + (e & 1)]));
        }
    }
  }
  float a[2][2], mm[2], ll[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int pt = 0; pt < 2; ++pt) {
      l[pt][h] = quad_sum(l[pt][h]);
      const float pabs = quad_max(ps[pt][h]);
      ps[pt][h] = pabs == 0.f ? 1.f : __fdiv_rn(pabs, kInt8Max);
    }
    // The merge: the prefix (part 0) and the diagonal (part 1).
    mm[h] = fmaxf(m[0][h], m[1][h]);
    a[0][h] = expf(__fsub_rn(m[0][h], mm[h]));
    a[1][h] = expf(__fsub_rn(m[1][h], mm[h]));
    ll[h] = __fadd_rn(__fmul_rn(l[0][h], a[0][h]), __fmul_rn(l[1][h], a[1][h]));
  }
  float mult[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) mult[h] = out_mult(p, w.h, mm[h], ll[h]);

  // Pass 3, a 64-column slice of d at a time: P to int8 levels, the exact
  // int32 P V of each part times its p_scale, merged.
  for (int n0 = 0; n0 < D; n0 += DC) {
    float acc[DC / 8][4];
    int iacc[DC / 8][4];
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = 0.f;
        iacc[n][e] = 0;
      }
    for (int tile = first; tile <= last; ++tile) {
      onepass_stage<G>(k, v, ks, vs, tile, true, Kb, Vb, Wt, sc);
      float s[NJ][4], mx[2];
      int part;
      if (!scores(tile, s, part, mx)) continue;
      if (part == 1 && tile == split && split > 0) {
        // The prefix is done: acc = (P V)_0 * a_0.
#pragma unroll
        for (int n = 0; n < DC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[n][e] = __fmul_rn(
                __fmul_rn(__int2float_rn(iacc[n][e]), ps[0][e >> 1]),
                a[0][e >> 1]);
            iacc[n][e] = 0;
          }
      }
      uint32_t lv[NJ][2];  // each n-tile's levels, rows gr and gr + 8
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t pair = 0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * h + i;
            const float pp = expf(__fsub_rn(s[j][e], m[part][h]));
            const float x = rintf(__fdiv_rn(
                __fmul_rn(pp, sc[BK + 8 * j + 2 * tq + i]), ps[part][h]));
            pair |= (uint32_t)fminf(fmaxf(x, 0.f), kInt8Max) << (8 * i);
          }
          lv[j][h] = pair;
        }
#pragma unroll
      for (int q = 0; q < BK / 32; ++q) {
        // A operand of kv columns 32 q ..: k order 4 tq + i <- columns
        // 2 tq + {0, 1, 8, 9}[i] (and + 16), transpose_v's order.
        const uint32_t pa[4] = {
            lv[4 * q][0] | (lv[4 * q + 1][0] << 16),
            lv[4 * q][1] | (lv[4 * q + 1][1] << 16),
            lv[4 * q + 2][0] | (lv[4 * q + 3][0] << 16),
            lv[4 * q + 2][1] | (lv[4 * q + 3][1] << 16)};
#pragma unroll
        for (int n = 0; n < DC; n += 16) {
          uint32_t vb[4];
          tc::ldsm(vb, wt + tc::b_off<G::LDT / 2>(lane, n0 + n, q * 16));
          tc::imma(iacc[n / 8], pa, vb[0], vb[1]);
          tc::imma(iacc[n / 8 + 1], pa, vb[2], vb[3]);
        }
      }
    }
    // out = (P V)_0 a_0 + (P V)_1 a_1 (no prefix: acc = 0, a_1 = 1).
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = __fadd_rn(
            acc[n][e],
            __fmul_rn(__fmul_rn(__int2float_rn(iacc[n][e]), ps[1][e >> 1]),
                      a[1][e >> 1]));
    store_cols<D, DC / 8, TO>(p, bp.b, w, gr, tq, n0, acc, mult);
  }
  tc::cp_async_wait<0>();
}

using KernelFn = void (*)(QParams);

template <int D, typename TO>
KernelFn kernel_for(int mode) {
  switch (mode) {
    case kInt8:
      return quant_fwd_kernel<D, kInt8, TO>;
    case kFp8Soft:
      return quant_fwd_kernel<D, kFp8Soft, TO>;
    case kFp8Native:
      return quant_fwd_kernel<D, kFp8Native, TO>;
    default:
      return quant_onepass_kernel<D, TO>;
  }
}

template <int D>
size_t smem_for(int mode) {
  switch (mode) {
    case kInt8:
      return Geo<D, warps_for(D, false), false, split_for(D, false)>::SMEM;
    case kInt8Onepass:
      return Geo<D, warps_for(D, false), false, false>::SMEM;
    default:
      return Geo<D, warps_for(D, true), true, split_for(D, true)>::SMEM;
  }
}

template <typename TO>
KernelFn kernel_for(int head_dim, int mode, size_t* smem) {
  switch (head_dim) {
    case 64:
      *smem = smem_for<64>(mode);
      return kernel_for<64, TO>(mode);
    case 128:
      *smem = smem_for<128>(mode);
      return kernel_for<128, TO>(mode);
    default:
      *smem = smem_for<256>(mode);
      return kernel_for<256, TO>(mode);
  }
}

int threads_for(int head_dim, int mode) {
  return 32 * warps_for(head_dim, mode == kFp8Soft || mode == kFp8Native);
}

KernelFn kernel_for(int head_dim, int mode, int out_dtype, size_t* smem) {
  return out_dtype == 0 ? kernel_for<float>(head_dim, mode, smem)
                        : kernel_for<__nv_bfloat16>(head_dim, mode, smem);
}

bool served(int head_dim, int mode, int out_dtype) {
  return (head_dim == 64 || head_dim == 128 || head_dim == 256) &&
         mode >= 0 && mode <= 3 && out_dtype >= 0 && out_dtype <= 1;
}

}  // namespace

// mode: 0 int8, 1 fp8 software, 2 fp8 native, 3 int8 staircase (causal,
// sq == skv == kv_len); out_dtype: 0 = float32, 1 = bfloat16; head_dim
// 64, 128 or 256. Returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for an argument this build does not serve.
extern "C" int quant_fwd(const void* q, const void* q_scales, const void* k,
                         const void* k_scales, const void* v,
                         const void* v_scales, void* o, const void* sinks,
                         const void* alibi, long long qs_sb, long long qs_sh,
                         long long qs_sr, int mode, int out_dtype, int batch,
                         int hq, int hkv, int sq, int skv, int kv_len,
                         int head_dim, int causal, int window, float sm_scale,
                         float softcap, float inv_softcap, void* stream) {
  if (!served(head_dim, mode, out_dtype) || skv % BK != 0 || hq % hkv != 0 ||
      kv_len <= 0 || kv_len > skv ||
      (mode == kInt8Onepass && (!causal || sq != skv || kv_len != skv))) {
    return (int)cudaErrorInvalidValue;
  }
  QParams p;
  p.q = static_cast<const uint8_t*>(q);
  p.q_scales = static_cast<const float*>(q_scales);
  p.qs_sb = qs_sb;
  p.qs_sh = qs_sh;
  p.qs_sr = qs_sr;
  p.k = static_cast<const uint8_t*>(k);
  p.k_scales = static_cast<const float*>(k_scales);
  p.v = static_cast<const uint8_t*>(v);
  p.v_scales = static_cast<const float*>(v_scales);
  p.o = o;
  p.sinks = static_cast<const float*>(sinks);
  p.alibi = static_cast<const float*>(alibi);
  p.batch = batch;
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  const int threads = threads_for(head_dim, mode);
  p.nblk = (((sq + 15) / 16) * (hq / hkv) + threads / 32 - 1) / (threads / 32);
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.inv_softcap = inv_softcap;
  size_t smem = 0;
  const KernelFn kernel = kernel_for(head_dim, mode, out_dtype, &smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const long long blocks = (long long)p.nblk * batch * hkv;
  kernel<<<(unsigned)blocks, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The shared memory a block of an instance takes and the blocks of it one
// SM holds (the CUDA occupancy calculator); 1 for an instance this build
// does not have.
extern "C" int quant_fwd_occupancy(int mode, int out_dtype, int head_dim,
                                   int* smem_bytes, int* blocks_per_sm) {
  if (!served(head_dim, mode, out_dtype)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const KernelFn kernel = kernel_for(head_dim, mode, out_dtype, &smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads_for(head_dim, mode), smem);
}
