// tc.cuh: the tensor-core primitives of the port's attention kernels on
// sm_90a: cp.async staging, ldmatrix fragments and mma.sync m16n8k16 (bf16
// in, f32 sums) for the bf16 kernels (flash_fwd.cu, variant_fwd.cu through
// fwd_tile.cuh, flash_bwd.cu and attn_weights.cu); for the quantized-input
// forward (quant_fwd.cu) also byte tiles, mma.sync m16n8k32 over int8
// (exact s32 sums), m16n8k16 over fp16, and exact widenings of int8 and
// e4m3; for f32 inputs (flash_bwd.cu, attn_weights.cu) the three-pass
// TF32 product on mma.sync m16n8k8.
//
// Shared-memory tiles are [rows][LD] bf16 with LD = D + 8: a row is
// padded by 8 elements, so the eight 16-byte rows an ldmatrix reads fall
// in eight different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !ok (src is then
// not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory, each lane giving one row
// address (lanes 8i..8i+7 the rows of matrix i); .trans transposes each.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), d 16 x 8 f32. A lane (group
// gr = lane / 4, tq = lane % 4) holds d's elements (gr, 2 tq + {0, 1}) in
// d[0..1] and (gr + 8, 2 tq + {0, 1}) in d[2..3].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest even into one bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of the 16 x 16 slice c of a 16-row accumulator (its
// n-tiles 2c and 2c + 1), each value rounded to bf16: an accumulator
// tile's layout is the A fragment's.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[N][4],
                                     int c) {
  a[0] = pack(x[2 * c][0], x[2 * c][1]);
  a[1] = pack(x[2 * c][2], x[2 * c][3]);
  a[2] = pack(x[2 * c + 1][0], x[2 * c + 1][1]);
  a[3] = pack(x[2 * c + 1][2], x[2 * c + 1][3]);
}

// Byte offsets of a lane's ldmatrix row address in a [rows][LD] tile:
// A operand (or B stored k-major, with .trans) of the 16 x 16 block at
// (r0, c0), and B stored n-major (two n-tiles: rows n0..n0+15, k c0..+15).
template <int LD>
__device__ __forceinline__ uint32_t a_off(int lane, int r0, int c0) {
  return 2u * ((r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}
template <int LD>
__device__ __forceinline__ uint32_t b_off(int lane, int n0, int c0) {
  return 2u * ((n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
               ((lane >> 3) & 1) * 8);
}

// Rows [r0, r0 + R) of a [rows, D] bf16 matrix into a [R][LD] tile, rows
// at or past `rows` as zeros.
template <int D, int R, int NT, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int rows) {
  constexpr int CPR = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src,
               ok);
  }
}

// ---- f32 operands: three-pass TF32 ----------------------------------------
//
// The counterpart of the TPU's f32 dot at Precision.HIGHEST (a multi-pass
// bf16 product with f32 accuracy): each f32 operand x is split into hi =
// tf32(x) and lo = tf32(x - hi) (round to nearest, ties away; x - hi is
// exact), and each product a b is taken as lo_a hi_b + hi_a lo_b + hi_a
// hi_b on mma.sync m16n8k8 (tf32 in, f32 sums), the small terms first;
// lo_a lo_b, about 2^-22 of the product, is dropped. The rounding is
// cvt.rna.tf32.f32's, done on the bits: mma reads the top 19 bits of a
// tf32 operand, so adding half of the 13 dropped bits' range to the
// magnitude rounds to nearest, ties away (two integer operations; the cvt
// instruction made the f32 backward slower in a trial build).
//
// Tiles are [rows][LD] f32 with LD = D + 4 (LD = 4 mod 32). ldmatrix reads
// an 8 x 4 block of floats as an 8 x 8 b16 matrix and hands each lane the
// float (gr, tq): the tf32 fragment's layout, so row-major A and n-major B
// operands come four 8 x 4 blocks an instruction, their 8 rows of 16
// bytes in 32 distinct banks. A k-major B operand (tf32_ldb_t) is read one
// float a lane in the k order of tf32_to_a, rows 2 tq and 2 tq + 1, at
// bank 8 tq + gr.

// hi and lo of x as mma operands (their low 13 bits, which mma does not
// read, left as they fall).
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) + 0x1000u;
}
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return tf32_hi(x - __uint_as_float(tf32_hi(x) & 0xffffe000u));
}
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_hi(x);
  lo = tf32_lo(x);
}

// d += a b over tf32: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8 f32 (mma's
// layout). A lane (gr, tq) holds a (gr, tq), (gr + 8, tq), (gr, tq + 4),
// (gr + 8, tq + 4) and b (k tq, n gr), (k tq + 4, n gr).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^d as 2^(d log2 e) on the special-function unit (ex2.approx, 2^-22
// relative; with the product's rounding within 2^-20 of e^d for |d| < 64,
// and 0 where e^d < 2^-126): the f32 kernels' P, far inside their bars of
// 2^-12 of a row's largest value.
__device__ __forceinline__ float exp_sfu(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d * 1.4426950408889634f));
  return r;
}

// An operand split in two: hi and lo, each in mma's tf32 layout.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

// d += a b in three passes, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}
// The same with the small terms summed apart (d + small is the product's
// sum, added once at the end of a dot): two shorter chains of dependent
// mma instead of one, and the small terms' sum meets none of the large
// terms' roundings.
__device__ __forceinline__ void mma3(float (&d)[4], float (&small)[4],
                                     const Split<4>& a, const Split<2>& b) {
  mma_tf32(small, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(small, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// The A operand (16 x 8) at (r0, c0) of row-major [rows][LD] tiles that
// hold an f32 operand already split (hi and lo).
template <int LD>
__device__ __forceinline__ void tf32_lda(Split<4>& a, const uint32_t* hi,
                                         const uint32_t* lo, int lane, int r0,
                                         int c0) {
  const int i = lane >> 3;
  const int at = (r0 + (lane & 7) + 8 * (i & 1)) * LD + c0 + 4 * (i >> 1);
  ldsm(a.hi, smem_addr(hi + at));
  ldsm(a.lo, smem_addr(lo + at));
}
// The A operand (16 x 8) at (r0, c0) of a row-major [rows][LD] f32 tile.
template <int LD>
__device__ __forceinline__ void tf32_lda(Split<4>& a, const float* t,
                                         int lane, int r0, int c0) {
  const int i = lane >> 3;
  uint32_t r[4];
  ldsm(r, smem_addr(t + (r0 + (lane & 7) + 8 * (i & 1)) * LD + c0 +
                    4 * (i >> 1)));
#pragma unroll
  for (int e = 0; e < 4; ++e)
    tf32_split(__uint_as_float(r[e]), a.hi[e], a.lo[e]);
}
// The B operands (8 x 8) of n-tiles n0 and n0 + 8 at k c0 of an n-major
// tile (rows n, k along a row).
template <int LD>
__device__ __forceinline__ void tf32_ldb2(Split<2>& b0, Split<2>& b1,
                                          const float* t, int lane, int n0,
                                          int c0) {
  const int i = lane >> 3;
  uint32_t r[4];
  ldsm(r, smem_addr(t + (n0 + (lane & 7) + 8 * (i >> 1)) * LD + c0 +
                    4 * (i & 1)));
  tf32_split(__uint_as_float(r[0]), b0.hi[0], b0.lo[0]);
  tf32_split(__uint_as_float(r[1]), b0.hi[1], b0.lo[1]);
  tf32_split(__uint_as_float(r[2]), b1.hi[0], b1.lo[0]);
  tf32_split(__uint_as_float(r[3]), b1.hi[1], b1.lo[1]);
}
// The same from a tile whose lo parts were split once beside it (a
// [rows][LD] plane lo, tf32_lo_rows): hi is one add from the f32 value.
template <int LD>
__device__ __forceinline__ void tf32_ldb2(Split<2>& b0, Split<2>& b1,
                                          const float* t, const uint32_t* lo,
                                          int lane, int n0, int c0) {
  const int i = lane >> 3;
  const int at = (n0 + (lane & 7) + 8 * (i >> 1)) * LD + c0 + 4 * (i & 1);
  uint32_t h[4], l[4];
  ldsm(h, smem_addr(t + at));
  ldsm(l, smem_addr(lo + at));
  b0.hi[0] = h[0] + 0x1000u;
  b0.hi[1] = h[1] + 0x1000u;
  b1.hi[0] = h[2] + 0x1000u;
  b1.hi[1] = h[3] + 0x1000u;
  b0.lo[0] = l[0];
  b0.lo[1] = l[1];
  b1.lo[0] = l[2];
  b1.lo[1] = l[3];
}
// The lo parts of rows [0, R) (columns [0, D)) of a [R][LD] f32 tile into
// the plane lo, the block's NT threads four floats at a time.
template <int D, int R, int NT, int LD>
__device__ __forceinline__ void tf32_lo_rows(uint32_t* lo, const float* t) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int at = i / CPR * LD + i % CPR * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + at);
    *reinterpret_cast<uint4*>(lo + at) =
        make_uint4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
  }
}
// The B operand (8 x 8) of a k-major tile (rows k0.., n from n0), its k
// in tf32_to_a's order: k tq is row 2 tq, k tq + 4 row 2 tq + 1.
template <int LD>
__device__ __forceinline__ void tf32_ldb_t(Split<2>& b, const float* t,
                                           int lane, int k0, int n0) {
  const float* p = t + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  tf32_split(p[0], b.hi[0], b.lo[0]);
  tf32_split(p[LD], b.hi[1], b.lo[1]);
}
// The same from a tile and its plane of lo parts.
template <int LD>
__device__ __forceinline__ void tf32_ldb_t(Split<2>& b, const float* t,
                                           const uint32_t* lo, int lane,
                                           int k0, int n0) {
  const int at = (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  b.hi[0] = tf32_hi(t[at]);
  b.hi[1] = tf32_hi(t[at + LD]);
  b.lo[0] = lo[at];
  b.lo[1] = lo[at + LD];
}
// The A operand (16 x 8) of one accumulator n-tile x (a lane's (gr, 2 tq),
// (gr, 2 tq + 1), (gr + 8, 2 tq), (gr + 8, 2 tq + 1)), no shuffle: its k
// tq is the tile's column 2 tq and k tq + 4 column 2 tq + 1.
__device__ __forceinline__ void tf32_to_a(Split<4>& a, const float (&x)[4]) {
  tf32_split(x[0], a.hi[0], a.lo[0]);
  tf32_split(x[2], a.hi[1], a.lo[1]);
  tf32_split(x[1], a.hi[2], a.lo[2]);
  tf32_split(x[3], a.hi[3], a.lo[3]);
}

// Rows [r0, r0 + R) of a [rows, D] f32 matrix into a [R][LD] tile, rows
// at or past `rows` as zeros.
template <int D, int R, int NT, int LD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int rows) {
  constexpr int CPR = D / 4;  // 16-byte pieces a row
#pragma unroll
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src,
               ok);
  }
}

// ---- 8-bit operands (the quantized-input forward, quant_fwd.cu) ----------
//
// Byte tiles are [rows][LDB] bytes with LDB = width + 16, so eight rows an
// ldmatrix reads again fall in eight bank groups. ldmatrix reads 16-byte
// rows whatever their type, so a_off / b_off with LD = LDB / 2 and the
// column counted in byte pairs give the 8-bit fragments of m16n8k32: a
// 32-byte column chunk at byte c0 is (LD units) column c0 / 2, and a lane
// (gr, tq) receives bytes 4 tq .. 4 tq + 3 of its rows in each 16 bytes,
// which is the s8 operand layout (A: a[0] row gr, bytes 4 tq.., a[1] row
// gr + 8, a[2] / a[3] the same 16 bytes on; B: b0, b1 the two 16-byte
// halves of its n row).

// d += a b over int8: a 16 x 32 (row), b 32 x 8 (col), d 16 x 8 s32, exact
// (d's layout is mma's).
__device__ __forceinline__ void imma(int (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over fp16 (mma's layouts), f32 sums.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + R) of a [rows, W] byte matrix into a [R][LDB] tile, rows
// at or past `rows` as zeros.
template <int W, int R, int NT, int LDB>
__device__ __forceinline__ void load_bytes(uint8_t* dst, const uint8_t* src,
                                           int r0, int rows) {
  constexpr int CPR = W / 16;
#pragma unroll
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LDB + c, ok ? src + (long long)(r0 + r) * W + c : src,
               ok);
  }
}

// Exact widenings. Every int8 value and every e4m3 value is a bf16 value
// and an fp16 value.
// The bytes 0, 1 (lo) or 2, 3 (hi) of w, e4m3, as an fp16 pair (the lower
// byte in the lower half): one cvt.rn.f16x2.e4m3x2.
__device__ __forceinline__ uint32_t e4m3x2_f16(uint32_t w, bool hi) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(hi ? w >> 16 : w & 0xffffu),
      __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}
// Byte i of w as f32: int8 (2^23 + (x + 128), then - (2^23 + 128): exact)
// or e4m3.
__device__ __forceinline__ float int8_f32(uint32_t w, int i) {
  const uint32_t u = ((w >> (8 * i)) & 0xffu) ^ 0x80u;
  return __int_as_float(0x4b000000 | u) - 8388736.f;
}
__device__ __forceinline__ float2 e4m3x2_f32(uint32_t w, bool hi) {
  const uint32_t h = e4m3x2_f16(w, hi);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}
// Four bytes of w (int8 or e4m3, byte 0 first) as two bf16 pairs.
template <bool E4M3>
__device__ __forceinline__ void widen4_bf16(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  if (E4M3) {
    const float2 a = e4m3x2_f32(w, false), b = e4m3x2_f32(w, true);
    lo = pack(a.x, a.y);
    hi = pack(b.x, b.y);
  } else {
    lo = pack(int8_f32(w, 0), int8_f32(w, 1));
    hi = pack(int8_f32(w, 2), int8_f32(w, 3));
  }
}

}  // namespace tc
