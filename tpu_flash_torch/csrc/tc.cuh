// tc.cuh: the tensor-core primitives of the port's attention kernels on
// sm_90a: cp.async staging, ldmatrix fragments and mma.sync m16n8k16 (bf16
// in, f32 sums) for the bf16 kernels (flash_fwd.cu, variant_fwd.cu through
// fwd_tile.cuh, and flash_bwd.cu); for the quantized-input forward
// (quant_fwd.cu) also byte tiles, mma.sync m16n8k32 over int8 (exact s32
// sums), m16n8k16 over fp16, and exact widenings of int8 and e4m3.
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
