// quantize_rows: per-row int8 absmax quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_flash/ops/quant/quantize.py::
// _quant_kernel (:253, launched by quantize_pallas :263). Per row of d
// values (f32, bf16 or f16, read as f32):
//   absmax = max |x|;  scale = absmax == 0 ? 1 : absmax / 127  (IEEE);
//   q = clip(rint(x / scale), -127, 127)  (IEEE division, half to even)
// written as int8 values and one f32 scale per row. The TPU kernel wrote
// its scales lane-replicated [n, 128] (a tiling artifact); this one writes
// [n] and the wrapper returns the public [..., rows, 1].
//
// What bounds it on this card: bytes. It reads each input once and writes
// one byte per element plus four per row (about 100 MB at a Llama-3-8B
// 8K-token q, 0.03 ms at 3.35 TB/s); its operations are a few per element.
// Design: one warp per row, each lane reading 8-byte (bf16/f16, 4 values)
// or 16-byte (f32, 4 values) pieces of d = 128 in one coalesced sweep
// (rows of other widths loop), the absmax reduced by warp shuffles, the
// values held in registers between the two passes when d <= 128. Each
// launch runs on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows per block
constexpr float QMAX = 127.f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ int8_t quant(float x, float scale) {
  const float y = rintf(__fdiv_rn(x, scale));
  return (int8_t)fminf(fmaxf(y, -QMAX), QMAX);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                     float* __restrict__ scales, long long n, int d) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + row * d;
  int8_t* vr = values + row * d;
  constexpr int HELD = 4;  // values a lane keeps when d <= 128
  float held[HELD];
  float amax = 0.f;
  if (d == 128) {
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      held[i] = to_f(xr[lane * HELD + i]);
      amax = fmaxf(amax, fabsf(held[i]));
    }
  } else {
    for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(to_f(xr[c])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, QMAX);
  if (d == 128) {
    char4 out;
    out.x = quant(held[0], scale);
    out.y = quant(held[1], scale);
    out.z = quant(held[2], scale);
    out.w = quant(held[3], scale);
    reinterpret_cast<char4*>(vr)[lane] = out;
  } else {
    for (int c = lane; c < d; c += 32) vr[c] = quant(to_f(xr[c]), scale);
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T>
int launch(const void* x, void* values, void* scales, long long n, int d,
           cudaStream_t stream) {
  const long long blocks = (n + WARPS - 1) / WARPS;
  quantize_rows_kernel<T><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(values),
      static_cast<float*>(scales), n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, d] contiguous; dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// values [n, d] int8 and scales [n] f32 out. Returns cudaGetLastError()
// after the launch; 1 (cudaErrorInvalidValue) for a dtype this build does
// not serve or an empty row.
extern "C" int quantize_rows(const void* x, void* values, void* scales,
                             long long n, int d, int dtype, void* stream) {
  if (d <= 0 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, values, scales, n, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, values, scales, n, d, s);
  return launch<__half>(x, values, scales, n, d, s);
}
