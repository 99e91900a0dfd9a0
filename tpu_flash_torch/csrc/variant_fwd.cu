// variant_fwd: the causal-forward variant harness's kernel for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of tpu_flash/bench/experiments.py
// (:30, launched by variant_attention :119, pallas_call :135): a
// standalone copy of the causal forward, parametrized so that variants can
// be A/B'd on the card before a winner goes into the product kernel. One
// template instance per variant:
//   MASK_ALL  true: "always" (compare and select on every step); false:
//             "diag" (only a step that crosses a warp's diagonal is
//             masked; a step wholly below it takes every score as it is);
//   EXP2      exp2f with log2 e folded into the q scale (by the wrapper),
//             against expf;
//   BQ, BKM, BKV  the three block sizes. The TPU's are VMEM tiles of up to
//             1024 rows; here they mean: BQ q rows per thread block (BQ /
//             16 warps), BKM kv rows staged in shared memory per stage
//             (the TPU's block_kv_major), BKV kv rows per online-softmax
//             step (the TPU's block_kv, which fixes where P is rounded).
//
// Computes, per (batch, head, BQ-row q tile), the TPU kernel's arithmetic:
// q' = bf16(q * scale) (the wrapper rounds the scale to bf16, as JAX
// multiplies a bf16 q by a weakly typed scalar); for each kv stage up to
// the one holding the tile's last row (the TPU's clamped kv index), for
// each BKV-row step: s = q' k^T in f32; masked scores MASK_VALUE; m_next =
// max(m, rowmax s); alpha = exp(m - m_next); p = exp(s - m_next); l = l
// alpha + sum p; acc = acc alpha + bf16(p) v in f32. Then o = bf16(acc *
// (1 / l)) with l = 0 taken as 1. No lse. A step wholly above a warp's 16
// rows is not computed: every p there is exactly 0 and alpha exactly 1.
//
// What bounds it on this card: operations. At the sweep's shape (b 1, h 32,
// s 2048, d 128, causal) it does 34.4 GFLOP on 16.8 MB of q/k/v/o, some
// 2000 FLOPs a byte against the ~295 ridge: the bound is the tensor cores'
// 989 TFLOP/s (0.035 ms). The body is the product forward's
// (fwd_tile.cuh): mma.sync m16n8k16 bf16 tiles from ldmatrix fragments,
// K and V streamed by cp.async, S, the softmax and P in registers. wgmma
// and TMA are later work.
//
// Layout: q/k/v/o [b, h, s, 128] bf16, contiguous and 16-byte aligned, s a
// multiple of BQ and BKM, BKM a multiple of BKV. Each launch runs on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwd_tile.cuh"

namespace {

constexpr int D = 128;  // head width (the sweep's, the only one built)

using tc::bf16;

// Causal with q_len = kv_len, for one warp's 16 rows from wq0.
template <bool MASK_ALL, int BKV>
struct CausalScore {
  int wq0;
  __device__ bool skip(int k0) const { return k0 > wq0 + 15; }
  __device__ bool masked(int k0) const {
    return MASK_ALL || k0 + BKV - 1 > wq0;
  }
  __device__ float operator()(float s, int row, int col, bool masked) const {
    return masked && col > row ? tc::FWD_MASK_VALUE : s;
  }
  __device__ bool plain() const { return true; }
  __device__ float unit(float s) const { return s; }
};

template <bool MASK_ALL, bool EXP2, int BQ, int BKM, int BKV>
__global__ void __launch_bounds__(BQ * 2)
    variant_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int heads, int seq, float scale) {
  using G = tc::FwdTiles<D, BQ, BKM, BKV>;
  extern __shared__ __align__(16) unsigned char smem[];
  // The heaviest (last) q tiles first, so the last wave is the lightest.
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const long long base = ((long long)b * heads + h) * (long long)seq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const CausalScore<MASK_ALL, BKV> score{q0 + warp * 16};
  tc::FwdRows<D> r;
  // kv stages up to the one holding the tile's last row (the TPU's kv
  // index clamp; stages past it never run).
  tc::fwd_block<G, EXP2>(q + base, k + base, v + base, q0, seq, seq, scale,
                         0, (q0 + BQ - 1) / BKM, score, r, smem);

  // Deferred normalisation: acc * (1 / l), l = 0 taken as 1.
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float l = r.l[half];
    tc::fwd_store_row<D>(o + base + (long long)(row0 + 8 * half) * D, r, half,
                         l == 0.f ? 1.f : 1.f / l);
  }
}

template <bool MASK_ALL, bool EXP2, int BQ, int BKM, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int seq, float scale, cudaStream_t stream) {
  using G = tc::FwdTiles<D, BQ, BKM, BKV>;
  auto kernel = variant_fwd_kernel<MASK_ALL, EXP2, BQ, BKM, BKV>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid(seq / BQ, heads, batch);
  kernel<<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), heads, seq, scale);
  return (int)cudaGetLastError();
}

template <int BQ, int BKM, int BKV>
int launch_flags(bool mask_all, bool exp2, const void* q, const void* k,
                 const void* v, void* o, int batch, int heads, int seq,
                 float scale, cudaStream_t s) {
  if (mask_all) {
    return exp2 ? launch<true, true, BQ, BKM, BKV>(q, k, v, o, batch, heads,
                                                   seq, scale, s)
                : launch<true, false, BQ, BKM, BKV>(q, k, v, o, batch,
                                                    heads, seq, scale, s);
  }
  return exp2 ? launch<false, true, BQ, BKM, BKV>(q, k, v, o, batch, heads,
                                                  seq, scale, s)
              : launch<false, false, BQ, BKM, BKV>(q, k, v, o, batch, heads,
                                                   seq, scale, s);
}

}  // namespace

// The built tile shapes (block_q, block_kv_major, block_kv), as
// ops/flash/variant.py::KERNEL_TILES lists them.
#define VARIANT_TILES(X) \
  X(64, 128, 64)         \
  X(64, 128, 128)        \
  X(128, 128, 64)        \
  X(128, 128, 128)       \
  X(64, 64, 64)

// q/k/v/o bf16 [batch, heads, seq, head_dim]; mask_mode 1 = "always", 0 =
// "diag"; use_exp2 0/1; scale already rounded to bf16 (and holding log2 e
// under exp2). Returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a head_dim, tile shape or sequence length
// this build does not serve.
extern "C" int variant_fwd(const void* q, const void* k, const void* v,
                           void* o, int batch, int heads, int seq,
                           int head_dim, float scale, int block_q,
                           int block_kv_major, int block_kv, int mask_mode,
                           int use_exp2, void* stream) {
  if (head_dim != D || seq <= 0 || seq % block_q != 0 ||
      seq % block_kv_major != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VARIANT_CASE(BQ, BKM, BKV)                                         \
  if (block_q == BQ && block_kv_major == BKM && block_kv == BKV)          \
    return launch_flags<BQ, BKM, BKV>(mask_mode != 0, use_exp2 != 0, q, k, \
                                      v, o, batch, heads, seq, scale, s);
  VARIANT_TILES(VARIANT_CASE)
#undef VARIANT_CASE
  return (int)cudaErrorInvalidValue;
}
