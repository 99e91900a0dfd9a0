// quant_fwd: attention forward over int8 / e4m3 Q, K, V for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_flash/ops/flash/quantized.py:
//   _quant_fwd_kernel (:99; rectangular grid :772 and triangular grid
//   :761 of flash_attention_quantized) and _quant_onepass_kernel (:281,
//   the opt-in int8 staircase of _forward_onepass_quant :401). As for
//   flash_fwd, the TPU's sequential kv grid axis becomes a loop inside
//   the block that visits only live kv tiles, so one computation serves
//   both grids; the staircase differs in its arithmetic and is its own
//   template instance.
//
// Per (batch, q head, 64-row q tile); GQA by index (kv head = h / (hq /
// hkv)); causal aligned at position 0 of q and kv (no q offset):
//   scores  s = (s_raw * (q_scale * sm_scale)) * k_scale, in that order,
//           s_raw = the exact dot product, rounded to f32 once: int32
//           sums for int8 (__dp4a), int64 sums of e4m3 values scaled by
//           2^9 to integers for fp8 (software and native tiers alike; the
//           TPU kernel sums e4m3 products in f32, so the two can differ by
//           an f32 ulp of a score);
//           softcap; ALiBi slope * (kv_pos - q_pos) on the causal path;
//           causal, window and kv-tail masks to MASK_VALUE (finite).
//   tiled   online softmax over 128-column steps (P rounds after each
//           step's running max, as on the TPU with block_kv = 128);
//           int8 / fp8 software: P V = sum bf16(p * v_scale) * v;
//           fp8 native: c = max_row(p * v_scale), c = c == 0 ? 1 : c / 448,
//           P V = c * sum e4m3(p * v_scale / c) * v;
//           acc = acc * alpha + P V; out = acc / l (l == 0: 1), or the
//           sink-inclusive denominator.
//   onepass int8, causal, q_len == kv_len: each 512-row stair splits into
//           a mask-free prefix [0, lo) and a masked diagonal [lo, lo+512);
//           each part has its own row max m, l = sum p, and quantizes its
//           P rows to int8 over the whole part (p_scale = max(p *
//           v_scale) / 127, clip(rint(p * v_scale / p_scale), 0, 127)),
//           P V an exact int32 dot times p_scale; the parts merge once.
//           A part wider than one staged tile takes three passes over K
//           (row max; l and max(p * v_scale); quantize and P V): scores
//           are exact, so recomputing them costs no error.
// Every f32 step the TPU kernel rounds on its own is rounded on its own
// here (__fmul_rn, __fadd_rn, __fdiv_rn: no contraction; rintf rounds half
// to even), and scores are exact, so the kernel and its plain version
// (ops/flash/quantized.py::quant_fwd_plain) differ only in the order of
// the f32 sums of l and P V, never in a quantization of P.
//
// What bounds it on this card: operations. At a Llama-3-8B 8K causal
// prefill (32 q / 8 kv heads, d 128) it does 5.5e11 operations against
// about 120 MB of bytes, so the bound is the tensor cores' int8/fp8 rate.
// This first kernel is deliberately simple: scores from __dp4a (int8) or
// 32 x 32 -> 64-bit integer multiply-adds (fp8) over tiles staged in
// shared memory, P V as f32 FMAs (or
// int32 multiply-adds on the staircase), each thread owning a 4 x 8
// register tile of S and of O, one block per SM (~197 KB of shared
// memory). Heavy causal q tiles launch first. It runs far above the
// bound; mma/wgmma tiles are later work (ROADMAP item 17).
//
// Layout: q [b, hq, sq, d] int8 or e4m3; q scales read at q_scales[b *
// sb + h * sh + row * sr] (a lane-replicated [b, hq, sq, 128] tensor, or a
// stride-0 expand of [b, hq, sq, 1]); k/v [b, hkv, skv, d] contiguous; k/v
// scales [b, hkv, 1, skv] f32 contiguous; o [b, hq, sq, d] bf16 or f32.
// d = 128; skv a multiple of 128. Each launch runs on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { kInt8 = 0, kFp8Soft = 1, kFp8Native = 2, kInt8Onepass = 3 };

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 128;   // kv columns per staged tile / online-softmax step
constexpr int D = 128;    // head dim (the only one this build serves)
constexpr int THREADS = 256;
constexpr int QS = D + 4;  // padded f32 row strides, 16-byte aligned
constexpr int KS = D + 4;
constexpr int SS = BK + 4;
constexpr int WS = D / 4 + 1;  // padded int32 row stride of int8 rows
constexpr int STAIR = 512;     // rows of one onepass stair
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float kInt8Max = 127.f;
constexpr float kFp8Max = 448.f;

constexpr size_t kSmemBytes =
    sizeof(float) * (BQ * QS + BK * KS + BK * D + BQ * SS + 6 * BQ + 2 * BK);

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
  int hq, hkv, sq, skv, kv_len;
  float sm_scale;
  int causal, window;           // window <= 0: none
  float softcap, inv_softcap;   // softcap <= 0: none
};

__device__ __forceinline__ float e4m3_to_f(uint8_t b) {
  __nv_fp8_e4m3 x;
  x.__x = b;
  return static_cast<float>(x);
}

// Round to nearest even e4m3, saturating at +-448, and back to f32.
__device__ __forceinline__ float round_e4m3(float x) {
  return static_cast<float>(__nv_fp8_e4m3(x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename TO>
__device__ __forceinline__ TO from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Smem {
  float* Qf;      // [BQ][QS] int32 q * 2^9 (fp8), or int32 words [BQ][WS]
  float* Kf;      // [BK][KS] int32 k * 2^9 (fp8), or int32 words [BK][WS]
  float* Vf;      // [BK][D] v values (f32, or int32 on the staircase)
  float* Ss;      // [BQ][SS] scores, then P (int32 P on the staircase)
  float* row_m;   // [BQ] running max
  float* row_l;   // [BQ] running sum
  float* row_a;   // [BQ] this step's rescale
  float* row_c;   // [BQ] fp8 native: this step's P renormalisation
  float* row_qs;  // [BQ] q_scale * sm_scale
  float* row_ps;  // [BQ] staircase: max(p * v_scale), then p_scale
  float* col_ks;  // [BK] k scales of the staged tile
  float* col_vs;  // [BK] v scales of the staged tile

  __device__ explicit Smem(float* base) {
    Qf = base;
    Kf = Qf + BQ * QS;
    Vf = Kf + BK * KS;
    Ss = Vf + BK * D;
    row_m = Ss + BQ * SS;
    row_l = row_m + BQ;
    row_a = row_l + BQ;
    row_c = row_a + BQ;
    row_qs = row_c + BQ;
    row_ps = row_qs + BQ;
    col_ks = row_ps + BQ;
    col_vs = col_ks + BK;
  }
};

// e4m3 values are multiples of 2^-9 below 2^9 in magnitude: times 2^9
// they are integers of at most 18 bits, whose products sum exactly in
// int64.
__device__ __forceinline__ int e4m3_to_i(uint8_t b) {
  return __float2int_rn(e4m3_to_f(b) * 512.f);
}

// Stage 16 payload bytes at element offset `e` of a row into shared memory:
// int8 rows as int32 words (for __dp4a), e4m3 rows as int32 (x * 2^9).
template <int MODE>
__device__ __forceinline__ void stage_row_piece(float* dst, int row, int e,
                                                uint4 raw) {
  if (MODE == kInt8 || MODE == kInt8Onepass) {
    int* w = reinterpret_cast<int*>(dst) + row * WS + e / 4;
    w[0] = (int)raw.x;
    w[1] = (int)raw.y;
    w[2] = (int)raw.z;
    w[3] = (int)raw.w;
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    int* f = reinterpret_cast<int*>(dst) + row * QS + e;
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = e4m3_to_i(b[i]);
  }
}

// Load the K (and, with `with_v`, V) tile at kv row k0 and their scales.
template <int MODE>
__device__ void load_kv_tile(const QParams& p, const Smem& sm,
                             const uint8_t* k, const uint8_t* v,
                             const float* ks, const float* vs, int k0,
                             bool with_v) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BK * D / 16; idx += THREADS) {
    const int r = idx / (D / 16), e = (idx % (D / 16)) * 16;
    const long long off = (long long)(k0 + r) * D + e;
    stage_row_piece<MODE>(sm.Kf, r, e,
                          *reinterpret_cast<const uint4*>(k + off));
    if (with_v) {
      const uint4 raw = *reinterpret_cast<const uint4*>(v + off);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      if (MODE == kInt8Onepass) {
        int* vi = reinterpret_cast<int*>(sm.Vf) + r * D + e;
#pragma unroll
        for (int i = 0; i < 16; ++i) vi[i] = (int)(int8_t)b[i];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          sm.Vf[r * D + e + i] = MODE == kInt8 ? (float)(int8_t)b[i]
                                               : e4m3_to_f(b[i]);
        }
      }
    }
  }
  if (tid < BK) {
    sm.col_ks[tid] = ks[k0 + tid];
    sm.col_vs[tid] = vs[k0 + tid];
  }
}

// Raw scores of the thread's 4 x 8 tile (rows ty*4+i, cols tx+16j).
template <int MODE>
__device__ __forceinline__ void raw_scores(const Smem& sm, int ty, int tx,
                                           float s[4][BK / 16]) {
  if (MODE == kInt8 || MODE == kInt8Onepass) {
    const int* Qi = reinterpret_cast<const int*>(sm.Qf);
    const int* Ki = reinterpret_cast<const int*>(sm.Kf);
    int acc[4][BK / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) acc[i][j] = 0;
#pragma unroll 4
    for (int w = 0; w < D / 4; ++w) {
      int qw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qw[i] = Qi[(ty * 4 + i) * WS + w];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int kw = Ki[(tx + 16 * j) * WS + w];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = __dp4a(qw[i], kw, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) s[i][j] = (float)acc[i][j];
  } else {
    long long acc[4][BK / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) acc[i][j] = 0;
    for (int kk = 0; kk < D; kk += 4) {
      int4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const int4*>(&sm.Qf[(ty * 4 + i) * QS + kk]);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int4 kv =
            *reinterpret_cast<const int4*>(&sm.Kf[(tx + 16 * j) * KS + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          long long a = acc[i][j];
          a += (long long)qv[i].x * kv.x;
          a += (long long)qv[i].y * kv.y;
          a += (long long)qv[i].z * kv.z;
          a += (long long)qv[i].w * kv.w;
          acc[i][j] = a;
        }
      }
    }
    // One rounding to f32, then an exact scaling by 2^-18.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        s[i][j] = __fmul_rn(__ll2float_rn(acc[i][j]), 3.814697265625e-06f);
  }
}

// Scores of the staged tile at kv row k0 into sm.Ss: dequant rescale,
// softcap, ALiBi and masks. `masked`: apply the causal / window masks.
template <int MODE>
__device__ void score_tile(const QParams& p, const Smem& sm, int q0, int k0,
                           float slope, bool masked) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float s[4][BK / 16];
  raw_scores<MODE>(sm, ty, tx, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qpos = q0 + r;
    const float qsc = sm.row_qs[r];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      float x = __fmul_rn(__fmul_rn(s[i][j], qsc), sm.col_ks[c]);
      if (p.softcap > 0.f)
        x = __fmul_rn(p.softcap, tanhf(__fmul_rn(x, p.inv_softcap)));
      bool valid = kpos < p.kv_len;
      if (p.causal) {
        if (masked) {
          valid = valid && kpos <= qpos;
          if (p.window > 0) valid = valid && kpos > qpos - p.window;
        }
        if (p.alibi != nullptr)
          x = __fadd_rn(x, __fmul_rn(slope, (float)(kpos - qpos)));
      }
      sm.Ss[r * SS + c] = valid ? x : MASK_VALUE;
    }
  }
}

// Stage the block's q rows and their scales (q_scale * sm_scale).
template <int MODE>
__device__ void load_q(const QParams& p, const Smem& sm, const uint8_t* q,
                       int b, int h, int q0) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BQ * D / 16; idx += THREADS) {
    const int r = idx / (D / 16), e = (idx % (D / 16)) * 16;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.sq)
      raw = *reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * D + e);
    stage_row_piece<MODE>(sm.Qf, r, e, raw);
  }
  if (tid < BQ) {
    float qs = 0.f;
    if (q0 + tid < p.sq)
      qs = p.q_scales[b * p.qs_sb + h * p.qs_sh + (q0 + tid) * p.qs_sr];
    sm.row_qs[tid] = __fmul_rn(qs, p.sm_scale);
  }
}

// The thread's output rows: o = acc * mult, mult = 1 / l (l == 0: 1) or
// the sink-inclusive denominator.
template <typename TO>
__device__ void write_out(const QParams& p, int b, int h, int q0, int ty,
                          int tx, const float m[4], const float l[4],
                          const float acc[4][D / 16]) {
  TO* o = static_cast<TO*>(p.o) +
          ((long long)b * p.hq + h) * (long long)p.sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= p.sq) continue;
    float mult;
    if (p.sinks != nullptr) {
      const float sk = p.sinks[h];
      const float m2 = fmaxf(m[i], sk);
      const float scale_m = expf(__fsub_rn(m[i], m2));
      const float l_tot =
          __fadd_rn(__fmul_rn(l[i], scale_m), expf(__fsub_rn(sk, m2)));
      mult = __fdiv_rn(scale_m, l_tot);
    } else {
      mult = l[i] == 0.f ? 1.f : __fdiv_rn(1.f, l[i]);
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[(long long)(q0 + r) * D + tx + 16 * j] =
          from_f<TO>(__fmul_rn(acc[i][j], mult));
  }
}

// The tiled routes (rectangular and triangular grids of the TPU kernel).
template <int MODE, typename TO>
__global__ void __launch_bounds__(THREADS)
quant_fwd_kernel(QParams p) {
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw);
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = qt * BQ;
  const long long kv_off = ((long long)b * p.hkv + hk) * (long long)p.skv;
  const uint8_t* k = p.k + kv_off * D;
  const uint8_t* v = p.v + kv_off * D;
  const float* ks = p.k_scales + kv_off;
  const float* vs = p.v_scales + kv_off;
  load_q<MODE>(p, sm, p.q + ((long long)b * p.hq + h) * (long long)p.sq * D,
               b, h, q0);
  if (tid < BQ) {
    sm.row_m[tid] = -INFINITY;
    sm.row_l[tid] = 0.f;
  }
  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;

  // Live kv tiles of this q tile: the triangular grid's active cells.
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int first_tile = 0;
  int last_tile = (p.kv_len + BK - 1) / BK - 1;
  if (p.causal) {
    last_tile = min(last_tile, q_last / BK);
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;
      first_tile = lo > 0 ? lo / BK : 0;
    }
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  for (int tile = first_tile; tile <= last_tile; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous step's readers are done
    load_kv_tile<MODE>(p, sm, k, v, ks, vs, k0, true);
    __syncthreads();
    score_tile<MODE>(p, sm, q0, k0, slope, true);
    __syncthreads();

    // Online softmax and P: 4 threads a row, 32 columns each.
    {
      const int r = tid / 4, part = tid % 4;
      float* srow = sm.Ss + r * SS;
      float mc = -INFINITY;
      for (int c = part * 32; c < part * 32 + 32; ++c) mc = fmaxf(mc, srow[c]);
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_prev = sm.row_m[r];
      const float m_next = fmaxf(m_prev, mc);
      const float alpha = expf(__fsub_rn(m_prev, m_next));
      float lsum = 0.f, cmax = 0.f;
      for (int c = part * 32; c < part * 32 + 32; ++c) {
        const float pp = expf(__fsub_rn(srow[c], m_next));
        lsum += pp;
        const float pv = __fmul_rn(pp, sm.col_vs[c]);
        if (MODE == kFp8Native) {
          srow[c] = pv;
          cmax = fmaxf(cmax, pv);
        } else {
          srow[c] = round_bf16(pv);
        }
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      if (MODE == kFp8Native) {
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
        const float cc = cmax == 0.f ? 1.f : __fdiv_rn(cmax, kFp8Max);
        for (int c = part * 32; c < part * 32 + 32; ++c)
          srow[c] = round_e4m3(__fdiv_rn(srow[c], cc));
        if (part == 0) sm.row_c[r] = cc;
      }
      __syncwarp();
      if (part == 0) {
        sm.row_l[r] = __fadd_rn(__fmul_rn(sm.row_l[r], alpha), lsum);
        sm.row_m[r] = m_next;
        sm.row_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V (fp8 native: + c * (P V)).
    float pv[4][D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) pv[i][j] = 0.f;
    for (int t = 0; t < BK; t += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&sm.Ss[(ty * 4 + i) * SS + t]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int c = tx + 16 * j;
        const float v0 = sm.Vf[(t + 0) * D + c], v1 = sm.Vf[(t + 1) * D + c];
        const float v2 = sm.Vf[(t + 2) * D + c], v3 = sm.Vf[(t + 3) * D + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = pv[i][j];
          a = fmaf(pr[i].x, v0, a);
          a = fmaf(pr[i].y, v1, a);
          a = fmaf(pr[i].z, v2, a);
          a = fmaf(pr[i].w, v3, a);
          pv[i][j] = a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float a = sm.row_a[r];
      const float cc = MODE == kFp8Native ? sm.row_c[r] : 1.f;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float term =
            MODE == kFp8Native ? __fmul_rn(pv[i][j], cc) : pv[i][j];
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], a), term);
      }
    }
  }
  __syncthreads();
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = sm.row_m[ty * 4 + i];
    l[i] = sm.row_l[ty * 4 + i];
  }
  write_out<TO>(p, b, h, q0, ty, tx, m, l, acc);
}

// One part of a stair (tiles [t_first, t_last]): row max m, l, and P V
// with P quantized to int8 over the whole part, into pv (the thread's 4 x
// 8 output tile) and m / l (its 4 rows).
__device__ void onepass_part(const QParams& p, const Smem& sm,
                             const uint8_t* k, const uint8_t* v,
                             const float* ks, const float* vs, int q0,
                             int t_first, int t_last, bool masked,
                             float slope, float m_out[4], float l_out[4],
                             float pv[4][D / 16]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r = tid / 4, part = tid % 4;
  float* srow = sm.Ss + r * SS;
  // Pass 1: the part's row max.
  float m = -INFINITY;
  for (int tile = t_first; tile <= t_last; ++tile) {
    __syncthreads();
    load_kv_tile<kInt8Onepass>(p, sm, k, v, ks, vs, tile * BK, false);
    __syncthreads();
    score_tile<kInt8Onepass>(p, sm, q0, tile * BK, slope, masked);
    __syncthreads();
    for (int c = part * 32; c < part * 32 + 32; ++c) m = fmaxf(m, srow[c]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  // Pass 2: l and max(p * v_scale).
  float lsum = 0.f, pabs = 0.f;
  for (int tile = t_first; tile <= t_last; ++tile) {
    __syncthreads();
    load_kv_tile<kInt8Onepass>(p, sm, k, v, ks, vs, tile * BK, false);
    __syncthreads();
    score_tile<kInt8Onepass>(p, sm, q0, tile * BK, slope, masked);
    __syncthreads();
    for (int c = part * 32; c < part * 32 + 32; ++c) {
      const float pp = expf(__fsub_rn(srow[c], m));
      lsum += pp;
      pabs = fmaxf(pabs, __fmul_rn(pp, sm.col_vs[c]));
    }
  }
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
  pabs = fmaxf(pabs, __shfl_xor_sync(0xffffffffu, pabs, 1));
  pabs = fmaxf(pabs, __shfl_xor_sync(0xffffffffu, pabs, 2));
  const float p_scale = pabs == 0.f ? 1.f : __fdiv_rn(pabs, kInt8Max);
  if (part == 0) {
    sm.row_m[r] = m;
    sm.row_l[r] = lsum;
    sm.row_ps[r] = p_scale;
  }
  // Pass 3: P to int8 levels, exact int32 P V.
  int iacc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) iacc[i][j] = 0;
  int* prow = reinterpret_cast<int*>(srow);
  const int* Pi = reinterpret_cast<const int*>(sm.Ss);
  const int* Vi = reinterpret_cast<const int*>(sm.Vf);
  for (int tile = t_first; tile <= t_last; ++tile) {
    __syncthreads();
    load_kv_tile<kInt8Onepass>(p, sm, k, v, ks, vs, tile * BK, true);
    __syncthreads();
    score_tile<kInt8Onepass>(p, sm, q0, tile * BK, slope, masked);
    __syncthreads();
    for (int c = part * 32; c < part * 32 + 32; ++c) {
      const float pp = expf(__fsub_rn(srow[c], m));
      const float x = rintf(__fdiv_rn(__fmul_rn(pp, sm.col_vs[c]), p_scale));
      prow[c] = (int)fminf(fmaxf(x, 0.f), kInt8Max);
    }
    __syncthreads();
    for (int t = 0; t < BK; ++t) {
      int pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Pi[(ty * 4 + i) * SS + t];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int vv = Vi[t * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) iacc[i][j] += pr[i] * vv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty * 4 + i;
    m_out[i] = sm.row_m[rr];
    l_out[i] = sm.row_l[rr];
    const float ps = sm.row_ps[rr];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      pv[i][j] = __fmul_rn(__int2float_rn(iacc[i][j]), ps);
  }
}

// The int8 staircase (onepass route): causal, q_len == kv_len.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
quant_onepass_kernel(QParams p) {
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = qt * BQ;
  const long long kv_off = ((long long)b * p.hkv + hk) * (long long)p.skv;
  const uint8_t* k = p.k + kv_off * D;
  const uint8_t* v = p.v + kv_off * D;
  const float* ks = p.k_scales + kv_off;
  const float* vs = p.v_scales + kv_off;
  load_q<kInt8Onepass>(
      p, sm, p.q + ((long long)b * p.hq + h) * (long long)p.sq * D, b, h, q0);
  const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
  const int lo = (q0 / STAIR) * STAIR;  // this stair's first row
  const int q_last = min(q0 + BQ, p.sq) - 1;

  float m2[4], l2[4], pv2[4][D / 16];
  // The masked diagonal [lo, lo + STAIR): tiles past this block's last
  // row are masked for all of its rows and add exactly nothing.
  onepass_part(p, sm, k, v, ks, vs, q0, lo / BK, q_last / BK, true, slope, m2,
               l2, pv2);
  if (lo == 0) {
    write_out<TO>(p, b, h, q0, ty, tx, m2, l2, pv2);
    return;
  }
  float m1[4], l1[4], pv1[4][D / 16];
  onepass_part(p, sm, k, v, ks, vs, q0, 0, lo / BK - 1, false, slope, m1, l1,
               pv1);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = fmaxf(m1[i], m2[i]);
    const float a1 = expf(__fsub_rn(m1[i], m[i]));
    const float a2 = expf(__fsub_rn(m2[i], m[i]));
    l[i] = __fadd_rn(__fmul_rn(l1[i], a1), __fmul_rn(l2[i], a2));
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      pv1[i][j] = __fadd_rn(__fmul_rn(pv1[i][j], a1), __fmul_rn(pv2[i][j], a2));
  }
  write_out<TO>(p, b, h, q0, ty, tx, m, l, pv1);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const QParams& p, int batch,
                  cudaStream_t stream) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kSmemBytes);
  dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  kernel<<<grid, THREADS, kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_mode(const QParams& p, int mode, int batch, cudaStream_t s) {
  switch (mode) {
    case kInt8:
      return launch_kernel(quant_fwd_kernel<kInt8, TO>, p, batch, s);
    case kFp8Soft:
      return launch_kernel(quant_fwd_kernel<kFp8Soft, TO>, p, batch, s);
    case kFp8Native:
      return launch_kernel(quant_fwd_kernel<kFp8Native, TO>, p, batch, s);
    default:
      return launch_kernel(quant_onepass_kernel<TO>, p, batch, s);
  }
}

}  // namespace

// mode: 0 int8, 1 fp8 software, 2 fp8 native, 3 int8 staircase (causal,
// sq == skv == kv_len); out_dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for an
// argument this build does not serve.
extern "C" int quant_fwd(const void* q, const void* q_scales, const void* k,
                         const void* k_scales, const void* v,
                         const void* v_scales, void* o, const void* sinks,
                         const void* alibi, long long qs_sb, long long qs_sh,
                         long long qs_sr, int mode, int out_dtype, int batch,
                         int hq, int hkv, int sq, int skv, int kv_len,
                         int head_dim, int causal, int window, float sm_scale,
                         float softcap, float inv_softcap, void* stream) {
  if (head_dim != D || mode < 0 || mode > 3 || out_dtype < 0 ||
      out_dtype > 1 || skv % BK != 0 || hq % hkv != 0 ||
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
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.inv_softcap = inv_softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? launch_mode<float>(p, mode, batch, s)
                        : launch_mode<__nv_bfloat16>(p, mode, batch, s);
}
