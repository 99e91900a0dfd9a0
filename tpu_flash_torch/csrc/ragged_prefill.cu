// ragged_prefill: mixed-stage chunk attention over dense
// [history padded to hist_cap | chunk] K/V, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ragged_prefill_kernel
// (tpu_flash/ops/flash/ragged.py:56, launched at :425 by
// flash_attention_ragged). The TPU kernel precomputes a kv-block index
// map from the per-row offsets so that dead tiles alias a live one and
// their DMAs are elided; here each thread block loads its row's offset and
// skips every tile no row of it can see.
//
// Computes, per (batch row b, kv head, block of chunk positions), for the
// q_per_kv query heads of that kv head stacked in one 64-row tile: query
// row i (absolute position q_offsets[b] + i) attends history columns
// j < q_offsets[b] and chunk columns hist_cap + c with c <= i, optionally
// inside a sliding window; softcap, ALiBi (history column j sits at
// position j, chunk column at q_offsets[b] + c), sinks. The kv axis is
// walked in tiles of block_kv columns from column 0 (TileSizes'
// ragged_block_kv, one online-softmax step each, as the plain version
// steps them). History columns in [q_offsets[b], hist_cap) hold garbage:
// they load as zeros and are masked, so they never reach a sum.
//
// What bounds it on this card: as a prefill chunk, FLOPs (tensor cores,
// 989 TFLOP/s bf16); this first kernel runs f32 FMAs on the CUDA cores
// (prefill_tile.cuh), far below that; wgmma and TMA are later work.
//
// Layout: q [b, hq, q_len, d]; k/v [b, hkv, hist_cap + q_len, d] in q's
// dtype; q_offsets int32 [b]; o like q; all contiguous.

#include "prefill_tile.cuh"

namespace {

using namespace prefill;

struct RaggedParams {
  RowParams rp;
  const void* k;  // [b, hkv, hist_cap + q_len, d]
  const void* v;
  const int* offsets;  // [b] history length per row (<= hist_cap)
  int hist_cap, block_kv;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ragged_prefill_kernel(RaggedParams rg) {
  extern __shared__ float smem[];
  const RowParams& p = rg.rp;
  const Smem sm(smem);
  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const Rows rows{kvh, qt * p.qp, p.g, p.qp, p.q_len};
  const int p_lo = rows.q_first;
  const int p_hi = min(p_lo + p.qp, p.q_len) - 1;
  const int offs = min(rg.offsets[b], rg.hist_cap);
  const int hc = rg.hist_cap;
  const int kv_len = hc + p.q_len;
  const int window = p.window;
  load_q<T>(p, rows, sm, b);
  RowInfo ri[4];
  row_infos(p, rows, ri);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const long long bh = (long long)b * p.hkv + kvh;
  const T* kbase = static_cast<const T*>(rg.k) + bh * kv_len * D;
  const T* vbase = static_cast<const T*>(rg.v) + bh * kv_len * D;
  auto src = [&](int j) -> long long {
    const bool real = j < hc ? j < offs : j - hc < p.q_len;
    return real ? (long long)j : -1LL;
  };
  auto live = [&](int j0, int j1) {
    bool hist = j0 < offs;
    bool chunk = j1 > hc && j0 <= hc + p_hi;
    if (window > 0) {
      hist = hist && j1 - 1 > offs + p_lo - window;
      chunk = chunk && j1 - 1 - hc > p_lo - window;
    }
    return hist || chunk;
  };
  auto mask = [&](const RowInfo& row, int j, float x) {
    if (!row.active) return MASK_VALUE;
    const int i = row.pos;
    bool valid;
    int dist;
    if (j < hc) {
      valid = j < offs;
      if (window > 0) valid = valid && j > offs + i - window;
      dist = j - offs - i;
    } else {
      valid = j - hc <= i;
      if (window > 0) valid = valid && j - hc > i - window;
      dist = j - hc - i;
    }
    if (p.alibi != nullptr) x += row.slope * (float)dist;
    return valid ? x : MASK_VALUE;
  };
  const int n_tiles = (kv_len + rg.block_kv - 1) / rg.block_kv;
  const int last_tile = min(n_tiles - 1, (hc + p_hi) / rg.block_kv);
  for (int t = 0; t <= last_tile; ++t)
    attend_block<T>(p, sm, ri, acc, t * rg.block_kv, rg.block_kv, kbase,
                    vbase, (const float*)nullptr, (const float*)nullptr, src,
                    live, mask);
  store_rows<T>(p, rows, sm, acc, b);
}

template <typename T>
int launch(const RaggedParams& rg, int batch, cudaStream_t stream) {
  cudaFuncSetAttribute(ragged_prefill_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kSmemBytes);
  dim3 grid((rg.rp.q_len + rg.rp.qp - 1) / rg.rp.qp, rg.rp.hkv, batch);
  ragged_prefill_kernel<T><<<grid, THREADS, kSmemBytes, stream>>>(rg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a configuration this build does not serve.
extern "C" int ragged_prefill(
    const void* q, const void* k, const void* v, const void* q_offsets,
    const void* sinks, const void* alibi, void* o, int dtype, int batch,
    int hq, int hkv, int q_len, int hist_cap, int block_kv, int head_dim,
    float scale, int window, float softcap, float inv_softcap,
    void* stream) {
  if (head_dim != D || hq % hkv != 0 || hq / hkv > BQ ||
      (dtype != 0 && dtype != 1) || block_kv <= 0 || q_len <= 0 ||
      hist_cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  RaggedParams rg;
  rg.rp.q = q;
  rg.rp.o = o;
  rg.rp.sinks = static_cast<const float*>(sinks);
  rg.rp.alibi = static_cast<const float*>(alibi);
  rg.rp.hq = hq;
  rg.rp.hkv = hkv;
  rg.rp.g = hq / hkv;
  rg.rp.qp = BQ / rg.rp.g;
  rg.rp.q_len = q_len;
  rg.rp.scale = scale;
  rg.rp.window = window;
  rg.rp.softcap = softcap;
  rg.rp.inv_softcap = inv_softcap;
  rg.rp.page_size = 0;
  rg.k = k;
  rg.v = v;
  rg.offsets = static_cast<const int*>(q_offsets);
  rg.hist_cap = hist_cap;
  rg.block_kv = block_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(rg, batch, s)
                    : launch<__nv_bfloat16>(rg, batch, s);
}
