// paged_prefill: chunk attention over [paged history | dense chunk K/V]
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _paged_prefill_kernel
// (tpu_flash/ops/flash/paged_prefill.py:69, launched at :645 by
// paged_prefill_attention). The TPU kernel streams each row's history
// pages into VMEM with double-buffered DMAs whose walk (cmap, cum, next,
// slot parity) is precomputed outside it and rides in as scalar
// prefetch; here each thread block loads its own offset and page-table
// row and reads the page rows it needs straight from device memory.
//
// Computes, per (batch row b, kv head, block of chunk positions), for the
// q_per_kv query heads of that kv head stacked in one 64-row tile (GQA
// folding: a history row is read once per kv head, not per q head):
//   history blocks of bk = pages_per_block * page_size tokens, from the
//   first block a row of the tile can see under the sliding window to the
//   last block holding any of the row's q_offsets[b] tokens, then the
//   chunk's own K/V in blocks of block_q rows, causally -- the TPU
//   kernel's blocks in its order (prefill_tile.cuh says why that order
//   and those widths fix the roundings). Pages are f32, bf16, or int8,
//   token-packed int4 or e4m3 with a per-token f32 scale (dequantized as
//   value * scale in f32, rounded to the q dtype, bit for bit the engine's
//   gather path); masks: history j < q_offsets[b] (and inside the window),
//   chunk column <= row; softcap, ALiBi, sinks.
//
// What bounds it on this card: at a prefill chunk (q_len 512 over 1024
// history tokens) the work is ~ 4 * q_len * kv * d FLOPs per q head
// against each K/V byte read once per kv head, far above the ~295
// FLOP/byte ridge: the tensor cores' 989 TFLOP/s bound it. At the verify
// shape (9 rows over ~2K history) it reads each history byte for 9 * 4
// rows, under the ridge: HBM bounds it. This first kernel is simple: f32
// FMAs on the CUDA cores from f32 tiles in shared memory, two passes over
// blocks wider than one 128-row sub-tile (see prefill_tile.cuh). The
// verify grid is b * hkv blocks (64 at b 8, hkv 8) on 132 SMs, the same
// under-fill as paged_decode; split-K, wgmma and TMA are later work.
//
// Layout: q [b, hq, q_len, d]; chunk k/v [b, hkv, q_len, d] in q's dtype;
// pages [hkv, num_pages, ps, d] (int4: [hkv, num_pages, ps / 2, d]);
// scales f32 [hkv, num_pages, ps];
// q_offsets int32 [b]; tables int32 [b, pps]; o like q; all contiguous.

#include "prefill_tile.cuh"

namespace {

using namespace prefill;

struct PagedParams {
  RowParams rp;
  const void* ck;  // chunk K [b, hkv, q_len, d]
  const void* cv;
  const void* kp;  // pages [hkv, num_pages, ps (int4: ps / 2), d]
  const void* vp;
  const float* ks;  // scales [hkv, num_pages, ps] or nullptr
  const float* vs;
  const int* offsets;  // [b] history length per row
  const int* tables;   // [b, pps]
  int num_pages, ps, pps, bk, block_q;
};

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(PagedParams pp) {
  extern __shared__ float smem[];
  const RowParams& p = pp.rp;
  const Smem sm(smem);
  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const Rows rows{kvh, qt * p.qp, p.g, p.qp, p.q_len};
  const int p_lo = rows.q_first;
  const int p_hi = min(p_lo + p.qp, p.q_len) - 1;
  const int offs = pp.offsets[b];
  const int window = p.window;
  load_q<TQ>(p, rows, sm, b);
  RowInfo ri[4];
  row_infos(p, rows, ri);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  // History: pages of this row, kv column j = absolute position j.
  if (offs > 0) {
    // Token rows of this head's pages (and scales); int4 bytes hold two.
    const long long head_rows = (long long)kvh * pp.num_pages * pp.ps;
    const long long head_bytes_rows =
        std::is_same<TK, Int4Tokens>::value ? head_rows / 2 : head_rows;
    const TK* kbase = static_cast<const TK*>(pp.kp) + head_bytes_rows * D;
    const TK* vbase = static_cast<const TK*>(pp.vp) + head_bytes_rows * D;
    const float* ksc = pp.ks != nullptr ? pp.ks + head_rows : nullptr;
    const float* vsc = pp.vs != nullptr ? pp.vs + head_rows : nullptr;
    const int* table = pp.tables + (long long)b * pp.pps;
    auto src = [&](int j) -> long long {
      if (j >= offs) return -1LL;
      const int page = table[min(j / pp.ps, pp.pps - 1)];
      return (long long)page * pp.ps + j % pp.ps;
    };
    auto live = [&](int j0, int j1) {
      if (j0 >= offs) return false;
      return window <= 0 || j1 - 1 > offs + p_lo - window;
    };
    auto mask = [&](const RowInfo& row, int j, float x) {
      if (!row.active) return MASK_VALUE;
      const int i = row.pos;
      bool valid = j < offs;
      if (window > 0) valid = valid && j > offs + i - window;
      if (p.alibi != nullptr) x += row.slope * (float)(j - offs - i);
      return valid ? x : MASK_VALUE;
    };
    const int last = (offs + pp.bk - 1) / pp.bk;
    int first = 0;
    if (window > 0) {
      const int lo = max(offs + p_lo - window + 1, 0);
      first = min(lo / pp.bk, last);
    }
    for (int blk = first; blk < last; ++blk)
      attend_block<TQ>(p, sm, ri, acc, blk * pp.bk, pp.bk, kbase, vbase,
                       ksc, vsc, src, live, mask);
  }

  // The chunk itself, causally: kv column c = chunk position c.
  {
    const long long bh = (long long)b * p.hkv + kvh;
    const TQ* kbase = static_cast<const TQ*>(pp.ck) + bh * p.q_len * D;
    const TQ* vbase = static_cast<const TQ*>(pp.cv) + bh * p.q_len * D;
    auto src = [&](int c) -> long long { return c < p.q_len ? c : -1LL; };
    auto live = [&](int c0, int c1) {
      if (c0 > p_hi) return false;
      return window <= 0 || c1 - 1 > p_lo - window;
    };
    auto mask = [&](const RowInfo& row, int c, float x) {
      if (!row.active) return MASK_VALUE;
      const int i = row.pos;
      bool valid = c <= i;
      if (window > 0) valid = valid && c > i - window;
      if (p.alibi != nullptr) x += row.slope * (float)(c - i);
      return valid ? x : MASK_VALUE;
    };
    const int c_last = p_hi / pp.block_q;
    const int c_first =
        window > 0 ? max(p_lo - window + 1, 0) / pp.block_q : 0;
    for (int c = c_first; c <= c_last; ++c)
      attend_block<TQ>(p, sm, ri, acc, c * pp.block_q, pp.block_q, kbase,
                       vbase, (const float*)nullptr, (const float*)nullptr,
                       src, live, mask);
  }
  store_rows<TQ>(p, rows, sm, acc, b);
}

template <typename TQ, typename TK>
int launch(const PagedParams& pp, int batch, cudaStream_t stream) {
  cudaFuncSetAttribute(paged_prefill_kernel<TQ, TK>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kSmemBytes);
  dim3 grid((pp.rp.q_len + pp.rp.qp - 1) / pp.rp.qp, pp.rp.hkv, batch);
  paged_prefill_kernel<TQ, TK><<<grid, THREADS, kSmemBytes, stream>>>(pp);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_pages(const PagedParams& pp, int page_dtype, int batch,
                 cudaStream_t stream) {
  switch (page_dtype) {
    case 0: return launch<TQ, float>(pp, batch, stream);
    case 1: return launch<TQ, __nv_bfloat16>(pp, batch, stream);
    case 2: return launch<TQ, int8_t>(pp, batch, stream);
    case 3: return launch<TQ, Int4Tokens>(pp, batch, stream);
    case 4: return launch<TQ, __nv_fp8_e4m3>(pp, batch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q, chunk k/v and o share it).
// page_dtype: 0 f32, 1 bf16; with k_scales/v_scales: 2 int8, 3 int4
// (token-packed, page_size even), 4 fp8 (e4m3).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a configuration this build does not serve.
extern "C" int paged_prefill(
    const void* q, const void* chunk_k, const void* chunk_v,
    const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* q_offsets, const void* tables,
    const void* sinks, const void* alibi, void* o, int q_dtype,
    int page_dtype, int batch, int hq, int hkv, int q_len, int num_pages,
    int page_size, int pages_per_seq, int block_tokens, int block_q,
    int head_dim, float scale, int window, float softcap, float inv_softcap,
    void* stream) {
  if (head_dim != D || hq % hkv != 0 || hq / hkv > BQ ||
      (q_dtype != 0 && q_dtype != 1) || block_tokens <= 0 || block_q <= 0 ||
      q_len <= 0 || (page_dtype >= 2) != (k_scales != nullptr) ||
      (page_dtype == 3 && page_size % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  PagedParams pp;
  pp.rp.q = q;
  pp.rp.o = o;
  pp.rp.sinks = static_cast<const float*>(sinks);
  pp.rp.alibi = static_cast<const float*>(alibi);
  pp.rp.hq = hq;
  pp.rp.hkv = hkv;
  pp.rp.g = hq / hkv;
  pp.rp.qp = BQ / pp.rp.g;
  pp.rp.q_len = q_len;
  pp.rp.scale = scale;
  pp.rp.window = window;
  pp.rp.softcap = softcap;
  pp.rp.inv_softcap = inv_softcap;
  pp.rp.page_size = page_size;
  pp.ck = chunk_k;
  pp.cv = chunk_v;
  pp.kp = k_pages;
  pp.vp = v_pages;
  pp.ks = static_cast<const float*>(k_scales);
  pp.vs = static_cast<const float*>(v_scales);
  pp.offsets = static_cast<const int*>(q_offsets);
  pp.tables = static_cast<const int*>(tables);
  pp.num_pages = num_pages;
  pp.ps = page_size;
  pp.pps = pages_per_seq;
  pp.bk = block_tokens;
  pp.block_q = block_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_dtype == 0 ? launch_pages<float>(pp, page_dtype, batch, s)
                      : launch_pages<__nv_bfloat16>(pp, page_dtype, batch, s);
}
