// paged_prefill: chunk attention over [paged history | dense chunk K/V]
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _paged_prefill_kernel
// (tpu_flash/ops/flash/paged_prefill.py:69, launched at :645 by
// paged_prefill_attention). The TPU kernel streams each row's history
// pages into VMEM with double-buffered DMAs whose walk (cmap, cum, next,
// slot parity) is precomputed outside it and rides in as scalar
// prefetch; here each thread block loads its own offset and page-table
// row and stages the page rows it needs through its own ring.
//
// Computes, per (batch row b, kv head, block of chunk positions), for the
// q_per_kv query heads of that kv head stacked in one tile of R rows (GQA
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
// against each K/V byte read once per kv head, far above the ridge; the
// order contract (prefill_tile.cuh: the serving engine's greedy tokens are
// held to the plain version's) keeps it on the CUDA cores, so their f32
// rate (67 TFLOP/s) bounds it, not the tensor cores' 989. History blocks
// span up to 16 windows (2048 tokens) and chunk blocks two (256 rows at 4
// q heads a kv head): their scores go through a slot of the score
// scratch in device memory, read back to form P, so S is computed once.
// At the verify shape (9 rows over ~2K history) it reads each history byte for
// 9 * 4 rows, under the ridge: HBM bounds it, and the 64-row grid is
// b * hkv blocks (64 at b 8, hkv 8) on 132 SMs, so such calls take the
// 16-row instance (ROWS_VERIFY: 192 blocks), which the wrapper picks.
//
// Head widths: d = 128 and d = 256, each its own template instance.
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

template <typename G, typename TK>
__global__ void __launch_bounds__(THREADS, G::MIN_BLOCKS)
paged_prefill_kernel(PagedParams pp) {
  using TQ = typename G::T;
  constexpr int D = G::D;
  extern __shared__ __align__(16) unsigned char smem[];
  const RowParams& p = pp.rp;
  const Smem<G, TQ> sm(smem);
  // The latest (heaviest) chunk positions of a (row, kv head) first.
  const int qt = gridDim.x - 1 - blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Rows rows{kvh, qt * p.qp, p.g, p.qp, p.q_len};
  const int p_lo = rows.q_first;
  const int p_hi = min(p_lo + p.qp, p.q_len) - 1;
  const int offs = pp.offsets[b];
  const int window = p.window;
  Thread<G> st;
  load_q<G, TQ, D>(p, rows, sm, st, b);
  float* scratch = take_scratch<G>(p);

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
    auto full = [&](int j0, int j1) {
      return j1 <= offs && (window <= 0 || j0 > offs + p_hi - window);
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
      attend_block<G, TQ, D>(
          p, sm, st, scratch, blk * pp.bk, pp.bk, kbase, vbase, ksc, vsc, src,
          live, full, mask, blk + 1 < last ? (blk + 1) * pp.bk : -1);
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
    auto full = [&](int c0, int c1) {
      return c1 - 1 <= p_lo && (window <= 0 || c0 > p_hi - window);
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
      attend_block<G, TQ, D>(
          p, sm, st, scratch, c * pp.block_q, pp.block_q, kbase, vbase,
          (const float*)nullptr, (const float*)nullptr, src, live, full, mask,
          c < c_last ? (c + 1) * pp.block_q : -1);
  }
  give_scratch<G>(p, scratch);
  store_rows<G, TQ, D>(p, rows, sm, st, b);
}

template <typename G, typename TK>
int launch_tile(PagedParams pp, int batch, long long scratch_floats,
                cudaStream_t stream) {
  constexpr int R = G::WR * WARPS;
  auto kernel = paged_prefill_kernel<G, TK>;
  if (pp.rp.g > R) return (int)cudaErrorInvalidValue;
  pp.rp.qp = R / pp.rp.g;
  dim3 grid((pp.rp.q_len + pp.rp.qp - 1) / pp.rp.qp, pp.rp.hkv, batch);
  const int rc = check_scratch<G>(
      pp.rp, pp.bk > pp.block_q ? pp.bk : pp.block_q, scratch_floats);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(pp);
  return (int)cudaGetLastError();
}

// The product's instances: R rows a block, each dtype's default step.
template <int R>
struct Product {
  template <typename TQ, typename TK, int D>
  static int launch(const PagedParams& pp, int batch, long long sf,
                    cudaStream_t s) {
    return launch_tile<Geo<D, TQ, R>, TK>(pp, batch, sf, s);
  }
  template <typename TQ, typename TK, int D>
  static int occupancy(int* smem_bytes, int* blocks_per_sm) {
    using G = Geo<D, TQ, R>;
    auto kernel = paged_prefill_kernel<G, TK>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         G::SMEM);
    *smem_bytes = G::SMEM;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                  THREADS, G::SMEM);
    return (int)cudaGetLastError();
  }
};

// One instance of P (Product<R>) by q dtype, page dtype and head width,
// through `call` (a launch or an occupancy query).
template <typename TQ, typename Call>
int by_pages(int page_dtype, int head_dim, Call call) {
  auto width = [&](auto tk) {
    using TK = decltype(tk);
    return head_dim == 256 ? call.template run<TQ, TK, 256>()
                           : call.template run<TQ, TK, 128>();
  };
  switch (page_dtype) {
    case 0: return width(float{});
    case 1: return width(__nv_bfloat16{});
    case 2: return width(int8_t{});
    case 3: return width(Int4Tokens{});
    case 4: return width(__nv_fp8_e4m3{});
  }
  return (int)cudaErrorInvalidValue;
}

template <int R>
struct LaunchCall {
  const PagedParams& pp;
  int batch;
  long long sf;
  cudaStream_t s;
  template <typename TQ, typename TK, int D>
  int run() const {
    return Product<R>::template launch<TQ, TK, D>(pp, batch, sf, s);
  }
};

template <int R>
struct OccupancyCall {
  int* smem;
  int* blocks;
  template <typename TQ, typename TK, int D>
  int run() const {
    return Product<R>::template occupancy<TQ, TK, D>(smem, blocks);
  }
};

}  // namespace

#define PAGED_PREFILL_ARGS                                                  \
  const void *q, const void *chunk_k, const void *chunk_v,                  \
      const void *k_pages, const void *v_pages, const void *k_scales,       \
      const void *v_scales, const void *q_offsets, const void *tables,      \
      const void *sinks, const void *alibi, void *o, void *scratch,         \
      long long scratch_floats, int scratch_slots, int q_dtype,             \
      int page_dtype, int batch, int hq, int hkv, int q_len,                \
      int num_pages, int page_size, int pages_per_seq, int block_tokens,    \
      int block_q, int head_dim, int rows, float scale, int window,         \
      float softcap, float inv_softcap, void *stream
#define PAGED_PREFILL_PARAMS                                                \
  q, chunk_k, chunk_v, k_pages, v_pages, k_scales, v_scales, q_offsets,     \
      tables, sinks, alibi, o, scratch, scratch_floats, scratch_slots,      \
      q_dtype, page_dtype, batch, hq, hkv, q_len, num_pages, page_size,     \
      pages_per_seq, block_tokens, block_q, head_dim, rows, scale, window,  \
      softcap, inv_softcap, stream

// A call's parameters, or cudaErrorInvalidValue for a configuration this
// build does not serve.
static int paged_params(PagedParams& pp, PAGED_PREFILL_ARGS) {
  if ((head_dim != 128 && head_dim != 256) || hq % hkv != 0 ||
      (q_dtype != 0 && q_dtype != 1) || block_tokens <= 0 || block_q <= 0 ||
      q_len <= 0 || (page_dtype >= 2) != (k_scales != nullptr) ||
      (page_dtype == 3 && page_size % 2 != 0) ||
      (rows != ROWS && (rows != ROWS_VERIFY || q_dtype != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  pp.rp.q = q;
  pp.rp.o = o;
  pp.rp.sinks = static_cast<const float*>(sinks);
  pp.rp.alibi = static_cast<const float*>(alibi);
  pp.rp.scratch = static_cast<float*>(scratch);
  pp.rp.slots = scratch_slots;
  pp.rp.hq = hq;
  pp.rp.hkv = hkv;
  pp.rp.g = hq / hkv;
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
  return 0;
}

// q_dtype: 0 = float32, 1 = bfloat16 (q, chunk k/v and o share it).
// page_dtype: 0 f32, 1 bf16; with k_scales/v_scales: 2 int8, 3 int4
// (token-packed, page_size even), 4 fp8 (e4m3). rows: query rows a block,
// ROWS (64) or, for bf16 q, ROWS_VERIFY (16). scratch: scratch_floats f32
// of device memory holding scratch_slots slots (prefill_tile.cuh,
// take_scratch), as paged_prefill.py sizes it, or nullptr when no kv
// block is wider than one window (128 columns; 64 at d 256).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a configuration this build does not serve.
extern "C" int paged_prefill(PAGED_PREFILL_ARGS) {
  PagedParams pp;
  const int rc = paged_params(pp, PAGED_PREFILL_PARAMS);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == ROWS_VERIFY)
    return by_pages<__nv_bfloat16>(page_dtype, head_dim,
                                   LaunchCall<ROWS_VERIFY>{pp, batch,
                                                           scratch_floats, s});
  const LaunchCall<ROWS> call{pp, batch, scratch_floats, s};
  return q_dtype == 0 ? by_pages<float>(page_dtype, head_dim, call)
                      : by_pages<__nv_bfloat16>(page_dtype, head_dim, call);
}

// The shared memory and blocks an SM of the instance a call of these
// dtypes, head width and rows takes.
extern "C" int paged_prefill_occupancy(int q_dtype, int page_dtype,
                                       int head_dim, int rows,
                                       int* smem_bytes, int* blocks_per_sm) {
  if (rows == ROWS_VERIFY && q_dtype == 1)
    return by_pages<__nv_bfloat16>(
        page_dtype, head_dim,
        OccupancyCall<ROWS_VERIFY>{smem_bytes, blocks_per_sm});
  if (rows != ROWS) return (int)cudaErrorInvalidValue;
  const OccupancyCall<ROWS> call{smem_bytes, blocks_per_sm};
  return q_dtype == 0 ? by_pages<float>(page_dtype, head_dim, call)
                      : by_pages<__nv_bfloat16>(page_dtype, head_dim, call);
}
