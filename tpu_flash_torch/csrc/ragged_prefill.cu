// ragged_prefill: mixed-stage chunk attention over dense
// [history padded to hist_cap | chunk] K/V, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ragged_prefill_kernel
// (tpu_flash/ops/flash/ragged.py:56, launched at :425 by
// flash_attention_ragged). The TPU kernel precomputes a kv-block index
// map from the per-row offsets so that dead tiles alias a live one and
// their DMAs are elided; here each thread block loads its row's offset and
// skips every window no row of it can see.
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
// What bounds it on this card: the f32 FMA rate of the CUDA cores (67
// TFLOP/s), because every score and output element keeps the plain
// version's f32 operation chain (prefill_tile.cuh, the order contract:
// the serving engine's tokens are held to the plain version's); the
// tensor cores' 989 TFLOP/s would bound an order-free kernel. The tile:
// bf16 K/V by cp.async through a two-slot ring, two blocks of 8 warps an
// SM at d 128, a 128-column tile one window (S stays in shared memory); at
// d 256 a tile is two 64-column windows, whose scores go through a slot
// of the score scratch (the wrapper allocates it).
//
// Head widths: d = 128 and d = 256, each its own template instance.
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

template <typename G>
__global__ void __launch_bounds__(THREADS, G::MIN_BLOCKS)
ragged_prefill_kernel(RaggedParams rg) {
  using T = typename G::T;
  constexpr int D = G::D;
  extern __shared__ __align__(16) unsigned char smem[];
  const RowParams& p = rg.rp;
  const Smem<G, T> sm(smem);
  // The latest (heaviest) chunk positions of a (row, kv head) first.
  const int qt = gridDim.x - 1 - blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Rows rows{kvh, qt * p.qp, p.g, p.qp, p.q_len};
  const int p_lo = rows.q_first;
  const int p_hi = min(p_lo + p.qp, p.q_len) - 1;
  const int offs = min(rg.offsets[b], rg.hist_cap);
  const int hc = rg.hist_cap;
  const int kv_len = hc + p.q_len;
  const int window = p.window;
  Thread<G> st;
  load_q<G, T, D>(p, rows, sm, st, b);
  float* scratch = take_scratch<G>(p);

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
  auto full = [&](int j0, int j1) {
    if (j1 <= hc)
      return j1 <= offs && (window <= 0 || j0 > offs + p_hi - window);
    return j0 >= hc && j1 - 1 - hc <= p_lo &&
           (window <= 0 || j0 - hc > p_hi - window);
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
    attend_block<G, T, D>(
        p, sm, st, scratch, t * rg.block_kv, rg.block_kv, kbase, vbase,
        (const float*)nullptr, (const float*)nullptr, src, live, full, mask,
        t < last_tile ? (t + 1) * rg.block_kv : -1);
  give_scratch<G>(p, scratch);
  store_rows<G, T, D>(p, rows, sm, st, b);
}

template <typename G>
int launch(RaggedParams rg, int batch, long long scratch_floats,
           cudaStream_t stream) {
  constexpr int R = G::WR * WARPS;
  auto kernel = ragged_prefill_kernel<G>;
  if (rg.rp.g > R) return (int)cudaErrorInvalidValue;
  rg.rp.qp = R / rg.rp.g;
  dim3 grid((rg.rp.q_len + rg.rp.qp - 1) / rg.rp.qp, rg.rp.hkv, batch);
  const int rc = check_scratch<G>(rg.rp, rg.block_kv, scratch_floats);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(rg);
  return (int)cudaGetLastError();
}

template <typename G>
int occupancy(int* smem_bytes, int* blocks_per_sm) {
  auto kernel = ragged_prefill_kernel<G>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  *smem_bytes = G::SMEM;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                THREADS, G::SMEM);
  return (int)cudaGetLastError();
}

}  // namespace

#define RAGGED_PREFILL_ARGS                                                 \
  const void *q, const void *k, const void *v, const void *q_offsets,       \
      const void *sinks, const void *alibi, void *o, void *scratch,         \
      long long scratch_floats, int scratch_slots, int dtype, int batch,    \
      int hq, int hkv, int q_len, int hist_cap, int block_kv, int head_dim, \
      float scale, int window, float softcap, float inv_softcap,            \
      void *stream
#define RAGGED_PREFILL_PARAMS                                               \
  q, k, v, q_offsets, sinks, alibi, o, scratch, scratch_floats,             \
      scratch_slots, dtype, batch, hq, hkv, q_len, hist_cap, block_kv,      \
      head_dim, scale, window, softcap, inv_softcap, stream

// A call's parameters, or cudaErrorInvalidValue for a configuration this
// build does not serve.
static int ragged_params(RaggedParams& rg, RAGGED_PREFILL_ARGS) {
  if ((head_dim != 128 && head_dim != 256) || hq % hkv != 0 ||
      (dtype != 0 && dtype != 1) || block_kv <= 0 || q_len <= 0 ||
      hist_cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  rg.rp.q = q;
  rg.rp.o = o;
  rg.rp.sinks = static_cast<const float*>(sinks);
  rg.rp.alibi = static_cast<const float*>(alibi);
  rg.rp.scratch = static_cast<float*>(scratch);
  rg.rp.slots = scratch_slots;
  rg.rp.hq = hq;
  rg.rp.hkv = hkv;
  rg.rp.g = hq / hkv;
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
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). scratch:
// scratch_floats f32 of device memory holding scratch_slots slots
// (prefill_tile.cuh, take_scratch), as ragged.py sizes it, or nullptr
// when block_kv fits one window (128 columns; 64 at d 256).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a configuration this build does not serve.
extern "C" int ragged_prefill(RAGGED_PREFILL_ARGS) {
  RaggedParams rg;
  const int rc = ragged_params(rg, RAGGED_PREFILL_PARAMS);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return head_dim == 256
               ? launch<Geo<256, float, ROWS>>(rg, batch, scratch_floats, s)
               : launch<Geo<128, float, ROWS>>(rg, batch, scratch_floats, s);
  return head_dim == 256
             ? launch<Geo<256, bf16, ROWS>>(rg, batch, scratch_floats, s)
             : launch<Geo<128, bf16, ROWS>>(rg, batch, scratch_floats, s);
}

// The shared memory and blocks an SM of the instance a call of this
// dtype (0 f32, 1 bf16) and head width takes.
extern "C" int ragged_prefill_occupancy(int dtype, int head_dim,
                                        int* smem_bytes, int* blocks_per_sm) {
  using bf16 = __nv_bfloat16;
  if (head_dim == 256)
    return dtype == 0
               ? occupancy<Geo<256, float, ROWS>>(smem_bytes, blocks_per_sm)
               : occupancy<Geo<256, bf16, ROWS>>(smem_bytes, blocks_per_sm);
  return dtype == 0
             ? occupancy<Geo<128, float, ROWS>>(smem_bytes, blocks_per_sm)
             : occupancy<Geo<128, bf16, ROWS>>(smem_bytes, blocks_per_sm);
}
