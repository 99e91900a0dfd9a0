// flash_fwd: tiled online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_flash/ops/flash/forward.py:
//   _flash_fwd_kernel (:102, rectangular grid), _flash_fwd_onepass_kernel
//   (:287, short-sequence single pass), _flash_fwd_tri_kernel (:607,
//   triangular causal grid) and _flash_fwd_tri2_kernel (:758, paired-q
//   triangular grid). On the TPU those are four grid geometries of one
//   computation; here one kernel covers them: the TPU's sequential kv grid
//   axis becomes a loop inside the block, and the cells the triangular
//   grid enumerates are exactly the kv tiles this loop visits (tiles above
//   the diagonal or below the sliding window are never loaded).
//
// Computes, per (batch, q head, q tile):
//   s = (round_T(q * sm_scale)) k^T in f32; softcap; ALiBi; masks
//   (causal with q_offset, sliding window, kv tail, segment ids: a score
//   whose q and kv ids differ, as _seg_mask :44); online softmax over BK =
//   128 kv columns a step (TileSizes.block_kv: the step fixes which
//   running max each P element is rounded after, as the TPU walk and the
//   plain version round it) with deferred normalisation; P rounded to the
//   input type before P V (the TPU kernel's `p.astype(v.dtype)`); optional
//   per-head sink logits in the denominator; optional lse.
//
// What bounds it on this card: prefill attention is compute-bound (about
// 2 * BQ FLOPs per K/V byte per q tile), so the bound is the tensor cores'
// 989 TFLOP/s (bf16).
//
// bf16 (flash_fwd: training, and every call but the serving engine's):
// the tensor-core body of fwd_tile.cuh (mma.sync m16n8k16, ldmatrix
// fragments, K and V bf16 in shared memory by cp.async with the next
// stage in flight; S, the softmax and P in registers), the body the
// variant harness (variant_fwd.cu) times. A block stages 128 kv rows,
// one softmax step, at a time and owns 64 q rows (4 warps of 16), the
// harness's fastest q-tile height: Q, K and V tiles of D + 8-element rows
// take 85 KB at d 128 (two blocks an SM) and 45 KB at d 64. At d 256 it
// owns 128 q rows (8 warps, 198 KB): a 64-row block would hold 165 KB for
// 4 warps, one block an SM. The exponential is the harness's winner,
// exp2f: scores leave the score transform times log2 e (after softcap and
// ALiBi), since folding log2 e into q's scale, as the harness does, would
// round q' otherwise than the TPU kernel. tools/torch_fwd_sweep.py times
// these choices against the others. The heaviest causal q tiles launch
// first. A step wholly inside the live region for a warp's rows, with no
// segment ids and no softcap or ALiBi, takes its scores as they are; one
// with no segment ids skips the compares; a step wholly above its
// diagonal, below its window or past sq is not computed.
//
// The order-exact kernel, for f32 inputs (TF32 products would miss their
// 2^-12 bar) and, in both dtypes, behind a second entry point,
// flash_fwd_exact, which the serving engine takes: prefill_tile.cuh's
// tile (the body of paged_prefill.cu and ragged_prefill.cu) over dense
// K/V. It sums S over d and P V over the kv rows one FMA at a time in
// index order, the order of the plain version's f32 products on the card,
// so its outputs rarely leave the plain version's by a bit; the tensor
// cores sum inside each mma in an order of their own, and the trained
// checkpoint's greedy tokens sit on one-ulp logit margins that notice
// (PERF.md, Findings). What bounds it: the CUDA cores' f32 FMA rate (67
// TFLOP/s). What the design does about it (prefill_tile.cuh says more):
// a block folds the q heads of one kv head over R / g positions (R = 64
// rows; 16 for short bf16 calls whose 64-row grid leaves SMs idle), so
// each K/V row it stages serves every head of the group; K and V come in
// the q dtype by cp.async through a two-slot ring, the next step in flight
// while this one computes; steps no row sees (above the diagonal, below
// the window, past kv_len) are skipped, and steps every row fully sees
// take no mask. The kv walk is the plain version's: blocks of BK columns
// from column 0 (the last ending at kv_len), each one online-softmax step;
// at d 256 a block is two of the tile's 64-column windows, whose scores go
// through a slot of the score scratch (the wrapper allocates it). l sums
// each block in the order of PyTorch's CUDA row sum (prefill_tile.cuh,
// TORCH_L), so it is the plain version's l bit for bit.
//
// Rows that see no key. A causal row of a non-empty K/V whose window
// starts at or past kv_len (or whose position is below 0) takes every
// column of [0, kv_len) at the mask value, as the plain version does: m =
// MASK_VALUE, l = kv_len, o the mean of V, lse MASK_VALUE + log(kv_len).
// Both kernels detect such a block (`blind`) and walk every step of
// [0, kv_len) for it. The tensor-core kernel has a build for calls that
// hold such a row (BLIND; the host picks it from the first and last row's
// positions), in which only the warps that hold one (decided once a warp)
// stop skipping steps and leave columns past kv_len at -inf, so a blind
// row does not count them; the block's other warps walk and score as the
// build without the test, which every other call runs. A row whose max is
// the mask value leaves it unscaled by ln 2 (the mask value is never taken
// to log2 units: times log2 e it would overflow to -inf).
//
// Rows whose every key a segment id hides (a q segment that no key of
// [0, kv_len) carries, or none before the row's diagonal) are not known
// from positions: each kernel walks only its usual steps for them, so
// such a row ends with its max at the mask value having averaged only the
// columns it walked. For calls with segment ids a second pass
// (masked_rows_kernel, after either kernel) finds those rows by their lse
// (below half the mask value: MASK_VALUE, or MASK_VALUE * ln 2 where the
// tensor-core kernel took the mask value to log2 units; a row that sees a
// key has a finite score's lse, a row with sinks the sink's) and writes
// the plain version's answer: o the mean of V[:kv_len], summed in
// sequence, lse MASK_VALUE + log(kv_len). The wrapper passes an lse
// buffer for such calls; calls without segment ids run no second pass.

// Layout: q [b, hq, sq, d], k/v [b, hkv, skv, d], o like q, lse f32
// [b, hq, sq]; all contiguous (bf16 rows 16-byte aligned). GQA by index:
// q head h reads kv head h / (hq / hkv). Every kernel launch runs on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwd_tile.cuh"
#include "prefill_tile.cuh"

namespace {

constexpr int BK = 128;  // kv rows per online-softmax step
constexpr float MASK_VALUE = tc::FWD_MASK_VALUE;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // nullptr: not requested
  const float* sinks;  // [hq] or nullptr
  const float* alibi;  // [hq] or nullptr
  const int* q_seg;    // [b, sq] segment ids or nullptr
  const int* kv_seg;   // [b, skv] (set with q_seg)
  int hq, hkv, sq, skv;
  int kv_len;          // kv positions >= kv_len are masked (padded tail)
  float scale;         // sm_scale, already rounded to T by the wrapper
  int causal, q_offset, window;  // window <= 0: none
  float softcap, inv_softcap;    // softcap <= 0: none
};

// Whether a causal row of positions [lo, hi] sees no key of a non-empty
// K/V: its position is below 0, or its window starts at or past kv_len.
__host__ __device__ __forceinline__ bool sees_no_key(const FwdParams& p,
                                                     int lo, int hi) {
  return p.causal && p.kv_len > 0 &&
         (lo < 0 || (p.window > 0 && hi - p.window + 2 > p.kv_len));
}

// The kv tiles of BK rows a q tile [q0, q0 + bq) attends: the triangular
// grid's active cells, or (BLIND builds) every tile of [0, kv_len) where a
// row of the tile sees no key. Returns (first, last) in first/last.
template <bool BLIND>
__device__ __forceinline__ void kv_tiles(const FwdParams& p, int q0, int bq,
                                         int& first, int& last) {
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + bq, p.sq) - 1 + p.q_offset;
  first = 0;
  last = (p.kv_len + BK - 1) / BK - 1;
  if (p.causal && !(BLIND && sees_no_key(p, q_first, q_last))) {
    last = min(last, q_last / BK);
    if (p.window > 0) {
      const int lo = q_first - p.window + 1;
      first = lo > 0 ? lo / BK : 0;
    }
  }
}

// The final scale of a row's O and its lse (prefill_tile.cuh's, which the
// order-exact kernel stores too).
__device__ __forceinline__ void finish_row(const FwdParams& p, int h, float m,
                                           float l, float& mult,
                                           float& lse) {
  prefill::finish_row(p.sinks, h, m, l, mult, lse);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (fwd_tile.cuh's body).

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The tiles and exponential this build serves at each head width (see the
// note at the top; tools/torch_fwd_sweep.py times others): 64 q rows (128
// at d 256), one 128-row softmax step staged at a time; exp2.
template <int D>
using TcTiles = tc::FwdTiles<D, D == 256 ? 128 : 64, BK, BK>;
constexpr bool TC_EXP2 = true;

// Softcap, ALiBi and the masks for one warp's 16 q rows from wq0. Under
// EXP2 a live score leaves in log2 units (times log2 e, after softcap and
// ALiBi: the rounded q' stays the TPU's), for exp2f. PLAIN: whether the
// build has the option-free path (plain()) at all. BLIND: whether a row of
// the call may see no key (the build for such calls; the other build's
// warps never test for one).
template <bool EXP2, bool PLAIN, bool BLIND>
struct FlashScore {
  const FwdParams& p;
  int b, wq0;
  float slope;
  bool no_options;  // no softcap, no ALiBi
  bool blind_warp;  // BLIND builds: a row of the warp sees no key
  // A row of the warp sees no key: the warp walks every step.
  __device__ bool blind() const { return BLIND && blind_warp; }
  // The warp's positions: its first and last q row that exist.
  __device__ int qlo() const { return wq0 + p.q_offset; }
  __device__ int qhi() const { return min(wq0 + 15, p.sq - 1) + p.q_offset; }
  // No row of the warp sees the step: past sq, above the diagonal, or
  // below the window (and no row of the warp sees no key).
  __device__ bool skip(int k0) const {
    if (wq0 >= p.sq) return true;
    if (!p.causal || blind()) return false;
    return k0 > qhi() || (p.window > 0 && k0 + BK - 1 <= qlo() - p.window);
  }
  // The step needs the compares: segment ids, the kv tail, or the
  // diagonal or the window's edge crossing it.
  __device__ bool masked(int k0) const {
    if (p.q_seg != nullptr || k0 + BK > p.kv_len) return true;
    if (!p.causal) return false;
    return k0 + BK - 1 > qlo() || (p.window > 0 && k0 <= qhi() - p.window);
  }
  __device__ bool plain() const { return PLAIN && no_options; }
  __device__ float unit(float x) const { return EXP2 ? x * LOG2E : x; }
  __device__ float operator()(float x, int row, int kpos, bool masked) const {
    if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_softcap);
    const int qpos = row + p.q_offset;
    if (p.causal && p.alibi != nullptr) x += slope * (float)(kpos - qpos);
    x = unit(x);
    if (!masked) return x;
    bool valid = kpos < p.kv_len;
    if (p.causal) {
      valid = valid && kpos <= qpos;
      if (p.window > 0) valid = valid && kpos > qpos - p.window;
    }
    if (valid && p.q_seg != nullptr && row < p.sq) {
      valid = p.q_seg[(long long)b * p.sq + row] ==
              p.kv_seg[(long long)b * p.skv + kpos];
    }
    if (valid) return x;
    // Past kv_len the plain version walks no column: in a warp that holds
    // a row that sees no key, -inf there counts in no row's sum, where the
    // mask value would.
    return blind() && kpos >= p.kv_len ? -INFINITY : MASK_VALUE;
  }
};

template <class G, bool EXP2, bool PLAIN, bool BLIND>
__global__ void __launch_bounds__(G::THREADS)
    flash_fwd_tc_kernel(const __grid_constant__ FwdParams p) {
  constexpr int D = G::D;
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // The heaviest (last) causal q tiles first, so the last wave is the
  // lightest.
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * G::BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qbase = ((long long)b * p.hq + h) * (long long)p.sq * D;
  const long long kvbase = ((long long)b * p.hkv + hk) * (long long)p.skv * D;
  int first, last;
  kv_tiles<BLIND>(p, q0, G::BQ, first, last);
  const int wq0 = q0 + warp * 16;
  const FlashScore<EXP2, PLAIN, BLIND> score{
      p, b, wq0, p.alibi != nullptr ? p.alibi[h] : 0.f,
      !(p.softcap > 0.f) && !(p.causal && p.alibi != nullptr),
      BLIND && sees_no_key(p, wq0 + p.q_offset,
                           min(wq0 + 15, p.sq - 1) + p.q_offset)};
  tc::FwdRows<D> r;
  tc::fwd_block<G, EXP2>(static_cast<const bf16*>(p.q) + qbase,
                         static_cast<const bf16*>(p.k) + kvbase,
                         static_cast<const bf16*>(p.v) + kvbase, q0, p.sq,
                         p.kv_len, p.scale, first, last, score, r, tc_smem);

  // Deferred normalisation (with the sink logit folded in once).
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= p.sq) continue;
    // A live max leaves in log2 units; the mask value (the max of a row
    // that sees no key) leaves as it is.
    const float m = r.m[half];
    float mult, lse;
    finish_row(p, h, EXP2 && !(BLIND && m == MASK_VALUE) ? m * LN2 : m,
               r.l[half], mult, lse);
    tc::fwd_store_row<D>(static_cast<bf16*>(p.o) + qbase + (long long)row * D,
                         r, half, mult);
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[((long long)b * p.hq + h) * p.sq + row] = lse;
  }
}

template <class G, bool EXP2, bool PLAIN, bool BLIND>
int launch_tc(const FwdParams& p, int batch, cudaStream_t stream) {
  cudaFuncSetAttribute(flash_fwd_tc_kernel<G, EXP2, PLAIN, BLIND>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.sq + G::BQ - 1) / G::BQ, p.hq, batch);
  flash_fwd_tc_kernel<G, EXP2, PLAIN, BLIND>
      <<<grid, G::THREADS, G::smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The BLIND build only for a call whose last row (or first, at a negative
// offset) sees no key, so every other call runs the build without the
// test.
template <class G, bool EXP2, bool PLAIN = true>
int launch_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  if (sees_no_key(p, p.q_offset, p.sq - 1 + p.q_offset))
    return launch_tc<G, EXP2, PLAIN, true>(p, batch, stream);
  return launch_tc<G, EXP2, PLAIN, false>(p, batch, stream);
}

FwdParams make_params(const void* q, const void* k, const void* v, void* o,
                      void* lse, const void* sinks, const void* alibi,
                      const void* q_seg, const void* kv_seg, int hq, int hkv,
                      int sq, int skv, int kv_len, float scale, int causal,
                      int q_offset, int window, float softcap,
                      float inv_softcap) {
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sinks = static_cast<const float*>(sinks);
  p.alibi = static_cast<const float*>(alibi);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.window = window;
  p.softcap = softcap;
  p.inv_softcap = inv_softcap;
  return p;
}

// ---------------------------------------------------------------------------
// The order-exact kernel: prefill_tile.cuh's tile over dense K/V.

struct DenseParams {
  prefill::RowParams rp;  // rp.g q heads a block over rp.qp positions
  const void* k;
  const void* v;
  float* lse;
  const int* q_seg;
  const int* kv_seg;
  int skv, kv_len, causal, q_offset;
  int splits;   // blocks of rp.g heads a kv head's group takes
  int qblocks;  // position blocks a (batch row, head block)
};

template <class G>
__global__ void __launch_bounds__(prefill::THREADS, G::MIN_BLOCKS)
    flash_fwd_dense_kernel(const __grid_constant__ DenseParams dp) {
  using T = typename G::T;
  using prefill::RowInfo;
  constexpr int D = G::D;
  extern __shared__ __align__(16) unsigned char dense_smem[];
  const prefill::RowParams& p = dp.rp;
  const prefill::Smem<G, T> sm(dense_smem);
  // The latest (heaviest) causal position blocks of every batch row and
  // head block first, so the last wave is the lightest. A head block is
  // rp.g q heads, whose kv head is hb / splits.
  const int hblocks = p.hkv * dp.splits;
  const int per_qt = gridDim.x / dp.qblocks;
  const int qt = dp.qblocks - 1 - (int)blockIdx.x / per_qt;
  const int hb = (int)blockIdx.x % per_qt % hblocks;
  const int b = (int)blockIdx.x % per_qt / hblocks;
  const prefill::Rows rows{hb, qt * p.qp, p.g, p.qp, p.q_len};
  const int kvh = hb / dp.splits;
  const int qlo = rows.q_first + dp.q_offset;
  const int qhi = min(rows.q_first + p.qp, p.q_len) - 1 + dp.q_offset;
  const int kv_len = dp.kv_len, window = p.window;
  const bool causal = dp.causal != 0, segs = dp.q_seg != nullptr;
  // A row of the block that sees no key (below position 0, or its window
  // past kv_len) takes every column at the mask value, as the plain
  // version does: then every step is walked.
  const bool blind =
      kv_len > 0 && causal &&
      (qlo < 0 || (window > 0 && qhi - window + 2 > kv_len));
  const long long bh = (long long)b * p.hkv + kvh;
  const T* kbase = static_cast<const T*>(dp.k) + bh * dp.skv * D;
  const T* vbase = static_cast<const T*>(dp.v) + bh * dp.skv * D;
  // The last block ends at kv_len, as the plain version's does (a step
  // staged ahead for it may reach past: those rows load as zeros).
  auto src = [&](int j) -> long long { return j < kv_len ? j : -1LL; };
  auto live = [&](int j0, int j1) {
    j1 = min(j1, kv_len);
    if (j0 >= j1) return false;
    if (!causal || blind) return true;
    return j0 <= qhi && (window <= 0 || j1 - 1 > qlo - window);
  };
  auto full = [&](int j0, int j1) {
    if (segs) return false;
    if (!causal) return true;
    return j1 - 1 <= qlo && (window <= 0 || j0 > qhi - window);
  };
  // The ALiBi bias is the plain version's product, then its sum (no
  // contraction into an FMA).
  auto mask = [&](const RowInfo& row, int j, float x) {
    if (!row.active) return MASK_VALUE;
    bool valid = true;
    if (causal) {
      const int qpos = row.pos + dp.q_offset;
      valid = j <= qpos && (window <= 0 || j > qpos - window);
      if (p.alibi != nullptr)
        x = __fadd_rn(x, __fmul_rn(row.slope, (float)(j - qpos)));
    }
    if (valid && segs)
      valid = dp.q_seg[(long long)b * p.q_len + row.pos] ==
              dp.kv_seg[(long long)b * dp.skv + j];
    return valid ? x : MASK_VALUE;
  };
  int first = 0, last = (kv_len + BK - 1) / BK - 1;
  if (causal && !blind) {
    last = min(last, qhi / BK);
    if (window > 0) first = max(qlo - window + 1, 0) / BK;
  }
  // The first block's first K step (its window 0's first live step, as
  // attend_block stages a next block's) loads into slot 0 while q does.
  int ahead = -1;
  for (int t0 = first * BK; first <= last && t0 < first * BK + G::SW;
       t0 += G::BK) {
    if (live(t0, t0 + G::BK)) {
      prefill::stage<G, T, D>(sm.slot(0), kbase, (const float*)nullptr, 0,
                              src, t0, G::BK);
      ahead = first * BK;
      break;
    }
  }
  prefill::Thread<G> st;
  prefill::load_q<G, T, D>(p, rows, sm, st, b);  // slot 0 next, none ahead
  st.ahead = ahead;
  float* scratch = prefill::take_scratch<G>(p);
  for (int t = first; t <= last; ++t)
    prefill::attend_block<G, T, D, true>(
        p, sm, st, scratch, t * BK, min(BK, kv_len - t * BK), kbase, vbase,
        (const float*)nullptr, (const float*)nullptr, src, live, full, mask,
        t < last ? (t + 1) * BK : -1);
  prefill::give_scratch<G>(p, scratch);
  prefill::store_rows<G, T, D, true>(p, rows, sm, st, b, dp.lse);
}

// The q heads a block holds: the largest divisor of the group g that fits
// R rows (the whole group where g <= R).
inline int heads_per_block(int g, int rows) {
  int h = g < rows ? g : rows;
  while (g % h != 0) --h;
  return h;
}

template <class G>
int launch_dense(DenseParams dp, int batch, long long scratch_floats,
                 cudaStream_t stream) {
  constexpr int R = G::WR * prefill::WARPS;
  const int g = dp.rp.hq / dp.rp.hkv;
  dp.rp.g = heads_per_block(g, R);
  dp.rp.qp = R / dp.rp.g;
  dp.splits = g / dp.rp.g;
  dp.qblocks = (dp.rp.q_len + dp.rp.qp - 1) / dp.rp.qp;
  const int rc = prefill::check_scratch<G>(dp.rp, BK, scratch_floats);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_dense_kernel<G>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  // One dimension: position blocks (slowest, heaviest first) x batch rows
  // x head blocks.
  const long long blocks =
      (long long)dp.qblocks * batch * dp.rp.hkv * dp.splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, prefill::THREADS, G::SMEM, stream>>>(dp);
  return (int)cudaGetLastError();
}

template <class G>
int dense_occupancy(int* smem_bytes, int* blocks_per_sm) {
  auto kernel = flash_fwd_dense_kernel<G>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G::SMEM);
  *smem_bytes = G::SMEM;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                prefill::THREADS, G::SMEM);
  return (int)cudaGetLastError();
}

// Every dense instance a call can take (q dtype 0 f32, 1 bf16; 16 rows a
// block for bf16 calls only), run through `call` (a launch or an
// occupancy query); cudaErrorInvalidValue for any other.
template <class Call>
int dense_instance(int dtype, int head_dim, int rows, Call call) {
  using bf16 = __nv_bfloat16;
  using prefill::Geo;
  constexpr int R = prefill::ROWS, RV = prefill::ROWS_VERIFY;
  if (dtype == 1 && rows == RV) {
    if (head_dim == 64) return call(Geo<64, bf16, RV>());
    if (head_dim == 256) return call(Geo<256, bf16, RV>());
    return call(Geo<128, bf16, RV>());
  }
  if (rows != R) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (head_dim == 64) return call(Geo<64, bf16, R>());
    if (head_dim == 256) return call(Geo<256, bf16, R>());
    return call(Geo<128, bf16, R>());
  }
  if (head_dim == 64) return call(Geo<64, float, R>());
  if (head_dim == 256) return call(Geo<256, float, R>());
  return call(Geo<128, float, R>());
}

DenseParams dense_params(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* sinks,
                         const void* alibi, const void* q_seg,
                         const void* kv_seg, void* scratch, int scratch_slots,
                         int hq, int hkv, int sq, int skv, int kv_len,
                         float scale, int causal, int q_offset, int window,
                         float softcap, float inv_softcap) {
  DenseParams dp;
  prefill::RowParams& rp = dp.rp;
  rp.q = q;
  rp.o = o;
  rp.sinks = static_cast<const float*>(sinks);
  // Window and ALiBi apply to causal calls only (as the plain version).
  rp.alibi = causal ? static_cast<const float*>(alibi) : nullptr;
  rp.scratch = static_cast<float*>(scratch);
  rp.slots = scratch_slots;
  rp.hq = hq;
  rp.hkv = hkv;
  rp.q_len = sq;
  rp.scale = scale;
  rp.window = causal ? window : 0;
  rp.softcap = softcap;
  rp.inv_softcap = inv_softcap;
  rp.page_size = 0;
  dp.k = k;
  dp.v = v;
  dp.lse = static_cast<float*>(lse);
  dp.q_seg = static_cast<const int*>(q_seg);
  dp.kv_seg = static_cast<const int*>(kv_seg);
  dp.skv = skv;
  dp.kv_len = kv_len;
  dp.causal = causal;
  dp.q_offset = q_offset;
  return dp;
}

}  // namespace

#define FLASH_FWD_ARGS                                                      \
  const void *q, const void *k, const void *v, void *o, void *lse,         \
      const void *sinks, const void *alibi, const void *q_seg,              \
      const void *kv_seg, void *scratch, long long scratch_floats,          \
      int scratch_slots, int rows, int dtype, int batch, int hq, int hkv,   \
      int sq, int skv, int kv_len, int head_dim, float scale, int causal,   \
      int q_offset, int window, float softcap, float inv_softcap,           \
      void *stream
#define FLASH_FWD_NAMES                                                     \
  q, k, v, o, lse, sinks, alibi, q_seg, kv_seg, scratch, scratch_floats,    \
      scratch_slots, rows, dtype, batch, hq, hkv, sq, skv, kv_len,          \
      head_dim, scale, causal, q_offset, window, softcap, inv_softcap,      \
      stream
#define FLASH_FWD_PARAMS                                                    \
  make_params(q, k, v, o, lse, sinks, alibi, q_seg, kv_seg, hq, hkv, sq,    \
              skv, kv_len, scale, causal, q_offset, window, softcap,        \
              inv_softcap)

// ---------------------------------------------------------------------------
// Rows whose max stayed at the mask value (segment ids; see the note at the
// top): one block per (MASKED_ROWS rows, q head, batch row), one thread a
// column.

namespace {

constexpr int MASKED_ROWS = 64;

template <class T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <class T, int D>
__global__ void __launch_bounds__(D)
    masked_rows_kernel(const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int hq, int hkv, int sq,
                       int skv, int kv_len) {
  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * MASKED_ROWS;
  const int n = min(MASKED_ROWS, sq - r0);
  const long long rows = ((long long)b * hq + h) * sq + r0;
  __shared__ bool masked[MASKED_ROWS];
  __shared__ int any;
  if (threadIdx.x == 0) any = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += D) {
    masked[r] = lse[rows + r] < 0.5f * MASK_VALUE;
    if (masked[r]) any = 1;
  }
  __syncthreads();
  if (!any) return;
  // Every column of [0, kv_len) at the mask value: P 1 on each, l kv_len.
  const T* vc = v + ((long long)b * hkv + h / (hq / hkv)) * skv * D +
                threadIdx.x;
  float sum = 0.f;
  for (int j = 0; j < kv_len; ++j) sum += to_f32(vc[(long long)j * D]);
  const T mean = from_f32<T>(sum * (1.0f / (float)kv_len));
  for (int r = 0; r < n; ++r) {
    if (!masked[r]) continue;
    o[(rows + r) * D + threadIdx.x] = mean;
    if (threadIdx.x == 0) lse[rows + r] = MASK_VALUE + logf((float)kv_len);
  }
}

template <class T>
int launch_masked_rows(const void* v, void* o, float* lse, int batch, int hq,
                       int hkv, int sq, int skv, int kv_len, int head_dim,
                       cudaStream_t stream) {
  const dim3 grid((sq + MASKED_ROWS - 1) / MASKED_ROWS, hq, batch);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (head_dim == 64)
    masked_rows_kernel<T, 64><<<grid, 64, 0, stream>>>(vt, ot, lse, hq, hkv,
                                                       sq, skv, kv_len);
  else if (head_dim == 256)
    masked_rows_kernel<T, 256><<<grid, 256, 0, stream>>>(
        vt, ot, lse, hq, hkv, sq, skv, kv_len);
  else
    masked_rows_kernel<T, 128><<<grid, 128, 0, stream>>>(
        vt, ot, lse, hq, hkv, sq, skv, kv_len);
  return (int)cudaGetLastError();
}

// After either kernel: the second pass for calls with segment ids (rc, the
// kernel's return, passes through when it failed or no pass is due).
int masked_rows(int rc, const void* v, void* o, void* lse, const void* q_seg,
                int dtype, int batch, int hq, int hkv, int sq, int skv,
                int kv_len, int head_dim, void* stream) {
  if (rc != 0 || q_seg == nullptr || lse == nullptr || kv_len <= 0 ||
      sq <= 0)
    return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch_masked_rows<__nv_bfloat16>(v, o, l, batch, hq, hkv, sq,
                                             skv, kv_len, head_dim, s);
  return launch_masked_rows<float>(v, o, l, batch, hq, hkv, sq, skv, kv_len,
                                   head_dim, s);
}

}  // namespace

#define MASKED_ROWS_ARGS                                                    \
  v, o, lse, q_seg, dtype, batch, hq, hkv, sq, skv, kv_len, head_dim, stream

bool served(int dtype, int head_dim) {
  return (dtype == 0 || dtype == 1) &&
         (head_dim == 64 || head_dim == 128 || head_dim == 256);
}

// The order-exact kernel for one call of either entry.
static int launch_exact(FLASH_FWD_ARGS) {
  if (hq % hkv != 0 || kv_len < 0 || kv_len > skv)
    return (int)cudaErrorInvalidValue;
  const DenseParams dp = dense_params(
      q, k, v, o, lse, sinks, alibi, q_seg, kv_seg, scratch, scratch_slots,
      hq, hkv, sq, skv, kv_len, scale, causal, q_offset, window, softcap,
      inv_softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dense_instance(dtype, head_dim, rows, [&](auto geo) {
    return launch_dense<decltype(geo)>(dp, batch, scratch_floats, s);
  });
}

// dtype: 0 = float32 (the order-exact kernel), 1 = bfloat16 (the
// tensor-core kernel); q, k, v and o share it. head_dim: 64, 128 or 256.
// scratch: scratch_floats f32 of device memory holding scratch_slots slots
// (prefill_tile.cuh, take_scratch) for f32 at d 256, as forward.py sizes
// it, else nullptr; rows: the order-exact kernel's rows a block (64, or
// 16 for bf16). With segment ids, lse must be given: the second pass reads
// it. Returns cudaGetLastError() after the launches; 1
// (cudaErrorInvalidValue) for a configuration this build does not serve.
extern "C" int flash_fwd(FLASH_FWD_ARGS) {
  if (!served(dtype, head_dim)) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0) {
    rc = launch_exact(FLASH_FWD_NAMES);
  } else {
    const FwdParams p = FLASH_FWD_PARAMS;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (head_dim == 64)
      rc = launch_bf16<TcTiles<64>, TC_EXP2>(p, batch, s);
    else if (head_dim == 256)
      rc = launch_bf16<TcTiles<256>, TC_EXP2>(p, batch, s);
    else
      rc = launch_bf16<TcTiles<128>, TC_EXP2>(p, batch, s);
  }
  return masked_rows(rc, MASKED_ROWS_ARGS);
}

// The order-exact forward: the order-exact kernel for both dtypes, whose
// S and P V sums run in sequence over d and over the kv rows, the order
// of the plain version's f32 products on the card (see the note at the
// top). Same arguments and returns as flash_fwd.
extern "C" int flash_fwd_exact(FLASH_FWD_ARGS) {
  if (!served(dtype, head_dim)) return (int)cudaErrorInvalidValue;
  return masked_rows(launch_exact(FLASH_FWD_NAMES), MASKED_ROWS_ARGS);
}

// The shared memory and blocks an SM of the order-exact instance a call
// of this dtype (0 f32, 1 bf16), head width and rows a block takes.
extern "C" int flash_fwd_exact_occupancy(int dtype, int head_dim, int rows,
                                         int* smem_bytes,
                                         int* blocks_per_sm) {
  if (!served(dtype, head_dim)) return (int)cudaErrorInvalidValue;
  return dense_instance(dtype, head_dim, rows, [&](auto geo) {
    return dense_occupancy<decltype(geo)>(smem_bytes, blocks_per_sm);
  });
}
