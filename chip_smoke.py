#!/usr/bin/env python3
"""Chip smoke test of the tpu_flash_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; it needs no JAX and no
network. Phases, one JSON line each:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from tpu_flash_torch/csrc (one nvcc per
     source, all started together), with the build seconds; each
     instance of the backward pair, the forward, the variant kernel, the
     attention-weights kernel and the two prefill kernels with its
     registers, spill bytes and tensor-core instructions in its SASS
     (every backward and weights instance must have them, the f32 ones
     as three-pass TF32, and the forward's bf16 ones; the forward's
     order-exact instances and every prefill instance not); each
     instance of the order-exact
     prefill tile (K5, K6 and the forward's) with its shared memory and
     blocks an SM (two at d 128); each paged decode instance's
     registers, spill bytes, shared memory, blocks an SM and clusters
     the card holds at once;
  3. kernels: each kernel against its plain PyTorch version on the card
     at the main path's shapes, with times, bounds and a library
     yardstick: the forward on both entry points (bf16 on the tensor
     cores; the order-exact entry the serving engine takes, on the
     prefill tile, as f32 is), every case in bf16 and f32 with a bar per
     row, a late-row control and the count of output elements that
     differ from the plain version, tile-edge cases and segment ids
     included, the backward pair
     (dK/dV and dQ) at the training shape, decode over every page tier
     (bf16, int8, int4, int4g32, k8v4, fp8; int8_mxu and fp8_native on
     and off; rows at ragged lengths, the ring over rows shorter than
     it, four kv blocks, a window starting inside a page, (m, l) out),
     each with the count of output elements that differ from the plain
     version (0 required), paged prefill over bf16, int8, int4 and fp8
     pages and ragged prefill, both with a bar per row and a late-row
     control,
     tile-edge cases and the count of output elements that differ from
     the plain version at all; config 1's d 64 f32 row of the forward;
     the quantized-input
     forward at config 4's geometry (int8, fp8 native and software at
     8192 tokens in bf16 and f32 with a bar per row and a late-row
     control; options and the int8 staircase at 2048); the row
     quantizer byte for byte; the attention-weights kernel (bf16 at 2048
     tokens with its options, Gemma-2's d 256, f32 at 1024, and in each
     a window that ends past kv_len, whose late rows see no key) with a
     bar per row, a late-row control (lse raised 2^-6 past s/2) and the
     count of elements off the plain version; every built
     variant of the variant harness's kernel (K13) at its sweep's shape
     with a bar per row and a late-row control, exp2 timed against expf
     in turns;
     and Gemma-2-9B's attention geometry (16 q / 8 kv heads, d 256, cap
     50, a sliding layer's 4096-token window and a global layer; a
     512-token first chunk) on the forward, decode (every tier), paged
     and ragged prefill and the backward, the backward also at d 64,
     and in f32 (three-pass TF32, its bound at that rate) at b 2 x
     2048, d 64 and Gemma-2's d 256, each with SDPA's f32 backward
     beside it;
     decode at 16 q heads a kv head (bf16 and int8 pages, bit for bit);
     the bf16 backward is held against the plain version with its bf16
     P in dV (``round_p``); the forward's rows that see no key (a window
     ending past kv_len) on both entries at d 128 and 256, each row
     within its bar, the blind rows' lse MASK_VALUE + log(kv_len), a
     control (those rows averaging only the last step's keys) that must
     miss; rows whose q segment no key carries (bf16 and f32, both
     entries, d 128) likewise, the kernels' second pass giving them the
     mean of V;
  4. main path: Llama-3-8B geometry at full width (all 32 layers, seeded
     random bf16 weights made on the card) served by the port's engine at
     its default routing (paged prefill, fused mixed steps, speculation
     k 8): 8 requests x 32 greedy tokens on an int8 cache with the recent
     ring and on a bf16 cache; the same two with paged_prefill=False
     (gathered history, the ragged kernel); the int4, fp8, int4g32 and
     k8v4 tiers with no layout fields (the engine's auto layout, printed);
     and 8 prompts of 1024 tokens built so that prompt lookup drafts,
     served for 16 tokens through speculative verify; a decode window
     (int8 + ring, 32 tokens each) traced with ``utils/profiling.timed``,
     its heaviest kernels printed (paged_decode must be among them);
     the HTTP server (``tpu_flash_torch.serve``) in front of the int8 +
     ring engine: one greedy request alone against ``engine.submit``
     alone, then greedy, streamed, n=2 greedy, n=3 sampled, forced and
     banned-token requests at once from client threads beside a bad
     request and /health (requests/s and the wall a request printed);
     optimistic admission on a 32-page pool under recompute and under
     swap preemption (each must preempt, deliver every budget and free
     every page; the first request restored holding, byte for byte, its
     pages and ring row as they stood when it was swapped out; tok/s,
     the wall and the token match beside the reserve run's); the
     swap run snapshotted mid-decode with a victim swapped out, restored
     into a fresh engine and run on, token for token the uninterrupted
     run (bytes, write and read seconds printed); two seeded rank-16
     adapters over every projection served mixed with base requests
     (base rows' first logits bit for bit the run without adapters,
     adapted rows within the 5% bar of the plain forward on merged
     weights, the base logits missing it); then Gemma-2-9B at full width
     (42 layers, head width 256, seeded random bf16 weights) on the int8
     + ring and bf16 caches. Launch counters (per kernel and per page
     tier) reset before each run; every served run records the page
     allocator its engine used, which must be the native one (g++ at
     first use, ``engine/allocator.py``), in phases 4 and 5;
  parallel (after phase 4's Llama-3-8B runs, on their weights, before
     Gemma-2-9B): multi-device serving as far as one card runs it (NCCL
     refuses two ranks on one device; multi-rank correctness is held on
     gloo CPU groups by the tests): (a) a process group of one on NCCL
     from a torchrun-style environment (``initialize_multihost``) and
     the (data, seq, model) mesh over it, one all-reduce; (b) a 4-rank
     ring's schedule in one process (``ring_attention_schedule``: every
     rank's sources in ring order through ``ring_block_state``, merged)
     on Llama-3-8B attention at 8192 tokens, Gemma-2-9B's 16/8 heads of
     256 with its 4096 window and cap 50 over four 2048-token blocks
     (diagonal, dense, banded with rows that see no key, empty), ALiBi
     and sinks at d 128 and 4096 tokens: every row within a bar from
     the error model (RING_BLOCK_ULPS, RING_REF_ULPS) against K1 over
     the whole sequence and against the plain version, the last rank's
     block states merged without its own block missing it in at least
     half that rank's rows; the ring's, its block calls' and K1's times;
     (f) in each of those cases the ring's backward: the schedule's dq,
     dk, dv (and the sink logits') gradients for a seeded dO, through
     K8/K9 on every live block with the merge's lse cotangent, against
     the plain whole-sequence backward, every row within a bar from the
     error model (ulps of each block's own contribution and of the
     reference, and the bf16 roundings inside the backward's sums), the
     control (the last rank's own and first received blocks dropped)
     missing it in at least half the last rank's dq rows and its own kv
     block's dk and dv rows; the schedule's forward +
     backward ms beside one K1 + K8/K9 pair over the whole sequence, and
     the launches of K1 and K8/K9 in one of them; (c)
     ``sharded_paged_attention``'s and ``sharded_flash_attention``'s
     per-rank bodies on each half of the kv heads (K4 on int8 and bf16
     pages, K1 bf16 causal), bit for bit the whole call's slices; (d)
     the tensor-parallel engine at a model axis of 1 on phase 4's
     weights (shared), int8 + ring: no model group (an axis of one is
     one device), phase 4's tokens bit for bit; (e)
     ``DataParallelEngine`` with two replicas sharing the card and the
     weights: each request's tokens those of the request served alone,
     aggregate prefill and decode tok/s of 2 replicas against 1 (a
     figure), a DP snapshot mid-decode restored into a fresh engine and
     run on, token for token;
  5. trained model: checkpoints/tiny-byte-llama served at the engine's
     defaults on every cache tier, and a staggered two-request scenario
     that reaches every route (int8, int4, fp8); the int8 runs again with
     paged_prefill=False; each run's greedy text against the same engine
     on the plain versions (token for token; every kernel call also held
     against its plain version on the same inputs, decode to the bit),
     and each tier's greedy match against the bf16 cache's tokens; then
     draft-model speculation (the checkpoint drafting for itself, and a
     seeded random draft of its shape) token for token against the
     engine without speculation, acceptance printed; an n=3 greedy
     group, a banned-token request and a neighbour on bf16, int8 +
     ring, int4 and k8v4, token for token the plain versions', and the
     group's branches equal to the prompt served alone; optimistic
     admission on a 6-page pool (bf16 and int8 + ring, recompute and
     swap, and swap with an adapter), each run token for token the plain
     versions' with every kernel call shadowed, the adapter run also
     snapshotted after a swap and restored, its continuation the
     uninterrupted run's;
  6. training at full width: Llama-3-8B widths cut to 4 of its 32 layers
     (the only cut), seeded random bf16 weights made on the card, batch
     4 x 2048 tokens, AdamW with a norm clip for 6 steps on one repeated
     seeded batch: loss per step, train tok/s, the first step's
     gradients against the plain versions' (and a control batch's);
     (g) then the DP x TP x SP step (``make_train_step(model, mesh)``)
     on a fresh NCCL group of one at the same widths, weights and batch,
     AdamW: its first loss within 0.02 nats of the one-device step's and
     every gradient within the 5% bar (another batch's gradients
     missing it), 2 steps, a sharded ``TrainCheckpointManager``
     checkpoint, 2 more, then the checkpoint restored into a fresh shard
     and optimizer and the 2 steps again, every loss bit for bit; train
     tok/s beside the one-device step's;
  7. the trained checkpoint: its loss over windows of the repo's own
     Markdown on the kernels and on the plain versions, then 10 AdamW
     steps on each path from the same weights and batches (one batch
     packed with segment ids), step losses compared; the kernel path's
     first 4 steps again, a ``TrainCheckpointManager`` checkpoint, params
     and AdamW state restored into fresh objects and steps 5-10 taken:
     every loss bit for bit the uninterrupted run's;
  8. bench: ``tpu_flash_torch.bench`` configs 1-12 in-process (flash
     parity at d 64 and 128, prefill TFLOP/s, decode tok/s and the int8
     quantization delta, int8 and fp8 QKV prefill at 8K, 32K prefill and
     int4 decode, the engine's wall-clock serving rows, windowed decode
     and paged prefill at 32K / 4K, the quantized caches' greedy quality
     (int8 >= 0.95, int4 and fp8 >= 0.90, every tier's tokens those of
     the plain versions), the engine's decode on its kernel time (below
     the wall time per step), the attention train step, speculative
     serving; config 6 also through two rank-16 adapters),
     ``attention_weights`` on config 1's shapes against the oracle's
     weights, then the variant
     sweep (``tpu_flash_torch.bench.experiments``): targets met, every
     variant through the parity gate, rates finite and positive, each
     config's kernels launched. This phase runs at a smaller depth than
     the bench's CLI, to keep the smoke within its time: its
     differential timing takes windows of 0.05 s, 3 times each, not 0.15
     s, 4 times (``BENCH_WINDOW_S``, ``BENCH_REPEATS``).

A ``phase_walls`` line gives each phase's seconds, the build's included.
Then the nvidia-smi line, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. Without CUDA it exits 2 at once.
``--trained-only`` runs phases 1, 2 and 5 and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

START = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCALE = 128 ** -0.5
# "tf32x3": f32 work as three TF32 passes on the tensor cores (494.7
# TFLOP/s dense), the f32 backward's and the weights kernel's arithmetic.
PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12, "fp8": 1979e12,
                  "float32": 67e12, "tf32x3": 494.7e12 / 3}
# Kernel vs plain version: they take every rounding the TPU kernel
# specifies and differ only in f32 summation order. That can flip the
# rounding of a bf16 output element (one ulp at its own magnitude, so at
# most one bf16 ulp of max |ref|) and of a few int8 or bf16 P elements,
# each of which moves an output by a small part of that ulp. So a bf16
# case's bar is BF16_TOL_ULPS bf16 ulps of its max |ref|. An f32 output
# keeps only the flipped bf16 P elements, each moving an output by 2^-8
# of one token's share of it; with no token near a sixteenth of max |ref|
# (2048-token contexts), F32_TOL_REL of max |ref| bounds that. Every case
# with an option also holds a control: the kernel against the plain
# version without the option must miss the bar.
BF16_TOL_ULPS = 2
F32_TOL_REL = 2.0 ** -12


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_query() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Bytes the device writes before each call device_ms times, five times
# the H100's 50 MB L2 cache: each call then reads its inputs from device
# memory, as a serving step's layer does.
L2_FLUSH_BYTES = 256 << 20


def device_ms(fn, iters: int, cold: bool = True) -> float:
    """Mean device milliseconds per call of fn() with the host's enqueue
    hidden, for calls whose kernels take less time than the host takes to
    launch them (time_ms would time the host): each call is timed by CUDA
    events of its own, and the device first spins (torch.cuda._sleep) for
    twice the host's measured enqueue time at 2 GHz, so the events time
    the device alone. ``cold``: before each call the device overwrites
    L2_FLUSH_BYTES (outside the events); else the calls find what the
    last one left in the L2 cache."""
    import torch

    flush = (torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]

    def calls():
        for start, end in marks:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()

    calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_s * 2e9))
    calls()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def differing(out, ref) -> int:
    """Elements of ``out`` (a tensor or a tuple of them) that differ from
    ``ref`` at all."""
    if isinstance(out, tuple):
        return sum(differing(x, y) for x, y in zip(out, ref))
    return int((out != ref).sum())


def case_bar(ref) -> float:
    """A case's tolerance from its reference's own magnitude: for bf16
    outputs BF16_TOL_ULPS bf16 ulps of max |ref| (an ulp is 2^(e - 7) for
    a magnitude in [2^e, 2^(e+1))), for f32 outputs F32_TOL_REL of it."""
    import torch

    top = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return BF16_TOL_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    return F32_TOL_REL * top


def agreement(out, ref, out_vs_control) -> dict:
    """The kernel's error against its plain version and the case's bar.
    ``out_vs_control`` is the kernel's error against the plain version with
    the case's option dropped (None where the case has no control): it
    must miss the bar, or the bar could not fail a kernel that ignored
    the option."""
    err, tol = max_err(out, ref), case_bar(ref)
    ok = err <= tol and (out_vs_control is None or out_vs_control > tol)
    return dict(max_abs_err=err, max_abs_ref=float(ref.float().abs().max()),
                tol=tol, control_err=out_vs_control, ok=ok)


def row_bars(ref):
    """case_bar's rule applied to each row (last axis) of ``ref`` at the
    row's own max |ref|: a row of small outputs, such as a late causal
    row that averages thousands of tokens, is held at its own scale and
    not at that of row 0 (one token, |v| up to ~4)."""
    import torch

    top = ref.float().abs().amax(-1)
    if ref.dtype == torch.bfloat16:
        _, e = torch.frexp(top)  # top in [2^(e-1), 2^e): ulp 2^(e - 8)
        ulp = torch.ldexp(torch.ones_like(top), e - 8)
        return torch.where(top > 0, BF16_TOL_ULPS * ulp,
                           torch.zeros_like(top))
    return F32_TOL_REL * top


def row_misses(out, ref, bars):
    """Rows where ``out`` is off ``ref`` by more than the row's bar."""
    return (out.float() - ref.float()).abs().amax(-1) > bars


def bwd_row_bars(ref, grad):
    """row_bars for one gradient of the backward (``grad``: "dq", "dk" or
    "dv"; None for a forward output, held at its own bars) and, as a
    mask, the rows held at the floor. bf16 dQ and dK rows
    are held at least at BWD_ROW_FLOOR of the whole output's max |ref|:
    where a q row puts P near 1 on one key, its dS = P (dP - di) is a
    cancellation, and the tensor-core kernels' dP and the wrapper's di
    leave f32 rounding noise there that the plain version leaves in
    another order (~2^-21 of max |dQ| at d 128 in a row that sees one
    key, where dS is 0 in exact arithmetic). dV = P^T dO subtracts
    nothing, and the f32 kernels (CUDA cores) match the plain version's
    noise, so those rows keep their own bars."""
    import torch

    own = row_bars(ref)
    if grad in (None, "dv") or ref.dtype != torch.bfloat16:
        return own, torch.zeros_like(own, dtype=torch.bool)
    bars = own.clamp_min(BWD_ROW_FLOOR * float(ref.float().abs().max()))
    return bars, bars > own


def row_agreement(out, ref, control, grad, late=None,
                  late_caught=None) -> dict:
    """agreement's rule for each row (bwd_row_bars): every row of ``out``
    within its bar of ``ref``; the control (None where the case has none)
    off by more than the bar in some row; ``late``, a pair (shifted
    reference, first late row), off by more than the bar in at least
    ``late_caught`` (by default BWD_LATE_CAUGHT) of the rows from that row
    on that keep their own bar (at most half of them may be held at the
    floor). Logs the medians
    that say how far under the whole output's bar (``case_bar``) a
    typical row sits."""
    bars, at_floor = bwd_row_bars(ref, grad)
    err_rows = (out.float() - ref.float()).abs().amax(-1)
    missed = int((err_rows > bars).sum())
    row = dict(max_abs_err=float(err_rows.max()),
               max_abs_ref=float(ref.float().abs().max()),
               case_bar=case_bar(ref),
               max_err_over_row_bar=float(
                   (err_rows / bars.clamp_min(1e-30)).max()),
               median_abs_ref=float(ref.float().abs().median()),
               median_row_bar=float(bars.median()),
               rows_at_floor=float(at_floor.float().mean()),
               rows_missed=missed)
    ok = missed == 0
    if control is not None:
        row["control_rows_missed"] = int(row_misses(out, control,
                                                    bars).sum())
        ok = ok and row["control_rows_missed"] > 0
    if late is not None:
        shifted, first = late
        off = (out.float() - shifted.float()).abs().amax(-1)[..., first:]
        held = ~at_floor[..., first:]
        row.update(
            late_caught=float((off > bars[..., first:])[held].float()
                              .mean()),
            late_at_floor=float(1.0 - held.float().mean()),
            late_caught_by_case_bar=float(
                (off > row["case_bar"]).float().mean()),
            late_median_abs_ref=float(
                ref[..., first:, :].float().abs().median()),
            late_median_bar=float(bars[..., first:].median()))
        ok = (ok and row["late_caught"] >= (late_caught or BWD_LATE_CAUGHT)
              and row["late_at_floor"] <= 0.5)
    row["ok"] = ok
    return row


def raise_if_failed(kernel: str, rows) -> None:
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(
            f"{kernel}: off its plain version, or a control within the "
            f"bar, in {bad}"
        )


# -- phase 3: each kernel against its plain version --------------------------


def flash_cases(dev, dtype="bfloat16"):
    """(name, q, k, v, kwargs, control kwargs) at the main path's prefill
    shapes: hq 32, hkv 8, d 128, in ``dtype`` (the same draws in either).
    The control drops the case's option."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    dt = getattr(torch, dtype)

    def qkv(b, sq, skv):
        def rn(*s):
            return torch.randn(*s, generator=g, device=dev).to(dt)

        return rn(b, 32, sq, 128), rn(b, 8, skv, 128), rn(b, 8, skv, 128)

    # These scores have std ~1 after sm_scale, a tenth of a real model's:
    # softcap 5 bends the largest as a cap of 50 bends real logits, and
    # sinks near log(kv_len) + 1 weigh about as much as all 512 keys.
    sinks = (math.log(512) + 1.0
             + 0.5 * torch.randn(32, generator=g, device=dev))
    slopes = torch.linspace(0.5, 0.004, 32, device=dev)
    causal = dict(causal=True)
    seg = segment_ids(2, 512, 3, dev)
    return [
        ("prompt_causal", *qkv(4, 512, 512), causal, dict(causal=False)),
        ("chunk_q_offset", *qkv(4, 512, 1536),
         dict(causal=True, q_offset=1024), dict(causal=False)),
        ("window", *qkv(2, 512, 512), dict(causal=True, window=128), causal),
        ("softcap", *qkv(2, 512, 512), dict(causal=True, softcap=5.0),
         causal),
        ("sinks", *qkv(2, 512, 512), dict(causal=True, sinks=sinks), causal),
        ("alibi", *qkv(2, 512, 512), dict(causal=True, alibi=slopes), causal),
        ("segments", *qkv(2, 512, 512),
         dict(causal=True, q_seg=seg, kv_seg=seg), causal),
        # Edges inside a tile (128 q rows, 128-column steps): a q tail, an
        # offset off the step (its control rounds it to the step), a kv
        # tail mid-step, a window edge that crosses staged tiles.
        ("tail_sq", *qkv(2, 500, 500), causal, dict(causal=False)),
        ("offset_unaligned", *qkv(2, 500, 1500),
         dict(causal=True, q_offset=1000), dict(causal=True, q_offset=1024)),
        ("kv_tail_mid_step", *qkv(2, 512, 1024),
         dict(causal=False, kv_len=1000), dict(causal=False)),
        ("window_unaligned", *qkv(2, 512, 512), dict(causal=True, window=200),
         causal),
    ]


def segment_ids(b, n, docs, dev):
    """[b, n] int32 ids of ``docs`` documents a row, each row's cuts
    shifted by 37 tokens from the last."""
    import torch

    i = (torch.arange(n, device=dev)[None, :]
         + 37 * torch.arange(b, device=dev)[:, None])
    return (i * docs // (n + 37 * b)).int()


def live_pairs(b, sq, skv, kw):
    """(query, key) pairs the options leave live, summed over the batch,
    as this run's inputs give them."""
    return int(attention_mask(b, sq, skv, kw).sum())


def flash_bound(q, k, kw):
    b, hq, sq, d = q.shape
    ops = 4.0 * hq * d * live_pairs(b, sq, k.shape[2], kw)
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return bound(nbytes, ops, str(q.dtype).removeprefix("torch."))


def flash_fp32_bound(q, k, kw) -> float:
    """The same work at the CUDA cores' f32 rate, the order-exact
    kernel's own bound (ms)."""
    return bound(q.element_size() * (2 * q.numel() + 2 * k.numel()),
                 4.0 * q.shape[1] * q.shape[3] * live_pairs(
                     q.shape[0], q.shape[2], k.shape[2], kw),
                 "float32")[0]


def config1_case(dev):
    """BASELINE config 1's literal row at d 64 (b1 h1 s128 f32,
    non-causal; the control is causal), as the bench's config 1 runs it."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(1, 1, 128, 64, generator=g, device=dev)
               for _ in range(3))
    return ("config1_d64_f32", q, k, v, dict(causal=False),
            dict(causal=True))


def flash_rows(q, k, v, out, scale, kw, control):
    """K1's output against its plain version with a bar per row
    (row_agreement, as K10, K13 and the backward): every row within its
    bar, the plain version with the case's option dropped (``control``)
    off some row's bar, and the plain version on v raised by
    VARIANT_LATE_SHIFT (every output moves by 3% of itself) off the bars
    of at least VARIANT_LATE_CAUGHT of the rows past sq / 2, so a fault
    confined to late or diagonal tiles cannot hide under row 0's scale."""
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    ref = flash_fwd_plain(q, k, v, sm_scale=scale, **kw)
    ctl = flash_fwd_plain(q, k, v, sm_scale=scale, **control)
    late = flash_fwd_plain(q, k, v * VARIANT_LATE_SHIFT, sm_scale=scale,
                           **kw)
    return dict(row_agreement(out, ref, ctl, None, (late, q.shape[2] // 2),
                              late_caught=VARIANT_LATE_CAUGHT),
                differ_plain=differing(out, ref), elements=out.numel())


def flash_entries():
    """K1's two entry points by kernel name: the tensor cores (bf16; f32
    takes the order-exact kernel) and the order-exact kernel the serving
    engine takes."""
    from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_exact

    return {"flash_fwd": flash_fwd, "flash_fwd_exact": flash_fwd_exact}


def check_flash(dev):
    """Every K1 case in bf16 and f32 on both entry points, each held per
    row (flash_rows) with the count of elements off the plain version,
    and of lse elements; one summary row a kernel."""
    import torch

    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    rows = {name: [] for name in flash_entries()}
    for case, q, k, v, kw, control in (flash_cases(dev)
                                       + flash_cases(dev, "float32")
                                       + [config1_case(dev)]):
        scale = q.shape[-1] ** -0.5
        plain_ms = time_ms(
            lambda: flash_fwd_plain(q, k, v, sm_scale=scale, **kw), 3
        )
        bound_ms, bound_by = flash_bound(q, k, kw)
        library_ms = None
        if case == "prompt_causal":
            library_ms = sdpa_ms(q, k, v)
        elif case == "chunk_q_offset":
            library_ms = sdpa_ms(q, k, v, mask=attention_mask(
                q.shape[0], q.shape[2], k.shape[2], kw))
        elif case == "config1_d64_f32":
            library_ms = sdpa_ms(q, k, v, causal=False)
        _, ref_lse = flash_fwd_plain(q, k, v, sm_scale=scale, save_lse=True,
                                     **kw)
        for name, fwd in flash_entries().items():
            out = fwd(q, k, v, sm_scale=scale, **kw)
            torch.cuda.synchronize()
            held = flash_rows(q, k, v, out, scale, kw, control)
            # lse = m + log(l): equal where the kernel's row max and sum
            # are the plain version's bit for bit.
            held["lse_differ_plain"] = differing(
                fwd(q, k, v, sm_scale=scale, save_lse=True, **kw)[1],
                ref_lse)
            ms = time_ms(lambda: fwd(q, k, v, sm_scale=scale, **kw), 10)
            row = dict(case=case, shape=list(q.shape), kv_len=k.shape[2],
                       dtype=str(q.dtype).removeprefix("torch."),
                       control={k_: str(v_) for k_, v_ in control.items()},
                       **held, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       fp32_bound_ms=flash_fp32_bound(q, k, kw),
                       library_ms=library_ms)
            rows[name].append(row)
            log("kernel_vs_plain", kernel=name, **row)
    for name, rs in rows.items():
        raise_if_failed(name, rs)
    return {name: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in rows.items()}


# Rows that see no key: causal, 512 q rows, a 64-token window and kv_len
# 300 of 512 keys. Rows past position kv_len + window - 2 (362) start
# their window at or past kv_len; the plain version gives them the mask
# value on every column of [0, kv_len): o the mean of V, lse MASK_VALUE +
# log(kv_len). (head width, q heads, kv heads): the main path's and
# Gemma-2-9B's.
BLIND = dict(causal=True, window=64, kv_len=300)
BLIND_FIRST = BLIND["kv_len"] + BLIND["window"] - 1
BLIND_GEO = ((128, 32, 8), (256, 16, 8))


def blind_control(ref, v, kv_len, first):
    """``ref`` with the rows that see no key averaging only the keys of
    the last 128-column step before kv_len, as a kernel that walked only
    the steps the window reaches would give them: it must miss."""
    ctl = ref.clone()
    g = ref.shape[1] // v.shape[1]
    tail = v[:, :, kv_len // 128 * 128:kv_len].float().mean(2)
    ctl[:, :, first:] = tail.repeat_interleave(g, 1)[:, :, None].to(
        ref.dtype)
    return ctl


def blind_bound(q, k, kw):
    """flash_bound's rule for a case with rows that see no key: the live
    pairs' work, plus the mean of V[:kv_len] that those rows' output is
    (kv_len d adds for each batch row and kv head, shared by all such
    rows of it). The function reads q and K/V[:kv_len] and writes o."""
    b, hq, sq, d = q.shape
    hkv, kv_len = k.shape[1], kw["kv_len"]
    ops = (4.0 * hq * d * live_pairs(b, sq, k.shape[2], kw)
           + b * hkv * kv_len * d)
    nbytes = q.element_size() * (2 * q.numel() + 2 * b * hkv * kv_len * d)
    return bound(nbytes, ops, str(q.dtype).removeprefix("torch."))


# The additive mask blind_library gives hidden columns: far below any
# score (a row that sees no key then weighs its columns alike), yet finite
# after SDPA's kernels scale it by log2 e, as the mask value (-0.7 x the
# f32 maximum) is not: with that mask, the rows that see no key came out
# 0.19-0.22 off the mean of V on the H100.
SDPA_MASK = -2.0 ** 100


def blind_library(q, k, v, kw, ref):
    """PyTorch's fused attention on K/V[:kv_len] under an additive mask
    holding SDPA_MASK on the columns a row does not see (so a row that
    sees none averages V, as the plain version's does): its ms and its
    largest |out - ref| (None, None without ``enable_gqa``)."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    n = kw["kv_len"]
    seen = attention_mask(1, q.shape[2], n, kw)
    mask = torch.zeros(seen.shape, device=q.device).masked_fill(
        ~seen, SDPA_MASK).to(q.dtype)
    ks, vs = k[:, :, :n], v[:, :, :n]

    def call():
        return sdpa(q, ks, vs, attn_mask=mask, scale=kw["sm_scale"],
                    enable_gqa=True)

    try:
        err = max_err(call(), ref)
    except TypeError:  # PyTorch without enable_gqa
        return None, None
    return time_ms(call, 10), err


def check_flash_blind(dev, summary):
    """K1's rows that see no key, bf16 at d 128 and 256, on both entry
    points: every row within its bar of the plain version's (row_bars),
    the blind rows too; the control (those rows averaging only the last
    step's keys) missed in some row; V raised 3% missed in most rows past
    sq / 2; the blind rows' lse MASK_VALUE + log(kv_len) within the f32
    bar of it. Each case timed beside its bound and SDPA's time under an
    additive mask on K/V[:kv_len] (blind_library); the summary rows keep
    the largest error."""
    import torch

    from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    want_lse = float(torch.tensor(DEFAULT_MASK_VALUE)
                     + math.log(BLIND["kv_len"]))
    rows = []
    for d, hq, hkv in BLIND_GEO:
        g = torch.Generator(device=dev).manual_seed(SEED + d)
        q = torch.randn(2, hq, 512, d, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(2, hkv, 512, d, generator=g, device=dev)
                .bfloat16() for _ in range(2))
        kw = dict(BLIND, sm_scale=d ** -0.5)
        ref = flash_fwd_plain(q, k, v, **kw)
        ctl = blind_control(ref, v, BLIND["kv_len"], BLIND_FIRST)
        late = flash_fwd_plain(q, k, v * VARIANT_LATE_SHIFT, **kw)
        plain_ms = time_ms(lambda: flash_fwd_plain(q, k, v, **kw), 3)
        bound_ms, bound_by = blind_bound(q, k, BLIND)
        library_ms, library_err = blind_library(q, k, v, kw, ref)
        for name, fwd in flash_entries().items():
            out, lse = fwd(q, k, v, save_lse=True, **kw)
            torch.cuda.synchronize()
            held = row_agreement(out, ref, ctl, None, (late, 256),
                                 late_caught=VARIANT_LATE_CAUGHT)
            blind_lse = lse[..., BLIND_FIRST:]
            lse_err = float((blind_lse - want_lse).abs().max())
            lse_bar = F32_TOL_REL * abs(want_lse)
            row = dict(case=f"blind_rows_d{d}", kernel=name,
                       shape=list(q.shape), **BLIND,
                       first_blind_row=BLIND_FIRST, **held,
                       differ_plain=differing(out, ref),
                       blind_lse_err=lse_err, blind_lse_bar=lse_bar,
                       ms=time_ms(lambda: fwd(q, k, v, **kw), 10),
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       library_max_abs_err=library_err,
                       library="SDPA on K/V[:kv_len], additive mask")
            row["ok"] = held["ok"] and lse_err <= lse_bar
            log("kernel_vs_plain", **row)
            rows.append(row)
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               held["max_abs_err"])
    raise_if_failed("flash_fwd (rows that see no key)", rows)
    return rows


# Rows whose q segment no key carries: causal, b 2, 512 rows, segment ids
# of three documents a row (segment_ids), with rows ORPHAN_ROWS given an
# id no key has. The plain version gives them every column of [0, kv_len)
# at the mask value: o the mean of V, lse MASK_VALUE + log(kv_len). The
# control gives rows 40-59 the mean of the first 128-column step's V, as
# a kernel that walked only a q tile's steps would (their tile's diagonal
# ends in that step).
ORPHAN_ROWS = ((40, 60), (300, 320))
ORPHAN_ID = 9


def orphan_inputs(dev, dtype):
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    q = torch.randn(2, 32, 512, 128, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(2, 8, 512, 128, generator=g, device=dev).to(dtype)
            for _ in range(2))
    kv_seg = segment_ids(2, 512, 3, dev)
    q_seg = kv_seg.clone()
    for lo, hi in ORPHAN_ROWS:
        q_seg[:, lo:hi] = ORPHAN_ID
    return q, k, v, dict(causal=True, kv_len=512, q_seg=q_seg,
                         kv_seg=kv_seg, sm_scale=128 ** -0.5)


def check_flash_orphan(dev, summary):
    """K1's rows whose q segment no key carries, bf16 and f32 at d 128 on
    both entry points (the second pass after either kernel): every row
    within its bar of the plain version's, the orphan rows too; the
    control missed in some row; V raised 3% missed in most rows past
    sq / 2; the orphan rows' lse MASK_VALUE + log(kv_len) within the f32
    bar of it. Each case timed beside its bound, the plain version's time
    and SDPA's under an additive mask (blind_library); the summary rows
    keep the largest error."""
    import torch

    from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, kw = orphan_inputs(dev, dtype)
        want_lse = float(torch.tensor(DEFAULT_MASK_VALUE)
                         + math.log(kw["kv_len"]))
        ref = flash_fwd_plain(q, k, v, **kw)
        ctl = ref.clone()
        first = v[:, :, :128].float().mean(2).repeat_interleave(4, 1)
        lo, hi = ORPHAN_ROWS[0]
        ctl[:, :, lo:hi] = first[:, :, None].to(dtype)
        late = flash_fwd_plain(q, k, v * VARIANT_LATE_SHIFT, **kw)
        plain_ms = time_ms(lambda: flash_fwd_plain(q, k, v, **kw), 3)
        bound_ms, bound_by = blind_bound(q, k, kw)
        library_ms, library_err = blind_library(q, k, v, kw, ref)
        orphan = torch.zeros(512, dtype=torch.bool, device=dev)
        for lo, hi in ORPHAN_ROWS:
            orphan[lo:hi] = True
        for name, fwd in flash_entries().items():
            out, lse = fwd(q, k, v, save_lse=True, **kw)
            torch.cuda.synchronize()
            held = row_agreement(out, ref, ctl, None, (late, 256),
                                 late_caught=VARIANT_LATE_CAUGHT)
            lse_err = float((lse[..., orphan] - want_lse).abs().max())
            lse_bar = F32_TOL_REL * abs(want_lse)
            row = dict(case="orphan_segment_d128", kernel=name,
                       dtype=str(dtype).removeprefix("torch."),
                       shape=list(q.shape), orphan_rows=ORPHAN_ROWS, **held,
                       differ_plain=differing(out, ref),
                       orphan_lse_err=lse_err, orphan_lse_bar=lse_bar,
                       ms=time_ms(lambda: fwd(q, k, v, **kw), 10),
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       library_max_abs_err=library_err,
                       library="SDPA, additive mask")
            row["ok"] = held["ok"] and lse_err <= lse_bar
            log("kernel_vs_plain", **row)
            rows.append(row)
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               held["max_abs_err"])
    raise_if_failed("flash_fwd (q segments that no key carries)", rows)
    return rows


def sdpa_ms(q, k, v, mask=None, causal=True):
    """PyTorch's fused attention on the same inputs (causal or not, or
    under a boolean ``mask``): a yardstick only, never called by the
    port."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    try:
        sdpa(q, k, v, enable_gqa=True, **kw)
    except TypeError:  # PyTorch without enable_gqa
        return None
    return time_ms(lambda: sdpa(q, k, v, enable_gqa=True, **kw), 10)


def attention_mask(b, sq, skv, kw):
    """The boolean [b, 1, sq, skv] mask of flash options (causal with
    q_offset, window, kv tail, segment ids), for PyTorch's fused
    attention as a yardstick."""
    import torch

    dev = "cuda"
    i = torch.arange(sq, device=dev)[:, None] + kw.get("q_offset", 0)
    j = torch.arange(skv, device=dev)[None, :]
    m = j < (kw.get("kv_len") or skv)
    if kw.get("causal"):
        m = m & (j <= i)
        if kw.get("window"):
            m = m & (j > i - kw["window"])
    m = m[None, None].expand(b, 1, sq, skv)
    if kw.get("q_seg") is not None:
        m = m & (kw["q_seg"][:, None, :, None]
                 == kw["kv_seg"][:, None, None, :])
    return m


def sdpa_bwd_ms(q, k, v, do, kw):
    """The backward of PyTorch's fused attention through autograd on the
    same inputs and mask (forward outside the timer); None where it
    cannot compute the same function (softcap, sinks, ALiBi, an lse
    cotangent) or lacks ``enable_gqa``."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    if any(kw.get(x) is not None for x in ("softcap", "sinks", "alibi",
                                           "dlse")):
        return None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if kw == dict(causal=True) and q.shape[2] == k.shape[2]:
        opts = dict(is_causal=True)
    elif kw == dict(causal=False):
        opts = {}
    else:
        opts = dict(attn_mask=attention_mask(q.shape[0], q.shape[2],
                                             k.shape[2], kw))
    try:
        out = sdpa(*leaves, enable_gqa=True, **opts)
    except TypeError:  # PyTorch without enable_gqa
        return None
    return time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True), 5)


def kernel_ms(kernel, fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of one kernel's launches inside fn(), by
    CUDA events recorded around each of its launches."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    launch = kernel.launch

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args, **kwargs)
        end.record()
        events.append((start, end))

    kernel.launch = timed
    try:
        for _ in range(iters):
            fn()
    finally:
        del kernel.launch  # back to the class's method
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / len(events)


def bwd_bound(q, k, kw, which, rate=None):
    """Least time of one backward kernel: its inputs read once (q, dO,
    k, v, lse and di) and the function's outputs written once (dK and dV
    per kv head, as the backward returns them, or dQ), against its
    products over the live pairs: S, dP, dV, dK (8 d FLOPs a pair) for
    dK/dV, S, dP, dQ (6 d) for dQ, at the inputs' rate or ``rate``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    es = q.element_size()
    pairs = hq * live_pairs(b, sq, skv, kw)
    nbytes = 2 * b * hq * sq * d * es + 2 * b * hkv * skv * d * es \
        + 2 * 4 * b * hq * sq
    if which == "dkv":
        nbytes += 2 * b * hkv * skv * d * es
        ops = 8.0 * d * pairs
    else:
        nbytes += b * hq * sq * d * es
        ops = 6.0 * d * pairs
    return bound(nbytes, ops, rate or str(q.dtype).removeprefix("torch."))


# The backward is held with a bar per row (row_agreement): a row of dK or
# dV is one kv position, a row of dQ one q position. Under a causal mask
# max |dV| comes from kv row 0, which every q row sees, and sits over 100x
# a typical late row, so one bar from the whole output's max could not
# fail a kernel that was 20% off on late tiles. Each causal case with sq
# = skv and no q offset or lse cotangent also holds a late-row control:
# the plain version with dO of every q row past s/2 raised by
# BWD_LATE_SHIFT. Rows past s/2 of dQ, dK and dV then grow by that
# factor, up to the rounding of the raised dO (only those q rows reach
# them), while earlier rows move less. The bar must catch it in at least
# BWD_LATE_CAUGHT of the late rows that keep their own bar; a bf16 dQ or
# dK row under 2^-9 of its output's max is held at a floor (below), and at
# most half the late rows may be. With Gemma-2's peaked scores (q std 10)
# many late dK rows are small: most q rows put P near 1 on one key, and a
# kv row that no q row favours gets little. A row's bar is 0.8-1.6% of
# its max |ref| (2 bf16 ulps), and a passing kernel may be off by a whole
# bar (Gemma-2's capped rows are: P near 1 flips its bf16 rounding), so a
# shift is sure to be seen only above twice the largest bar, 3.1%; 2^-4
# is four times it.
BWD_LATE_SHIFT = 1.0625
BWD_LATE_CAUGHT = 0.9
# A bf16 dQ or dK row's bar is at least BWD_ROW_FLOOR of its output's max
# |ref| (bwd_row_bars). That moves only rows under 2^-9 of the max (a
# row's own bar is at least 2^-7 of its max), where the f32 noise of a
# cancelling dS (near 2^-21 of the max) can outweigh the row.
BWD_ROW_FLOOR = 2.0 ** -16


def bwd_late_control(kw, sq, skv):
    """Whether a backward case can hold the late-row control: causal,
    sq = skv, no q offset and no lse cotangent (which dO's shift does
    not scale)."""
    return (kw.get("causal", False) and sq == skv
            and not kw.get("q_offset") and kw.get("dlse") is None)


def late_do(do):
    """dO with every q row past s/2 raised by BWD_LATE_SHIFT."""
    out = do.clone()
    out[..., do.shape[-2] // 2:, :] *= BWD_LATE_SHIFT
    return out


def flash_bwd_cases(dev):
    """(name, dtype, b, sq, skv, options, control options) at the training
    shape: hq 32 / hkv 8, d 128, s 2048; b 4 (the main path's) for the
    causal case, b 2 for the rest. Options are flash options; ``sinks``
    reaches only the forward that makes o and lse, ``dlse`` only the
    backward. The control drops the case's option."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    sinks = (math.log(2048) + 1.0
             + 0.5 * torch.randn(32, generator=g, device=dev))
    slopes = torch.linspace(0.5, 0.004, 32, device=dev)
    seg = segment_ids(2, 2048, 3, dev)
    dlse = torch.randn(2, 32, 2048, generator=g, device=dev)
    bf, causal = torch.bfloat16, dict(causal=True)
    return [
        ("causal", bf, TRAIN_TOKENS[0], 2048, 2048, causal,
         dict(causal=False)),
        ("noncausal", bf, 2, 2048, 2048, dict(causal=False), causal),
        ("offset_tail", bf, 2, 1024, 2048,
         dict(causal=True, q_offset=1000, kv_len=2024), causal),
        ("window", bf, 2, 2048, 2048, dict(causal=True, window=256), causal),
        ("softcap", bf, 2, 2048, 2048, dict(causal=True, softcap=5.0),
         causal),
        ("sinks", bf, 2, 2048, 2048, dict(causal=True, sinks=sinks), causal),
        ("alibi", bf, 2, 2048, 2048, dict(causal=True, alibi=slopes), causal),
        ("segments", bf, 2, 2048, 2048, dict(causal=True, q_seg=seg,
                                              kv_seg=seg), causal),
        ("dlse", bf, 2, 2048, 2048, dict(causal=True, dlse=dlse), causal),
        ("f32_causal", torch.float32, 2, 2048, 2048, causal,
         dict(causal=False)),
    ]


def check_flash_bwd(dev):
    """K8/K9 at the training shape: dq, dk and dv (per q head) of the two
    kernels against the plain version, each row within its own bar
    (row_agreement), the control (the plain version without the case's
    option) outside the bar in some row, and where bwd_late_control
    allows, the late-row control outside it in most late rows. o
    and lse come from the plain forward for both sides. bf16 cases hold
    the plain version with ``round_p`` (the kernels' bf16 P in dV) and
    log the error against the plain version without it (``vs_f32_p``).
    The sinks case also holds the autograd path's dsinks (kernels)
    against the plain path's."""
    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import api
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    def residuals(q, k, v, do, kw):
        fkw = {x: y for x, y in kw.items() if x != "dlse"}
        o, lse = flash_fwd_plain(q, k, v, sm_scale=SCALE, save_lse=True,
                                 **fkw)
        bkw = {x: y for x, y in kw.items() if x != "sinks"}
        return (q, k, v, o, do, lse), bkw

    rows = []
    for name, dt, b, sq, skv, kw, control in flash_bwd_cases(dev):
        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        q = torch.randn(b, 32, sq, 128, generator=g, device=dev).to(dt)
        k, v = (torch.randn(b, 8, skv, 128, generator=g, device=dev).to(dt)
                for _ in range(2))
        do = torch.randn(b, 32, sq, 128, generator=g, device=dev).to(dt)
        args, bkw = residuals(q, k, v, do, kw)
        out = bw.flash_bwd(*args, sm_scale=SCALE, **bkw)
        torch.cuda.synchronize()
        rp = dt == torch.bfloat16
        ref = bw.flash_bwd_plain(*args, sm_scale=SCALE, round_p=rp, **bkw)
        cargs, ckw = residuals(q, k, v, do, control)
        off = bw.flash_bwd_plain(*cargs, sm_scale=SCALE, round_p=rp, **ckw)
        exact = (bw.flash_bwd_plain(*args, sm_scale=SCALE, **bkw) if rp
                 else ref)
        shifted = ((None,) * 3 if not bwd_late_control(kw, sq, skv) else
                   bw.flash_bwd_plain(*args[:4], late_do(do), *args[5:],
                                      sm_scale=SCALE, round_p=rp, **bkw))
        grads = {}
        for gname, a, r, c, e, sh in zip(("dq", "dk", "dv"), out, ref, off,
                                         exact, shifted):
            # dV = P^T dO does not depend on an lse cotangent: no control.
            no_control = gname == "dv" and "dlse" in kw
            grads[gname] = row_agreement(
                a, r, None if no_control else c, gname,
                None if sh is None else (sh, sh.shape[-2] // 2))
            if rp:
                grads[gname]["vs_f32_p"] = max_err(a, e)
        del ref, off, exact, shifted
        if "sinks" in kw:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sk = kw["sinks"].clone().requires_grad_()

            def dsinks():
                o = api.flash_attention(*leaves, causal=True, sinks=sk)
                return torch.autograd.grad(o, sk, do)[0]

            got = dsinks()
            with plain_versions():
                want = dsinks()
            o0, lse0 = flash_fwd_plain(q, k, v, sm_scale=SCALE,
                                       causal=True, save_lse=True)
            ctrl = api.sink_grad(kw["sinks"], lse0, bw.softmax_di(o0, do))
            grads["dsinks"] = agreement(got, want, max_err(got, ctrl))

        def run():
            return bw.flash_bwd(*args, sm_scale=SCALE, **bkw)

        ms = {"dkv": kernel_ms(build.FLASH_BWD_DKV, run, 5),
              "dq": kernel_ms(build.FLASH_BWD_DQ, run, 5)}
        plain_ms = {w: time_ms(lambda w=w: bw.flash_bwd_plain(
            *args, sm_scale=SCALE, part=w, round_p=rp, **bkw), 2)
            for w in ms}
        bounds = {w: bwd_bound(q, k, bkw, w, bwd_rate(dt)) for w in ms}
        # The pair as flash_bwd launches it, its plain version and PyTorch's
        # fused-attention backward: three times of the whole backward.
        whole = dict(ms=time_ms(run, 5), plain_ms=time_ms(
            lambda: bw.flash_bwd_plain(*args, sm_scale=SCALE, round_p=rp,
                                       **bkw), 2),
            library_ms=sdpa_bwd_ms(q, k, v, do, kw))
        if not rp:
            whole.update(f32_extras(q, k, bkw, ms, whole))
        row = dict(case=name, dtype=str(dt).removeprefix("torch."),
                   shape=list(q.shape), kv_len=skv,
                   options={x: str(y) if not torch.is_tensor(y) else "tensor"
                            for x, y in kw.items()},
                   control={x: str(y) for x, y in control.items()},
                   **grads, ok=all(r_["ok"] for r_ in grads.values()),
                   ms=ms, plain_ms=plain_ms,
                   bound_ms={w: b_[0] for w, b_ in bounds.items()},
                   bound_by={w: b_[1] for w, b_ in bounds.items()},
                   whole=whole)
        rows.append(row)
        log("kernel_vs_plain", kernel="flash_bwd", **row)
    raise_if_failed("flash_bwd", rows)
    first = rows[0]
    f32 = next(r for r in rows if r["dtype"] == "float32")
    out = {}
    for which, outputs in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
        # No one PyTorch call computes one kernel's outputs alone: the
        # library's time stands only beside the whole backward's.
        out[f"flash_bwd_{which}"] = dict(
            max_abs_err=max(r[x]["max_abs_err"] for r in rows
                            for x in outputs),
            ms=first["ms"][which], plain_ms=first["plain_ms"][which],
            bound_ms=first["bound_ms"][which],
            bound_by=first["bound_by"][which], library_ms=None,
            whole_ms=first["whole"]["ms"],
            whole_plain_ms=first["whole"]["plain_ms"],
            whole_library_ms=first["whole"]["library_ms"],
            fp32_case=f32["case"], fp32_ms=f32["ms"][which],
            fp32_bound_ms=f32["bound_ms"][which],
            fp32_cuda_core_bound_ms=f32["whole"]["f32_rate_bound_ms"][which],
            fp32_whole_ms=f32["whole"]["ms"],
            fp32_whole_library_ms=f32["whole"]["library_ms"])
    return out


# The f32 backward's ask at phase 3's f32 case (b 2, 32/8 heads, s 2048,
# d 128, causal): the pair within F32_PAIR_MS, the whole flash_bwd below
# PyTorch's f32 fused-attention backward in the same run. Logged, not a
# gate of the run.
F32_PAIR_MS = 6.0


def bwd_rate(dtype) -> str:
    """The rate a backward kernel's bound takes: bf16's, or in f32 three
    TF32 passes, the kernels' own arithmetic."""
    import torch

    return "bfloat16" if dtype == torch.bfloat16 else "tf32x3"


def f32_extras(q, k, kw, ms, whole):
    """An f32 backward row's bound at the CUDA cores' f32 rate (beside its
    bound at three TF32 passes), and the two asks."""
    pair = ms["dkv"] + ms["dq"]
    lib = whole["library_ms"]
    return dict(f32_rate_bound_ms={w: bwd_bound(q, k, kw, w, "float32")[0]
                                   for w in ms},
                pair_ms=pair, pair_within_ask=pair <= F32_PAIR_MS,
                below_library=None if lib is None else whole["ms"] < lib)


def decode_inputs(dev, kv_dtype, ring, ps=128, heads=(32, 8)):
    """The main path's decode shape: b 8, hq 32 / hkv 8 (or ``heads``), d
    128, context 2048 in ``ps``-token pages (128 as phase 4's explicit
    bf16/int8 layout, 512 as the auto layout of the quantized tiers) out
    of 1 + 160 * 128 / ps. ``kv_dtype`` is a cache tier (k8v4: int8 K,
    int4 V)."""
    import torch

    from tpu_flash_torch.engine.cache import side_dtypes
    from tpu_flash_torch.ops.quant import quantize_pages

    g = torch.Generator(device=dev).manual_seed(SEED)
    b, d = 8, 128
    hq, hkv = heads
    pps, n_pages = 2048 // ps, 1 + 160 * 128 // ps
    kp = torch.randn(hkv, n_pages, ps, d, generator=g, device=dev)
    vp = torch.randn(hkv, n_pages, ps, d, generator=g, device=dev)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    lengths = torch.full((b,), 2048, dtype=torch.int32, device=dev)
    q = torch.randn(b, hq, d, generator=g, device=dev).bfloat16()
    if kv_dtype == "bfloat16":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    else:
        k_t, v_t = side_dtypes(kv_dtype)
        kp, vp = quantize_pages(kp, k_t), quantize_pages(vp, v_t)
    kw = {}
    if ring:
        r = torch.randn(2, b, hkv, ring, d, generator=g, device=dev)
        kw = dict(recent_k=r[0].bfloat16(), recent_v=r[1].bfloat16())
    return q, kp, vp, lengths, table, kw


def side_bytes(tier, d):
    """Bytes one token of one kv head takes in the cache on one side at
    head width d: payload (4-bit tiers half a byte an element) and scales
    (an f32 per token, or int4g32's 2 * d/32 f32 (scale, zero) pairs)."""
    return {"bfloat16": 2 * d, "int8": d + 4, "int4": d // 2 + 4,
            "int4g32": d // 2 + 2 * (d // 32) * 4, "fp8": d + 4}[tier]


# The operation type each tier's dots run in, for the bound.
TIER_OPS = {"bfloat16": "bfloat16", "int8": "int8", "int4": "int8",
            "int4g32": "bfloat16", "k8v4": "int8", "fp8": "fp8"}


def decode_bound(q, lengths, kw, kv_dtype, hkv=8):
    from tpu_flash_torch.engine.cache import side_dtypes

    b, hq, d = q.shape
    w = kw["recent_k"].shape[2] if "recent_k" in kw else 0
    window = kw.get("window")
    # Tokens attended, and those the pages must give (before the ring).
    attended = sum(min(int(n), window or int(n)) for n in lengths)
    page_tokens = sum(min(max(int(n) - w, 0), window or int(n))
                      for n in lengths)
    per_tok = hkv * sum(side_bytes(t, d) for t in side_dtypes(kv_dtype))
    nbytes = (page_tokens * per_tok + 2 * b * w * hkv * d * 2
              + 2 * q.numel() * q.element_size() + 8 * b + 4 * b * 16)
    ops = 4.0 * hq * d * attended
    return bound(nbytes, ops, TIER_OPS[kv_dtype])


def without_p_cast(q, kp, vp, lengths, table, sm_scale, **_):
    """The bf16 tier's plain version without its bf16 P cast: the f32 tier
    on the same bf16 page values. With bf16-valued q and a power-of-two
    sm_scale the q rows are bf16 already, so P's cast is all that
    differs."""
    from tpu_flash_torch.ops.decode import paged as dp

    ppb = dp.pages_per_block(kp.shape[2], table.shape[1], True)
    return dp.paged_decode_plain(
        q, kp, vp, None, None, lengths, table, k_tier="float32",
        v_tier="float32", sm_scale=sm_scale, pages_per_compute_block=ppb,
    )


def swapped_halves(pages):
    """Token-packed int4 pages with each byte's two nibbles swapped: every
    token reads its partner's (the half-page) values."""
    import torch

    b = pages.values.view(torch.uint8)
    return pages._replace(values=((b >> 4) | (b << 4)).view(torch.int8))


def zeros_dropped(pages):
    """int4g32 pages with every zero-point row set to 0."""
    ng = pages.scales.shape[2] // 2
    scales = pages.scales.clone()
    scales[:, :, ng:] = 0.0
    return pages._replace(scales=scales)


def unscaled(pages):
    """Quantized pages with every per-token scale 1."""
    import torch

    return pages._replace(scales=torch.ones_like(pages.scales))


# Per-row lengths of the ragged cases: a token, both sides of a page edge
# and of the 128-token ring (rows at L <= 128 leave the pages no live
# token), a window's worth, and both sides of the 2048-token table's end.
RAGGED_LENGTHS = (1, 127, 128, 129, 700, 1500, 2047, 2048)

# (case, kv dtype, page size, f32 q, kwargs, control). The control is the
# kwargs with the case's option dropped, a plain function, or a page
# transform that a kernel ignoring part of the tier's format would match
# (on V only where K would swamp it). The 4-bit and fp8 cases take the
# auto layout's 512-token pages and 128-token ring of phase 4. "ragged":
# the batch's rows at RAGGED_LENGTHS (its control: every row at 2048).
DECODE_CASES = [
    ("bf16", "bfloat16", 128, False, {}, None),
    ("bf16_f32_q", "bfloat16", 128, True, dict(sm_scale=0.125),
     without_p_cast),
    ("int8_mxu", "int8", 128, False, dict(int8_mxu=True),
     dict(int8_mxu=False)),
    ("int8_exact", "int8", 128, False, dict(int8_mxu=False),
     dict(int8_mxu=True)),
    ("int8_mxu_ring128", "int8", 128, False, dict(int8_mxu=True, ring=128),
     dict(int8_mxu=True)),
    ("int4_mxu_ring128", "int4", 512, False, dict(int8_mxu=True, ring=128),
     dict(int8_mxu=False, ring=128)),
    ("int4_exact_ring128", "int4", 512, False,
     dict(int8_mxu=False, ring=128), ("v", swapped_halves)),
    ("int4_mxu_window", "int4", 512, False, dict(int8_mxu=True, window=700),
     dict(int8_mxu=True)),
    ("int4g32_ring128", "int4g32", 512, False, dict(ring=128),
     ("v", zeros_dropped)),
    ("k8v4_mxu_ring128", "k8v4", 512, False, dict(int8_mxu=True, ring=128),
     ("v", swapped_halves)),
    ("k8v4_exact_ring128", "k8v4", 512, False,
     dict(int8_mxu=False, ring=128), dict(int8_mxu=True, ring=128)),
    ("fp8_native_ring128", "fp8", 512, False,
     dict(fp8_native=True, ring=128), dict(fp8_native=False, ring=128)),
    ("fp8_exact_ring128", "fp8", 512, False,
     dict(fp8_native=False, ring=128), ("v", unscaled)),
    ("int8_mxu_ring128_ragged", "int8", 128, False,
     dict(int8_mxu=True, ring=128, ragged=True), dict(int8_mxu=True,
                                                      ring=128)),
    ("bf16_ragged", "bfloat16", 128, False, dict(ragged=True), {}),
    ("int4_mxu_ring128_ragged", "int4", 512, False,
     dict(int8_mxu=True, ring=128, ragged=True), dict(int8_mxu=True,
                                                      ring=128)),
    ("int4g32_ring128_ragged", "int4g32", 512, False,
     dict(ring=128, ragged=True), dict(ring=128)),
    ("k8v4_mxu_ring128_ragged", "k8v4", 512, False,
     dict(int8_mxu=True, ring=128, ragged=True), dict(int8_mxu=True,
                                                      ring=128)),
    ("fp8_native_ring128_ragged", "fp8", 512, False,
     dict(fp8_native=True, ring=128, ragged=True), dict(fp8_native=True,
                                                        ring=128)),
    # Four kv blocks of 512 tokens (the recurrence runs across them), a
    # window whose first token sits inside a page, (m, l) returned.
    ("bf16_bk512_window900_state_ragged", "bfloat16", 128, False,
     dict(pages_per_compute_block=4, window=900, return_state=True,
          ragged=True), dict(pages_per_compute_block=4, return_state=True,
                             ragged=True)),
    ("int8_mxu_bk512_ragged", "int8", 128, False,
     dict(int8_mxu=True, pages_per_compute_block=4, ragged=True),
     dict(int8_mxu=True, pages_per_compute_block=4)),
]


def decode_tag(kv_dtype, kw):
    """The kernel's launch tag of a case: its K/V tiers as the wrapper
    names them (int8_mxu and fp8_native default on, on this card)."""
    from tpu_flash_torch.engine.cache import side_dtypes

    def tier(t):
        if t in ("int8", "int4") and kw.get("int8_mxu", True):
            return t + "_mxu"
        if t == "fp8" and kw.get("fp8_native", True):
            return "fp8_native"
        return t

    k, v = (tier(t) for t in side_dtypes(kv_dtype))
    return k if k == v else f"{k}/{v}"


def check_decode(dev):
    """K4 per tier at the main path's decode shape. Returns the int8 ring
    case (the kernel's summary row) and a row for each other tier tag."""
    import torch

    from tpu_flash_torch.ops.decode import paged as dp

    rows = []
    for name, kv_dtype, ps, f32_q, kw, control in DECODE_CASES:
        kw = dict(kw)
        q, kp, vp, full, table, ring = decode_inputs(
            dev, kv_dtype, kw.pop("ring", 0), ps
        )
        ragged = torch.tensor(RAGGED_LENGTHS, dtype=torch.int32, device=dev)
        lengths = ragged if kw.pop("ragged", False) else full
        if f32_q:
            q = q.float()
        kw.update(ring)

        def kernel(over=None, pages=(kp, vp)):
            args, lens = dict(kw), lengths
            if over is not None:
                args = dict(over)
                if args.pop("ring", 0):
                    args.update(ring)
                lens = ragged if args.pop("ragged", False) else full
            return dp.paged_attention(q, *pages, lens, table, **args)

        out = kernel()
        torch.cuda.synchronize()
        with plain_versions():
            ref = kernel()
            plain_ms = time_ms(kernel, 3)
            if callable(control):
                off = max_err(out, control(q, kp, vp, lengths, table, **kw))
            elif isinstance(control, tuple):
                off = max_err(out, kernel(pages=(kp, control[1](vp))))
            else:
                off = None if control is None else max_err(
                    out, kernel(dict(control)))
        bound_ms, bound_by = decode_bound(q, lengths, kw, kv_dtype)
        ctl = (getattr(control, "__name__", control)
               if not isinstance(control, tuple)
               else f"{control[0]}:{control[1].__name__}")
        o, o_ref = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
        row = dict(case=name, tier=decode_tag(kv_dtype, kw), batch=q.shape[0],
                   context=int(lengths.max()), lengths=lengths.tolist(),
                   page_size=ps, q_dtype=str(q.dtype).removeprefix("torch."),
                   control=str(ctl), **agreement(o, o_ref, off),
                   differing=differing(out, ref),
                   ms=device_ms(kernel, 50),
                   warm_ms=device_ms(kernel, 50, cold=False),
                   call_ms=time_ms(kernel, 50),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None)
        row["ok"] = row["ok"] and row["differing"] == 0
        rows.append(row)
        log("kernel_vs_plain", kernel="paged_decode", **row)
    raise_if_failed("paged_decode", rows)
    primary = next(r for r in rows if r["case"] == "int8_mxu_ring128")
    out = {"paged_decode": dict(
        primary, max_abs_err=max(r["max_abs_err"] for r in rows))}
    served = {decode_tag(t, {}) for t in AUTO_TIERS}
    for r in rows:  # the tiers phase 4 serves, at the auto layout
        if r["page_size"] == 512 and r["tier"] in served:
            out.setdefault(f"paged_decode:{r['tier']}", r)
    return out


# 16 q heads a kv head (64 / 4), twice what one launch holds: the wrapper
# launches once per 8-head chunk of every group. (case, tier, options.)
WIDE_GROUP = (64, 4)
WIDE_GROUP_CASES = [
    ("bf16_sinks_alibi", "bfloat16", dict(sinks=True, alibi=True)),
    ("int8_mxu_ring128", "int8", dict(int8_mxu=True, ring=128)),
]


def check_decode_wide_group(dev):
    """K4 at 16 q heads a kv head on bf16 and int8 pages: the output bit
    for bit the plain version's (one call over all 64 heads), two
    launches a call (one per chunk)."""
    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.decode import paged as dp

    rows = []
    for name, kv_dtype, opts in WIDE_GROUP_CASES:
        kw = dict(opts)
        q, kp, vp, lengths, table, ring = decode_inputs(
            dev, kv_dtype, kw.pop("ring", 0), heads=WIDE_GROUP)
        kw.update(ring)
        hq = WIDE_GROUP[0]
        g = torch.Generator(device=dev).manual_seed(SEED + 30)
        if kw.pop("sinks", False):
            kw["sinks"] = math.log(2048) + torch.randn(hq, generator=g,
                                                       device=dev)
        if kw.pop("alibi", False):
            kw["alibi"] = torch.linspace(0.3, 0.001, hq, device=dev)

        def kernel():
            return dp.paged_attention(q, kp, vp, lengths, table, **kw)

        before = build.PAGED_DECODE.launches
        out = kernel()
        torch.cuda.synchronize()
        launches = build.PAGED_DECODE.launches - before
        with plain_versions():
            ref = kernel()
        row = dict(case=name, heads=list(WIDE_GROUP),
                   tier=decode_tag(kv_dtype, kw), launches=launches,
                   max_abs_err=max_err(out, ref),
                   bit_exact=bool(torch.equal(out, ref)),
                   ms=device_ms(kernel, 20))
        row["ok"] = row["bit_exact"] and launches == 2
        rows.append(row)
        log("kernel_vs_plain", kernel="paged_decode", **row)
    raise_if_failed("paged_decode at 16 q heads a kv head", rows)
    return rows


def prefill_pairs(offsets, q_len, window=None):
    """(query, key) pairs a chunk at per-row history ``offsets`` attends,
    summed over rows: its history (inside the window) plus itself,
    causally."""
    pairs = 0
    for off in offsets:
        for i in range(q_len):
            lo = max(0, off + i - window + 1) if window else 0
            pairs += off + i + 1 - lo
    return pairs


def prefill_bound(q, hkv, offsets, window, kv_bytes_per_token):
    """Least time for a prefill chunk's attention: q, the chunk's K/V and
    o once, the history K/V some query of a row sees once (as stored,
    ``kv_bytes_per_token`` for all kv heads), and 4 d FLOPs per (q head,
    query, key) pair: (ms, bound by) at the tensor cores' bf16 rate, and
    the ms at the CUDA cores' f32 rate, which bounds the order-exact
    kernels (K5, K6: prefill_tile.cuh)."""
    b, hq, q_len, d = q.shape
    hist = sum(min(off, window - 1) if window else off for off in offsets)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * hkv * q_len * d * q.element_size()
              + 2 * hist * kv_bytes_per_token + 4 * b)
    ops = 4.0 * hq * d * prefill_pairs(offsets, q_len, window)
    return (*bound(nbytes, ops, "bfloat16"),
            bound(nbytes, ops, "float32")[0])


def raised(v):
    """A chunk's V or a layer's V pages with every value raised by
    VARIANT_LATE_SHIFT (quantized pages through their scales): the
    late-row control's V."""
    if hasattr(v, "_replace"):
        return v._replace(scales=v.scales * VARIANT_LATE_SHIFT)
    return (v.float() * VARIANT_LATE_SHIFT).to(v.dtype)


def prefill_rows(out, ref, control, late):
    """K5 or K6 against its plain version with a bar per row
    (row_agreement, as K1): every row within its bar, the control (the
    plain version without the case's option or offsets) off some row's
    bar, and ``late`` (the plain version on V raised by
    VARIANT_LATE_SHIFT) off the bars of at least VARIANT_LATE_CAUGHT of
    the rows past q_len / 2; with how many output elements differ from
    the plain version by any bit."""
    row = row_agreement(out, ref, control, None, (late, ref.shape[2] // 2),
                        late_caught=VARIANT_LATE_CAUGHT)
    row.update(differing=int((out != ref).sum()), elements=ref.numel())
    return row


def paged_prefill_inputs(dev, b, q_len, hist_cap, kv_dtype, seed=SEED,
                         ps=128):
    """Chunk q/K/V (hq 32 / hkv 8, d 128, bf16) and ``ps``-token pages
    holding up to 2048 tokens per row (bf16, or int8 / int4 / fp8 with
    per-token scales), with a random page table over b * 2048 / ps + 1
    pages."""
    import torch

    from tpu_flash_torch.ops.quant import quantize_pages

    g = torch.Generator(device=dev).manual_seed(seed)
    pps = 2048 // ps
    n_pages = pps * b + 1

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = rn(b, 32, q_len, 128).bfloat16()
    ck, cv = rn(b, 8, q_len, 128).bfloat16(), rn(b, 8, q_len, 128).bfloat16()
    kp, vp = rn(8, n_pages, ps, 128), rn(8, n_pages, ps, 128)
    if kv_dtype == "bfloat16":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    else:
        kp, vp = quantize_pages(kp, kv_dtype), quantize_pages(vp, kv_dtype)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    return q, ck, cv, kp, vp, table


def check_paged_prefill(dev):
    """K5 at the main path's shapes: chunks at history 1024, mixed stages,
    the verify shape, each option and the tile's edges, each against its
    plain version per row (prefill_rows), with a control that drops the
    case's option and a late-row control."""
    import torch

    from tpu_flash_torch.ops.flash import paged_prefill as pp

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    # Scores have std ~1 here: softcap 5 bends the largest, sinks near
    # log(kv_len) + 1 weigh about as much as all the keys.
    sinks = (math.log(1536) + 1.0
             + 0.5 * torch.randn(32, generator=g, device=dev))
    slopes = torch.linspace(0.5, 0.004, 32, device=dev)
    rows = []
    # (case, b, q_len, hist_cap, pages, offsets, kwargs, control): the
    # control is kwargs/offsets overrides, or "unscaled" (quantized pages
    # without their scales). int4 and fp8 pages take the auto layout's
    # 512 tokens (phase 4), the others phase 4's explicit 128. The tile's
    # edges: offsets off its 64-row steps and 128-column windows (the
    # control rounds them to a window), offset 0 beside offset hist_cap,
    # length-1 rows (a fused step's decode rows), a window that ends
    # inside a step.
    verify_lens = [1100 + 100 * i for i in range(8)]
    for name, b, q_len, hist_cap, kv, offsets, kw, control in [
        ("chunk_bf16", 4, 512, 1024, "bfloat16", [1024] * 4, {},
         dict(offsets=[0] * 4)),
        ("chunk_int8", 4, 512, 1024, "int8", [1024] * 4, {}, "unscaled"),
        ("chunk_int4", 4, 512, 1024, "int4", [1024] * 4, {}, "unscaled"),
        ("chunk_fp8", 4, 512, 1024, "fp8", [1024] * 4, {}, "unscaled"),
        ("mixed_offsets", 4, 512, 1536, "bfloat16", [0, 512, 1024, 1536],
         {}, dict(offsets=[1536] * 4)),
        ("verify", 8, 9, 2048, "bfloat16", verify_lens, {},
         dict(offsets=[1450] * 8)),
        ("window", 2, 512, 1024, "bfloat16", [1024] * 2, dict(window=256),
         dict(kw={})),
        ("softcap", 2, 512, 1024, "bfloat16", [1024] * 2,
         dict(softcap=5.0), dict(kw={})),
        ("sinks", 2, 512, 1024, "bfloat16", [1024] * 2, dict(sinks=sinks),
         dict(kw={})),
        ("alibi", 2, 512, 1024, "bfloat16", [1024] * 2, dict(alibi=slopes),
         dict(kw={})),
        ("offsets_unaligned", 4, 512, 1536, "bfloat16",
         [37, 700, 1100, 1535], {}, dict(offsets=[0, 640, 1024, 1536])),
        ("offset_zero_and_cap", 2, 512, 2048, "int8", [0, 2048], {},
         dict(offsets=[128, 1920])),
        ("decode_rows", 8, 1, 2048, "bfloat16",
         [1, 63, 64, 129, 700, 1500, 2047, 2048], {}, dict(offsets=[0] * 8)),
        ("window_in_step", 3, 300, 1024, "int8", [0, 700, 1024],
         dict(window=200), dict(kw={})),
    ]:
        ps = 512 if kv in ("int4", "fp8") else 128
        q, ck, cv, kp, vp, table = paged_prefill_inputs(dev, b, q_len,
                                                        hist_cap, kv, ps=ps)

        def run(offs=offsets, pages=(kp, vp), kw=kw, cv=cv):
            o = torch.tensor(offs, dtype=torch.int32, device=dev)
            return pp.paged_prefill_attention(
                q, ck, cv, pages[0], pages[1], o, table, hist_cap=hist_cap,
                **kw)

        out = run()
        torch.cuda.synchronize()
        with plain_versions():
            ref = run()
            plain_ms = time_ms(run, 3)
            if control == "unscaled":
                ctl = run(pages=(unscaled(kp), unscaled(vp)))
            else:
                ctl = run(offs=control.get("offsets", offsets),
                          kw=control.get("kw", kw))
            late = run(pages=(kp, raised(vp)), cv=raised(cv))
        bound_ms, bound_by, fp32_ms = prefill_bound(
            q, 8, offsets, kw.get("window"), 8 * side_bytes(kv, 128))
        row = dict(case=name, batch=b, q_len=q_len, hist_cap=hist_cap,
                   pages=kv, page_size=ps, offsets=offsets,
                   control=control if isinstance(control, str)
                   else {k_: str(v_) for k_, v_ in control.items()},
                   **prefill_rows(out, ref, ctl, late), ms=time_ms(run, 10),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   fp32_bound_ms=fp32_ms, library_ms=None)
        rows.append(row)
        log("kernel_vs_plain", kernel="paged_prefill", **row)
        del out, ref, ctl, late
    raise_if_failed("paged_prefill", rows)
    out = {"paged_prefill": dict(
        rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))}
    for r in rows:
        if r["pages"] in ("int4", "fp8") and r["case"].startswith("chunk"):
            out[f"paged_prefill:{r['pages']}"] = r
    return out


def ragged_mask(offsets, q_len, hist_cap, window, dev):
    """The boolean [b, 1, q_len, hist_cap + q_len] mask of the ragged
    layout, for PyTorch's fused attention as a yardstick."""
    import torch

    j = torch.arange(hist_cap + q_len, device=dev)[None, None, None, :]
    i = torch.arange(q_len, device=dev)[None, None, :, None]
    offs = torch.tensor(offsets, device=dev)[:, None, None, None]
    hist = (j < offs) & (j < hist_cap)
    chunk = (j >= hist_cap) & (j - hist_cap <= i)
    if window:
        hist = hist & (j > offs + i - window)
        chunk = chunk & (j - hist_cap > i - window)
    return hist | chunk


def check_ragged(dev):
    """K6 at the main path's fused-step shape: chunks of 512 at history
    {0, 512, 1024, 1536} over [history padded to 1536 | chunk], a window
    case and the tile's edges (offsets off its steps and windows, offset
    0 beside hist_cap, length-1 rows, a window ending inside a step),
    each held per row (prefill_rows); SDPA on the same mask beside it."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from tpu_flash_torch.ops.flash import ragged

    rows = []
    hist_cap = 1536
    for name, q_len, offsets, kw, control in [
        ("mixed_offsets", 512, [0, 512, 1024, 1536], {},
         dict(offsets=[1536] * 4)),
        ("window", 512, [0, 512, 1024, 1536], dict(window=256),
         dict(kw={})),
        ("offsets_unaligned", 512, [37, 700, 1100, 1535], {},
         dict(offsets=[0, 640, 1024, 1536])),
        ("offset_zero_and_cap", 512, [0, 1536, 0, 1536], {},
         dict(offsets=[128, 1408, 128, 1408])),
        ("decode_rows", 1, [1, 700, 1535, 1536], {},
         dict(offsets=[0] * 4)),
        ("window_in_step", 512, [0, 300, 1000, 1536], dict(window=200),
         dict(kw={})),
    ]:
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        b = len(offsets)
        q = torch.randn(b, 32, q_len, 128, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, 8, hist_cap + q_len, 128, generator=g,
                            device=dev).bfloat16() for _ in range(2))

        def run(offs=offsets, kw=kw, v=v):
            o = torch.tensor(offs, dtype=torch.int32, device=dev)
            return ragged.flash_attention_ragged(q, k, v, o,
                                                 hist_cap=hist_cap, **kw)

        out = run()
        torch.cuda.synchronize()
        with plain_versions():
            ref = run()
            plain_ms = time_ms(run, 3)
            ctl = run(offs=control.get("offsets", offsets),
                      kw=control.get("kw", kw))
            late = run(v=raised(v))
        bound_ms, bound_by, fp32_ms = prefill_bound(
            q, 8, offsets, kw.get("window"), 8 * 128 * 2)
        library_ms = None
        if q_len > 1:
            mask = ragged_mask(offsets, q_len, hist_cap, kw.get("window"),
                               dev)
            try:
                sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
                library_ms = time_ms(
                    lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True),
                    10)
            except TypeError:  # PyTorch without enable_gqa
                pass
        row = dict(case=name, batch=b, q_len=q_len, hist_cap=hist_cap,
                   offsets=offsets,
                   control={k_: str(v_) for k_, v_ in control.items()},
                   **prefill_rows(out, ref, ctl, late), ms=time_ms(run, 10),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   fp32_bound_ms=fp32_ms, library_ms=library_ms)
        rows.append(row)
        log("kernel_vs_plain", kernel="ragged_prefill", **row)
        del out, ref, ctl, late
    raise_if_failed("ragged_prefill", rows)
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


# The quantized-input forward (K10) at BASELINE config 4's geometry: b 1,
# 32 q / 8 kv heads, d 128, causal; each tier at 8192 tokens against its
# plain version there (bf16 out as config 4 writes it, and f32 out), the
# options at 2048. Every case's control drops its option (fp8 tiers: the
# other tier). K10 is held with a bar per row (row_bars): a causal row
# past a few thousand tokens has |out| near 0.8 sqrt(e / n), some 30x
# under row 0's, so one bar from the whole output's max would sit above
# the typical late value. The f32 cases at 8192 also hold a late-row
# control: the plain version with the k scales of every column past the
# middle raised by QUANT_LATE_SHIFT, an error of about 1% of each late
# row's max |out| (rows before the middle are untouched); the bar must
# catch it in at least QUANT_LATE_CAUGHT of the late rows.
QUANT_SEQ = 8192
QUANT_OPTION_SEQ = 2048
QUANT_LATE_SHIFT = 1.01
QUANT_LATE_CAUGHT = 0.9
# (q heads, kv heads, head width, q's standard deviation) of K10's cases:
# config 4's geometry, Gemma-2-9B's and d 64.
QUANT_GEO = (32, 8, 128, 1.0)


def quant_inputs(dev, dtype_name, s, seed=SEED, geo=QUANT_GEO):
    import torch

    from tpu_flash_torch.ops.flash import quantize_attention_inputs

    hq, hkv, d, q_std = geo
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (q_std * torch.randn(1, hq, s, d, generator=g,
                             device=dev)).bfloat16()
    k = torch.randn(1, hkv, s, d, generator=g, device=dev).bfloat16()
    v = torch.randn(1, hkv, s, d, generator=g, device=dev).bfloat16()
    return q, k, v, quantize_attention_inputs(q, k, v, dtype_name)


def quant_cases(dev):
    """(name, dtype_name, seq, quant_fwd options, control options[,
    geometry]): QUANT_GEO unless a case names its own. The first three
    cases write bf16 as config 4 does; the rest of config 4's write f32,
    whose bar (2^-12 of each row's max |ref|) separates the tiers and
    routes sharply: kernel and plain version round P identically (exact
    scores) and differ only in the order of f32 sums. The width cases:
    Gemma-2-9B's d 256 (an int8 causal prefill, a sliding layer's
    fp8 native prefill with its window and cap, the staircase) and d 64."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    sinks = (math.log(QUANT_OPTION_SEQ) + 1.0
             + 0.5 * torch.randn(32, generator=g, device=dev))
    slopes = torch.linspace(0.5, 0.004, 32, device=dev)
    causal = dict(causal=True)
    f32 = dict(out_dtype=torch.float32)
    native, soft = dict(fp8_native=True), dict(fp8_native=False)
    i8, f8 = "int8", "fp8"
    big, opt = QUANT_SEQ, QUANT_OPTION_SEQ
    # q at GEMMA_Q_STD where the cap must bend scores; else at 1, where
    # rows spread their weight and the late-row control can move them (at
    # GEMMA_Q_STD most rows sit on one key, and the 1% k-scale shift puts
    # fewer than QUANT_LATE_CAUGHT of the late rows past their bars).
    gemma = (*GEMMA_HEADS, GEMMA_D, 1.0)
    gemma_cap = (*GEMMA_HEADS, GEMMA_D, GEMMA_Q_STD)
    narrow = (32, 8, 64, 1.0)
    return [
        ("int8_causal", i8, big, causal, dict(causal=False)),
        ("fp8_native_causal", f8, big, dict(causal=True, **native),
         dict(causal=False, **native)),
        ("fp8_software_causal", f8, big, dict(causal=True, **soft),
         dict(causal=False, **soft)),
        ("int8_causal_f32", i8, big, dict(causal=True, **f32),
         dict(causal=False, **f32)),
        ("fp8_native_causal_f32", f8, big, dict(causal=True, **native, **f32),
         dict(causal=False, **native, **f32)),
        ("fp8_software_causal_f32", f8, big,
         dict(causal=True, **soft, **f32), dict(causal=False, **soft, **f32)),
        ("fp8_native_f32", f8, opt, dict(causal=True, **native, **f32),
         dict(causal=True, **soft, **f32)),
        ("fp8_software_f32", f8, opt, dict(causal=True, **soft, **f32),
         dict(causal=True, **native, **f32)),
        ("fp8_native_sinks_alibi", f8, opt,
         dict(causal=True, sinks=sinks, alibi=slopes, **native),
         dict(causal=True, **native)),
        ("int8_noncausal", i8, opt, dict(causal=False), causal),
        ("int8_window", i8, opt, dict(causal=True, window=256), causal),
        ("int8_softcap", i8, opt, dict(causal=True, softcap=5.0), causal),
        ("int8_sinks", i8, opt, dict(causal=True, sinks=sinks), causal),
        ("int8_alibi", i8, opt, dict(causal=True, alibi=slopes), causal),
        ("int8_kv_tail", i8, opt, dict(causal=False, kv_len=opt - 100),
         dict(causal=False)),
        ("int8_onepass_f32", i8, opt, dict(causal=True, onepass=True, **f32),
         dict(causal=True, **f32)),
        ("d256_int8_causal_f32", i8, big, dict(causal=True, **f32),
         dict(causal=False, **f32), gemma),
        ("d256_fp8_native_sliding", f8, big,
         dict(causal=True, window=GEMMA_WINDOW, softcap=GEMMA_CAP, **native),
         dict(causal=True, **native), gemma_cap),
        ("d256_int8_onepass_f32", i8, opt,
         dict(causal=True, onepass=True, **f32), dict(causal=True, **f32),
         gemma),
        ("d64_int8_causal", i8, opt, causal, dict(causal=False), narrow),
        ("d64_fp8_native_f32", f8, opt, dict(causal=True, **native, **f32),
         dict(causal=True, **soft, **f32), narrow),
    ]


def quant_bound(qi, kw):
    """Least time of one K10 call: its payloads, scales and bf16 output
    moved once, against QK^T at the int8/fp8 rate and P V at the rate of
    the type it runs in (int8 on the staircase, e4m3 on the native tier,
    bf16 otherwise) over this run's live pairs."""
    import torch

    b, hq, sq, d = qi.q_values.shape
    skv = qi.k_values.shape[2]
    pairs = hq * live_pairs(b, sq, skv, kw)
    out_bytes = 4 if kw.get("out_dtype") == torch.float32 else 2
    nbytes = (qi.q_values.numel() + 2 * qi.k_values.numel()
              + 4 * (b * hq * sq + 2 * b * qi.k_values.shape[1] * skv)
              + out_bytes * qi.q_values.numel())
    pv_type = ("int8" if kw.get("onepass") else
               "fp8" if kw.get("fp8_native") else "bfloat16")
    t_ops = (2.0 * d * pairs / PEAK_OPS_PER_S["int8"]
             + 2.0 * d * pairs / PEAK_OPS_PER_S[pv_type])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_quant_fwd(dev):
    """K10: each case's kernel output against its plain version on the
    same inputs with a bar per row, its control outside the bar (and, at
    8192 in f32, the late-row control caught); times at each case."""
    import torch

    from tpu_flash_torch.ops.flash import quantized as qz

    rows = []
    inputs = {}
    for name, dtype_name, s, kw, control, *geo in quant_cases(dev):
        geo = geo[0] if geo else QUANT_GEO
        key = (dtype_name, s, geo)
        if key not in inputs:
            inputs.clear()
            inputs[key] = quant_inputs(dev, dtype_name, s, geo=geo)[3]
        qi = inputs[key]
        scale = geo[2] ** -0.5

        def call(fn, opts, args=qi[:6]):
            return fn(*args, dtype_name=dtype_name, sm_scale=scale,
                      **{"out_dtype": torch.bfloat16, **opts})

        out = call(qz.quant_fwd, kw)
        torch.cuda.synchronize()
        ref = call(qz.quant_fwd_plain, kw)
        bars = row_bars(ref)
        missed = int(row_misses(out, ref, bars).sum())
        ctl_missed = int(row_misses(out, call(qz.quant_fwd_plain, control),
                                    bars).sum())
        late = {}
        if s == QUANT_SEQ and ref.dtype == torch.float32:
            k_scales = qi.k_scales.clone()
            k_scales[..., s // 2:] *= QUANT_LATE_SHIFT
            shifted = call(qz.quant_fwd_plain, kw,
                           args=(*qi[:3], k_scales, *qi[4:6]))
            rows_late = slice(s // 2, None)
            caught = row_misses(out[:, :, rows_late], shifted[:, :, rows_late],
                                bars[:, :, rows_late])
            size = ((shifted - ref).abs().amax(-1)
                    / ref.abs().amax(-1))[:, :, rows_late]
            late = dict(late_caught=float(caught.float().mean()),
                        late_shift_rel_median=float(size.median()),
                        late_median_abs_ref=float(
                            ref[:, :, rows_late].abs().median()),
                        late_median_bar=float(bars[:, :, rows_late].median()))
            del shifted
        ok = (missed == 0 and ctl_missed > 0
              and late.get("late_caught", 1.0) >= QUANT_LATE_CAUGHT)
        big = s == QUANT_SEQ
        ms = time_ms(lambda: call(qz.quant_fwd, kw), 3 if big else 5,
                     warmup=1)
        plain_ms = time_ms(lambda: call(qz.quant_fwd_plain, kw), 1,
                           warmup=0)
        bound_ms, bound_by = quant_bound(qi, kw)
        row = dict(case=name, dtype=dtype_name, seq=s, heads=list(geo[:2]),
                   d=geo[2], out=str(out.dtype).removeprefix("torch."),
                   control={k_: str(v_) for k_, v_ in control.items()},
                   max_abs_err=max_err(out, ref),
                   max_abs_ref=float(ref.float().abs().max()),
                   max_err_over_row_bar=float(
                       ((out.float() - ref.float()).abs().amax(-1)
                        / bars.clamp_min(1e-30)).max()),
                   median_abs_ref=float(ref.float().abs().median()),
                   median_row_bar=float(bars.median()),
                   rows_missed=missed, control_rows_missed=ctl_missed,
                   differ_plain=differing(out, ref),
                   **late, ok=ok, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        rows.append(row)
        log("kernel_vs_plain", kernel="quant_fwd", **row)
        del out, ref
    raise_if_failed("quant_fwd", rows)
    # The kernels line times int8 at config 4's shape, the first case, and
    # carries the first d 256 and d 64 cases. No one PyTorch call
    # computes attention over quantized inputs with these roundings (SDPA
    # on dequantized inputs is another function).
    widths = {}
    for r in rows:
        prefix = f"d{r['d']}_"
        if r["d"] != QUANT_GEO[2] and prefix + "case" not in widths:
            widths.update({prefix + x: r[x] for x in (
                "case", "ms", "plain_ms", "bound_ms", "library_ms")})
    return dict(rows[0], **widths,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms_by_case={r["case"]: r["ms"] for r in rows})


def check_quantize_rows(dev):
    """K11 at config 4's q (32 x 8192 rows of 128, bf16): byte for byte
    against its plain version and against quantize_attention_inputs'
    int8 q on the plain path."""
    import torch

    from tpu_flash_torch.ops.flash import quantize_attention_inputs
    from tpu_flash_torch.ops.quant import quantize_pallas, quantize_rows_plain

    q, k, v, _ = quant_inputs(dev, "int8", QUANT_SEQ)
    got = quantize_pallas(q)
    torch.cuda.synchronize()
    vals, scales = quantize_rows_plain(q)
    with plain_versions():
        qi = quantize_attention_inputs(q, k, v, "int8")
    same = (torch.equal(got.values, vals) and torch.equal(got.scales, scales)
            and torch.equal(got.values, qi.q_values)
            and torch.equal(got.scales, qi.q_scales[..., :1]))
    err = max(max_err(got.values, vals), max_err(got.scales, scales))
    ms = time_ms(lambda: quantize_pallas(q), 20)
    plain_ms = time_ms(lambda: quantize_rows_plain(q), 5)
    nbytes = q.numel() * (q.element_size() + 1) + 4 * q.numel() // 128
    bound_ms, bound_by = bound(nbytes, 3.0 * q.numel(), "float32")
    row = dict(case="config4_q", shape=list(q.shape), byte_identical=same,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, ok=same)
    log("kernel_vs_plain", kernel="quantize_rows", **row)
    raise_if_failed("quantize_rows", [row])
    return row


WEIGHTS_SEQ = 2048
# K12's late-row control: the plain version with the lse of every row past
# s/2 raised by 2^-6, which scales those rows' P by exp(-2^-6), 1.6% under
# the kernel's; the per-row bar (2^-12 of the row's max) must see it in at
# least WEIGHTS_LATE_CAUGHT of those rows. The cases whose window ends past
# kv_len hold none: their rows that see no key have an lse of MASK_VALUE,
# which 2^-6 does not move, and most late rows are such rows.
WEIGHTS_LATE_SHIFT = 2.0 ** -6
WEIGHTS_LATE_CAUGHT = 0.9
# The ask on every case: at most this many times its bound (logged).
WEIGHTS_BOUND_ASK = 3.0


def check_attn_weights(dev):
    """K12 at b 1, 32 q / 8 kv heads, 2048 tokens, d 128 in bf16, at
    Gemma-2-9B's d 256 (16 / 8 heads, a sliding layer's window and cap, q
    at GEMMA_Q_STD; its control drops both) and at 1024 tokens, d 128 in
    f32, and with a window that ends past kv_len in each of the three
    (rows that see no key, whose P is 1 on every column: hidden tiles
    next to live ones in one block and in one row): P from the forward's
    lse, kernel against plain version with a bar per row (row_agreement:
    each row within 2^-12 of its own max |ref|, the control off some
    row's bar, the late-row control off most late rows' bars), the count
    of elements that differ from the plain version at all; sinks rows sum
    below 1. The bound counts P's bytes and the
    inputs' against the score products at the inputs' arithmetic (three
    TF32 passes in f32)."""
    import torch

    from tpu_flash_torch.ops.flash import debug, flash_attention
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    s = WEIGHTS_SEQ
    q = torch.randn(1, 32, s, 128, generator=g, device=dev).bfloat16()
    k = torch.randn(1, 8, s, 128, generator=g, device=dev).bfloat16()
    v = torch.randn(1, 8, s, 128, generator=g, device=dev).bfloat16()
    sinks = math.log(s) + 1.0 + 0.5 * torch.randn(32, generator=g, device=dev)
    slopes = torch.linspace(0.5, 0.004, 32, device=dev)
    causal = dict(causal=True)
    qkv = (q, k, v, SCALE)
    gemma = (*gemma_qkv(dev, 1, s, s, SEED + 8), GEMMA_SCALE)
    f32 = tuple(torch.randn(1, h, s // 2, 128, generator=g, device=dev)
                for h in (32, 8, 8)) + (SCALE,)
    cases = [
        ("causal", qkv, causal, {}, dict(causal=False)),
        ("window_softcap", qkv, dict(causal=True, window=256, softcap=5.0),
         {}, causal),
        ("alibi", qkv, dict(causal=True, alibi=slopes), {}, causal),
        ("sinks", qkv, causal, dict(sinks=sinks), None),
        ("d256_sliding", gemma,
         dict(causal=True, window=256, softcap=GEMMA_CAP), {}, causal),
        ("f32_causal", f32, causal, {}, dict(causal=False)),
        ("no_key_rows", qkv, dict(causal=True, window=256, kv_len=s // 2),
         {}, dict(causal=True, kv_len=s // 2)),
        ("d256_no_key_rows", gemma,
         dict(causal=True, window=256, kv_len=s // 2, softcap=GEMMA_CAP), {},
         dict(causal=True, kv_len=s // 2, softcap=GEMMA_CAP)),
        ("f32_no_key_rows", f32, dict(causal=True, window=128, kv_len=s // 4),
         {}, dict(causal=True, kv_len=s // 4)),
    ]
    rows = []
    for name, (q, k, v, scale), kw, fwd_only, control in cases:
        _, lse = flash_attention(q, k, v, save_residuals=True, sm_scale=scale,
                                 **kw, **fwd_only)
        no_key = {}
        if "kv_len" in kw:
            # The rows that see no key take the plain forward's lse
            # (MASK_VALUE: P is 1 on every column), whatever the forward
            # kernel gives them, which is logged.
            _, plain_lse = flash_fwd_plain(q, k, v, sm_scale=scale,
                                           save_lse=True, **kw)
            blind = ~attention_mask(1, q.shape[2], k.shape[2], kw)[
                0, 0].any(-1)
            no_key = dict(rows_no_key=int(blind.sum()),
                          fwd_lse_no_key_as_plain=bool(torch.equal(
                              lse[..., blind], plain_lse[..., blind])))
            lse = plain_lse

        def call(fn, opts, q=q, k=k, lse=lse, scale=scale):
            return fn(q, k, lse, sm_scale=scale, **opts)

        out = call(debug.attention_weights_from_lse, kw)
        torch.cuda.synchronize()
        ref = call(debug.weights_plain, kw)
        if control is None:  # without sinks the rows would sum to 1
            _, lse0 = flash_attention(q, k, v, save_residuals=True,
                                      sm_scale=scale, **kw)
            off = debug.weights_plain(q, k, lse0, sm_scale=scale, **kw)
        else:
            off = call(debug.weights_plain, control)
        n = q.shape[2]
        late = None
        if "kv_len" not in kw:
            late_lse = lse.clone()
            late_lse[..., n // 2:] += WEIGHTS_LATE_SHIFT
            late = (call(debug.weights_plain, kw, lse=late_lse), n // 2)
        held = row_agreement(out, ref, off, None, late,
                             late_caught=WEIGHTS_LATE_CAUGHT)
        held.update(differ_plain=differing(out, ref), elements=out.numel())
        row_sums = out.sum(-1)
        del off, late
        ms = time_ms(lambda: call(debug.attention_weights_from_lse, kw), 10)
        plain_ms = time_ms(lambda: call(debug.weights_plain, kw), 2)
        nbytes = (4 * out.numel() + q.element_size() * (q.numel() + k.numel())
                  + 4 * lse.numel())
        ops = 2.0 * q.shape[-1] * q.shape[1] * live_pairs(1, n, n, kw)
        rate = "bfloat16" if q.dtype == torch.bfloat16 else "tf32x3"
        bound_ms, bound_by = bound(nbytes, ops, rate)
        row = dict(case=name, dtype=str(q.dtype).removeprefix("torch."),
                   shape=list(out.shape), d=q.shape[-1],
                   row_sum_max=float(row_sums.max()),
                   row_sum_min=float(row_sums.min()), **no_key, **held,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by,
                   bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   ops_bound_ms=ops / PEAK_OPS_PER_S[rate] * 1e3,
                   of_bound=ms / bound_ms,
                   within_ask=ms <= WEIGHTS_BOUND_ASK * bound_ms,
                   library_ms=None)
        if fwd_only and not row["row_sum_max"] < 1.0:
            row["ok"] = False
        rows.append(row)
        log("kernel_vs_plain", kernel="attn_weights", **row)
        del out, ref
    raise_if_failed("attn_weights", rows)
    wide = next(r for r in rows if r["case"] == "d256_sliding")
    f32 = next(r for r in rows if r["dtype"] == "float32")
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows),
                **{f"d256_{x}": wide[x] for x in (
                    "case", "ms", "plain_ms", "bound_ms", "library_ms")},
                **{f"fp32_{x}": f32[x] for x in (
                    "case", "ms", "plain_ms", "bound_ms", "bytes_bound_ms",
                    "ops_bound_ms")})


# -- phase 3: Gemma-2-9B's attention geometry (head width 256) --------------

# GEMMA2_9B: 16 q / 8 kv heads, d 256, softcap 50, a 4096-token window on
# every other layer (sliding), full attention on the rest (global); its
# query scale 1/sqrt(256). Random q and k give scores of std 1 after the
# scale, a tenth of a real model's: q is drawn at GEMMA_Q_STD so that the
# cap of 50 bends the largest scores as it bends real logits (its control
# drops the cap). A sliding case needs rows past 4096 tokens for the
# window to bite (its control drops the window).
GEMMA_HEADS = (16, 8)
GEMMA_D = 256
GEMMA_CAP = 50.0
GEMMA_WINDOW = 4096
GEMMA_Q_STD = 10.0
GEMMA_SCALE = GEMMA_D ** -0.5


def gemma_qkv(dev, b, sq, skv, seed, dtype="bfloat16"):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv = GEMMA_HEADS
    dt = getattr(torch, dtype)
    q = (GEMMA_Q_STD * torch.randn(b, hq, sq, GEMMA_D, generator=g,
                                   device=dev)).to(dt)
    k, v = (torch.randn(b, hkv, skv, GEMMA_D, generator=g,
                        device=dev).to(dt) for _ in range(2))
    return q, k, v


# (case, b, s, kwargs, control): a sliding layer past the window and a
# global layer, each with the cap; a sliding layer's 512-token first
# chunk at b 4 (the serving engine's prefill; its control drops the cap).
GEMMA_FLASH_CASES = [
    ("gemma2_sliding", 1, 8192,
     dict(causal=True, softcap=GEMMA_CAP, window=GEMMA_WINDOW),
     dict(causal=True, softcap=GEMMA_CAP)),
    ("gemma2_global", 1, 8192, dict(causal=True, softcap=GEMMA_CAP),
     dict(causal=True)),
    ("gemma2_first_chunk", 4, 512,
     dict(causal=True, softcap=GEMMA_CAP, window=GEMMA_WINDOW),
     dict(causal=True, window=GEMMA_WINDOW)),
]


def check_flash_d256(dev):
    """K1 at Gemma-2-9B's geometry (a sliding and a global layer's
    prefill over 8192 tokens, a first chunk of 512) on both entry points,
    with SDPA's time without the cap (it has no softcap) and the f32
    CUDA-core bound beside it."""
    import torch

    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    rows = {name: [] for name in flash_entries()}
    for case, b, sq, kw, control in GEMMA_FLASH_CASES:
        q, k, v = gemma_qkv(dev, b, sq, sq, SEED + 20)
        bound_ms, bound_by = flash_bound(q, k, kw)
        mask = None if kw.get("window", sq) >= sq else attention_mask(
            b, sq, sq, dict(causal=True, window=kw["window"]))
        plain_ms = time_ms(lambda: flash_fwd_plain(
            q, k, v, sm_scale=GEMMA_SCALE, **kw), 2)
        library_ms = sdpa_ms(q, k, v, mask=mask)
        for name, fwd in flash_entries().items():
            out = fwd(q, k, v, sm_scale=GEMMA_SCALE, **kw)
            torch.cuda.synchronize()
            held = flash_rows(q, k, v, out, GEMMA_SCALE, kw, control)
            row = dict(case=case, shape=list(q.shape), kv_len=sq,
                       options={x: str(y) for x, y in kw.items()},
                       control={x: str(y) for x, y in control.items()},
                       **held,
                       ms=time_ms(lambda: fwd(q, k, v, sm_scale=GEMMA_SCALE,
                                              **kw), 5),
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by,
                       fp32_bound_ms=flash_fp32_bound(q, k, kw),
                       library_ms=library_ms,
                       library="SDPA without softcap")
            rows[name].append(row)
            log("kernel_vs_plain", kernel=name, width=GEMMA_D, **row)
            del out
    for name, rs in rows.items():
        raise_if_failed(f"{name} d256", rs)
    return rows


def gemma_decode_inputs(dev, kv_dtype, ring, ps, ctx):
    """Gemma-2-9B decode: b 8, 16 q / 8 kv heads, d 256, ``ctx`` tokens
    a row in ``ps``-token pages of a tier, q at GEMMA_Q_STD."""
    import torch

    from tpu_flash_torch.engine.cache import side_dtypes
    from tpu_flash_torch.ops.quant import quantize_pages

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    (hq, hkv), d, b = GEMMA_HEADS, GEMMA_D, 8
    pps = ctx // ps
    n_pages = b * pps + 1
    kp = torch.randn(hkv, n_pages, ps, d, generator=g, device=dev)
    vp = torch.randn(hkv, n_pages, ps, d, generator=g, device=dev)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    lengths = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    q = (GEMMA_Q_STD * torch.randn(b, hq, d, generator=g,
                                   device=dev)).bfloat16()
    if kv_dtype == "bfloat16":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    else:
        k_t, v_t = side_dtypes(kv_dtype)
        kp, vp = quantize_pages(kp, k_t), quantize_pages(vp, v_t)
    kw = {}
    if ring:
        r = torch.randn(2, b, hkv, ring, d, generator=g, device=dev)
        kw = dict(recent_k=r[0].bfloat16(), recent_v=r[1].bfloat16())
    return q, kp, vp, lengths, table, kw


# (case, tier, page size, ring, kwargs, control kwargs) at 8192 tokens:
# the sliding layer on bf16 and int8 pages (a window takes no ring, as in
# JAX), the global layer on every tier (each capped; with a 128-token
# ring where phase 4 serves one).
GEMMA_DECODE_CASES = [
    ("gemma2_sliding_bf16", "bfloat16", 128, 0,
     dict(softcap=GEMMA_CAP, window=GEMMA_WINDOW), dict(softcap=GEMMA_CAP)),
    ("gemma2_sliding_int8", "int8", 128, 0,
     dict(softcap=GEMMA_CAP, window=GEMMA_WINDOW), dict(softcap=GEMMA_CAP)),
] + [
    (f"gemma2_global_{tier}", tier, 128 if tier in ("bfloat16", "int8")
     else 512, 128 if tier != "bfloat16" else 0, dict(softcap=GEMMA_CAP), {})
    for tier in ("bfloat16", "int8", "int4", "int4g32", "k8v4", "fp8")
]


def check_decode_d256(dev):
    """K4 at Gemma-2-9B's decode geometry on every tier: the kernel's
    output bit for bit its plain version's (bar as phase 3's), the
    control (without the window, or the cap) outside the bar."""
    import torch

    from tpu_flash_torch.ops.decode import paged as dp

    rows = []
    for name, kv_dtype, ps, ring, kw, control in GEMMA_DECODE_CASES:
        q, kp, vp, lengths, table, rkw = gemma_decode_inputs(
            dev, kv_dtype, ring, ps, 8192)

        def run(opts=kw):
            return dp.paged_attention(q, kp, vp, lengths, table,
                                      sm_scale=GEMMA_SCALE, **opts, **rkw)

        out = run()
        torch.cuda.synchronize()
        with plain_versions():
            ref = run()
            plain_ms = time_ms(run, 2)
            off = max_err(out, run(control))
        bound_ms, bound_by = decode_bound(q, lengths, dict(kw, **rkw),
                                          kv_dtype, hkv=GEMMA_HEADS[1])
        row = dict(case=name, tier=decode_tag(kv_dtype, kw), context=8192,
                   page_size=ps, ring=ring,
                   options={x: str(y) for x, y in kw.items()},
                   control={x: str(y) for x, y in control.items()},
                   **agreement(out, ref, off), differing=differing(out, ref),
                   ms=device_ms(run, 20), plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        row["ok"] = row["ok"] and row["differing"] == 0
        rows.append(row)
        log("kernel_vs_plain", kernel="paged_decode", width=GEMMA_D, **row)
    raise_if_failed("paged_decode d256", rows)
    return rows


def check_prefill_d256(dev):
    """K5 and K6 at Gemma-2-9B's geometry: a 512-token chunk of a sliding
    layer over 8192 tokens of history (bf16 pages), of a global layer
    over 2048 (bf16 and int8 pages), and the ragged kernel's mixed-stage
    step under the window and without it; each held per row against its
    plain version (prefill_rows), the control without the window or the
    cap."""
    import torch

    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.flash import ragged
    from tpu_flash_torch.ops.quant import quantize_pages

    rows = {"paged_prefill": [], "ragged_prefill": []}
    hq, hkv = GEMMA_HEADS
    for name, b, hist, offsets, kv, kw, control in [
        ("gemma2_sliding_bf16", 2, 8192, [8192, 6000], "bfloat16",
         dict(softcap=GEMMA_CAP, window=GEMMA_WINDOW),
         dict(softcap=GEMMA_CAP)),
        ("gemma2_global_bf16", 2, 2048, [2048, 1000], "bfloat16",
         dict(softcap=GEMMA_CAP), {}),
        ("gemma2_global_int8", 2, 2048, [2048, 1000], "int8",
         dict(softcap=GEMMA_CAP), {}),
    ]:
        q, ck, cv = gemma_qkv(dev, b, 512, 512, SEED + 22)
        g = torch.Generator(device=dev).manual_seed(SEED + 23)
        ps = 128
        pps = hist // ps
        n_pages = b * pps + 1
        kp, vp = (torch.randn(hkv, n_pages, ps, GEMMA_D, generator=g,
                              device=dev) for _ in range(2))
        kp, vp = ((kp.bfloat16(), vp.bfloat16()) if kv == "bfloat16" else
                  (quantize_pages(kp, kv), quantize_pages(vp, kv)))
        table = torch.randperm(n_pages - 1, generator=g, device=dev)[
            : b * pps].reshape(b, pps).int()
        offs = torch.tensor(offsets, dtype=torch.int32, device=dev)

        def run(opts=kw, vp=vp, cv=cv):
            return pp.paged_prefill_attention(
                q, ck, cv, kp, vp, offs, table, hist_cap=hist,
                sm_scale=GEMMA_SCALE, **opts)

        out = run()
        torch.cuda.synchronize()
        with plain_versions():
            ref = run()
            plain_ms = time_ms(run, 2)
            ctl = run(control)
            late = run(vp=raised(vp), cv=raised(cv))
        bound_ms, bound_by, fp32_ms = prefill_bound(
            q, hkv, offsets, kw.get("window"), hkv * side_bytes(kv, GEMMA_D))
        row = dict(case=name, batch=b, hist_cap=hist, offsets=offsets,
                   pages=kv, options={x: str(y) for x, y in kw.items()},
                   control={x: str(y) for x, y in control.items()},
                   **prefill_rows(out, ref, ctl, late), ms=time_ms(run, 5),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   fp32_bound_ms=fp32_ms, library_ms=None)
        rows["paged_prefill"].append(row)
        log("kernel_vs_plain", kernel="paged_prefill", width=GEMMA_D, **row)
        del out, ref, ctl, late
    offsets = [0, 2000, 4000, 4608]
    hist_cap = 4608
    for name, kw, control in [
        ("gemma2_sliding", dict(softcap=GEMMA_CAP, window=GEMMA_WINDOW),
         dict(softcap=GEMMA_CAP)),
        ("gemma2_global", dict(softcap=GEMMA_CAP), {}),
    ]:
        q, k, v = gemma_qkv(dev, 4, 512, hist_cap + 512, SEED + 24)
        offs = torch.tensor(offsets, dtype=torch.int32, device=dev)

        def run(opts=kw, v=v):
            return ragged.flash_attention_ragged(
                q, k, v, offs, hist_cap=hist_cap, sm_scale=GEMMA_SCALE,
                **opts)

        out = run()
        torch.cuda.synchronize()
        with plain_versions():
            ref = run()
            plain_ms = time_ms(run, 2)
            ctl = run(control)
            late = run(v=raised(v))
        bound_ms, bound_by, fp32_ms = prefill_bound(
            q, hkv, offsets, kw.get("window"),
            hkv * side_bytes("bfloat16", GEMMA_D))
        mask = ragged_mask(offsets, 512, hist_cap, kw.get("window"), dev)
        row = dict(case=name, batch=4, hist_cap=hist_cap, offsets=offsets,
                   options={x: str(y) for x, y in kw.items()},
                   control={x: str(y) for x, y in control.items()},
                   **prefill_rows(out, ref, ctl, late), ms=time_ms(run, 5),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   fp32_bound_ms=fp32_ms,
                   library_ms=sdpa_ms(q, k, v, mask=mask),
                   library="SDPA without softcap")
        rows["ragged_prefill"].append(row)
        log("kernel_vs_plain", kernel="ragged_prefill", width=GEMMA_D, **row)
        del out, ref, ctl, late
    for kernel, rs in rows.items():
        raise_if_failed(f"{kernel} d256", rs)
    return rows


def check_flash_bwd_widths(dev):
    """K8/K9 at Gemma-2-9B's geometry (b 1 x 2048 under the cap, b 1 x
    8192 under the window) and at d 64 (32 heads, b 1 x 2048) in bf16,
    and the first and last again in f32 (three-pass TF32): dq, dk, dv of
    the two kernels against the plain version (with ``round_p`` in bf16),
    each row within its own bar (row_agreement), the control without the
    case's option and the late-row control (every case is causal with sq
    = skv) outside it, the bf16 error against the plain version without
    ``round_p`` logged; SDPA's backward timed without the cap, in the
    case's dtype."""
    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    rows = []
    bf, f32 = torch.bfloat16, torch.float32
    for name, heads, d, s, kw, control, dt in [
        ("gemma2_global", GEMMA_HEADS, GEMMA_D, 2048,
         dict(causal=True, softcap=GEMMA_CAP), dict(causal=True), bf),
        ("gemma2_sliding", GEMMA_HEADS, GEMMA_D, 8192,
         dict(causal=True, softcap=GEMMA_CAP, window=GEMMA_WINDOW),
         dict(causal=True, softcap=GEMMA_CAP), bf),
        ("d64_causal", (32, 8), 64, 2048, dict(causal=True),
         dict(causal=False), bf),
        ("f32_gemma2_global", GEMMA_HEADS, GEMMA_D, 2048,
         dict(causal=True, softcap=GEMMA_CAP), dict(causal=True), f32),
        ("f32_d64_causal", (32, 8), 64, 2048, dict(causal=True),
         dict(causal=False), f32),
    ]:
        g = torch.Generator(device=dev).manual_seed(SEED + 25)
        hq, hkv = heads
        qstd = GEMMA_Q_STD if d == GEMMA_D else 1.0
        q = (qstd * torch.randn(1, hq, s, d, generator=g,
                                device=dev)).to(dt)
        k, v = (torch.randn(1, hkv, s, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        do = torch.randn(1, hq, s, d, generator=g, device=dev).to(dt)
        scale = d ** -0.5
        rp = dt == bf

        def residuals(opts):
            o, lse = flash_fwd_plain(q, k, v, sm_scale=scale, save_lse=True,
                                     **opts)
            return (q, k, v, o, do, lse)

        args = residuals(kw)
        out = bw.flash_bwd(*args, sm_scale=scale, **kw)
        torch.cuda.synchronize()
        ref = bw.flash_bwd_plain(*args, sm_scale=scale, round_p=rp, **kw)
        off = bw.flash_bwd_plain(*residuals(control), sm_scale=scale,
                                 round_p=rp, **control)
        exact = (bw.flash_bwd_plain(*args, sm_scale=scale, **kw) if rp
                 else ref)
        shifted = bw.flash_bwd_plain(*args[:4], late_do(do), args[5],
                                     sm_scale=scale, round_p=rp, **kw)
        grads = {n: dict(row_agreement(a, r, c, n, (sh, s // 2)),
                         differ_plain=differing(a, r),
                         **(dict(vs_f32_p=max_err(a, e)) if rp else {}))
                 for n, a, r, c, e, sh in zip(("dq", "dk", "dv"), out, ref,
                                              off, exact, shifted)}
        del out, ref, off, exact, shifted

        def run():
            return bw.flash_bwd(*args, sm_scale=scale, **kw)

        ms = {"dkv": kernel_ms(build.FLASH_BWD_DKV, run, 3),
              "dq": kernel_ms(build.FLASH_BWD_DQ, run, 3)}
        bounds = {w: bwd_bound(q, k, kw, w, bwd_rate(dt)) for w in ms}
        lib_kw = {x: y for x, y in kw.items() if x != "softcap"}
        whole = dict(ms=time_ms(run, 3), plain_ms=time_ms(
            lambda: bw.flash_bwd_plain(*args, sm_scale=scale, round_p=rp,
                                       **kw), 1),
            library_ms=sdpa_bwd_ms(q, k, v, do, lib_kw),
            library="SDPA backward without softcap")
        if not rp:
            whole.update(f32_extras(q, k, kw, ms, whole))
        row = dict(case=name, dtype=str(dt).removeprefix("torch."),
                   shape=list(q.shape), kv_heads=hkv,
                   options={x: str(y) for x, y in kw.items()},
                   control={x: str(y) for x, y in control.items()},
                   **grads, ok=all(r_["ok"] for r_ in grads.values()),
                   ms=ms, bound_ms={w: b_[0] for w, b_ in bounds.items()},
                   bound_by={w: b_[1] for w, b_ in bounds.items()},
                   whole=whole)
        rows.append(row)
        log("kernel_vs_plain", kernel="flash_bwd", width=d, **row)
    raise_if_failed("flash_bwd d256/d64", rows)
    return rows


def check_widths(dev, summary):
    """Every width case of phase 3; each kernel's summary row gains its
    first d 256 case's numbers (``d256_*``; the backward's d 64 too)."""
    widths = {**check_flash_d256(dev),
              "paged_decode": check_decode_d256(dev),
              **check_prefill_d256(dev)}
    bwd = check_flash_bwd_widths(dev)
    for name, rows in widths.items():
        r = rows[0]
        summary[name].update(
            d256_case=r["case"], d256_ms=r["ms"], d256_plain_ms=r["plain_ms"],
            d256_bound_ms=r["bound_ms"], d256_library_ms=r["library_ms"],
            d256_max_abs_err=max(x["max_abs_err"] for x in rows))
    for which in ("dkv", "dq"):
        for prefix, r in (("d256", bwd[0]), ("d64", bwd[2]),
                          ("fp32_d256", bwd[3]), ("fp32_d64", bwd[4])):
            summary[f"flash_bwd_{which}"].update({
                f"{prefix}_case": r["case"], f"{prefix}_ms": r["ms"][which],
                f"{prefix}_bound_ms": r["bound_ms"][which],
                f"{prefix}_whole_ms": r["whole"]["ms"],
                f"{prefix}_whole_plain_ms": r["whole"]["plain_ms"],
                f"{prefix}_whole_library_ms": r["whole"]["library_ms"]})


# -- phase 3: the variant harness's kernel (K13) -----------------------------

VARIANT_SHAPE = (1, 32, 2048, 128)  # the sweep's b, h, s, d
# K13 is held with a bar per row (row_bars), as K10 is: a causal row
# past ~1000 tokens has |out| near sqrt(e / n) ~ 0.05, under the one bar
# from the whole output's max (row 0, one token: 0.03 at max |ref| ~4).
# The late-row control is the plain version on v raised by
# VARIANT_LATE_SHIFT, which moves every output by 3% of its own value;
# the row bars (2 bf16 ulps of the row's max, 0.8-1.6% of it) must catch
# it in at least VARIANT_LATE_CAUGHT of the rows past s/2.
VARIANT_LATE_SHIFT = 1.03
VARIANT_LATE_CAUGHT = 0.9


def check_variant(dev):
    """K13 at the sweep's shape, every built variant (tile shape x mask
    mode x exp2) against its plain version with a bar per row; the
    control, causal attention with the diagonal one column off, must miss
    some row's bar, and the late-row control most late rows' bars. SDPA's
    causal time is the yardstick."""
    import torch

    from tpu_flash_torch.bench.experiments import variants
    from tpu_flash_torch.core.reference import reference_gqa_attention
    from tpu_flash_torch.ops.flash.variant import (variant_attention,
                                                   variant_attention_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    q, k, v = (torch.randn(*VARIANT_SHAPE, generator=g, device=dev)
               .bfloat16() for _ in range(3))
    v_late = v * VARIANT_LATE_SHIFT
    sm = VARIANT_SHAPE[3] ** -0.5
    control = reference_gqa_attention(q, k, v, causal=True, q_offset=1)
    b, h, s, d = VARIANT_SHAPE
    late_rows = slice(s // 2, None)
    bound_ms, bound_by = bound(2 * 4 * q.numel(),
                               4.0 * h * d * live_pairs(b, s, s,
                                                        dict(causal=True)),
                               "bfloat16")
    library_ms = sdpa_ms(q, k, v)
    rows = []
    for (bq, bkvm, bkv), mode, exp2 in variants():
        kw = dict(sm_scale=sm, block_q=bq, block_kv_major=bkvm,
                  block_kv=bkv, mask_mode=mode, use_exp2=exp2)
        out = variant_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = variant_attention_plain(q, k, v, **kw)
        bars = row_bars(ref)
        err_rows = (out.float() - ref.float()).abs().amax(-1)
        missed = int((err_rows > bars).sum())
        ctl_missed = int(row_misses(out, control, bars).sum())
        late_off = (out.float() - variant_attention_plain(
            q, k, v_late, **kw).float()).abs().amax(-1)[..., late_rows]
        late_caught = float((late_off > bars[..., late_rows]).float().mean())
        ok = (missed == 0 and ctl_missed > 0
              and late_caught >= VARIANT_LATE_CAUGHT)
        row = dict(case=f"{bq}/{bkvm}/{bkv} {mode}{' exp2' if exp2 else ''}",
                   shape=list(VARIANT_SHAPE),
                   max_abs_err=float(err_rows.max()),
                   max_abs_ref=float(ref.float().abs().max()),
                   max_err_over_row_bar=float(
                       (err_rows / bars.clamp_min(1e-30)).max()),
                   median_abs_ref=float(ref.float().abs().median()),
                   median_row_bar=float(bars.median()),
                   rows_missed=missed, control_rows_missed=ctl_missed,
                   late_caught=late_caught,
                   late_caught_by_case_bar=float(
                       (late_off > case_bar(ref)).float().mean()),
                   late_median_abs_ref=float(
                       ref[..., late_rows, :].float().abs().median()),
                   late_median_bar=float(bars[..., late_rows].median()),
                   ok=ok,
                   ms=time_ms(lambda: variant_attention(q, k, v, **kw), 10),
                   plain_ms=time_ms(lambda: variant_attention_plain(
                       q, k, v, **kw), 2),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        rows.append(row)
        log("kernel_vs_plain", kernel="variant_fwd", **row)
    raise_if_failed("variant_fwd", rows)
    turns = exp_in_turns(q, k, v, sm)
    fastest = min(rows, key=lambda r: r["ms"])
    turn = next(t for t in turns
                if t["case"] == fastest["case"].removesuffix(" exp2"))
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows),
                fastest_case=fastest["case"], fastest_ms=fastest["ms"],
                fastest_exp2_over_expf=turn["exp2_over_expf"])


EXP_ROUNDS = 4


def exp_in_turns(q, k, v, sm):
    """Each tile shape and mask mode of K13 with expf and with exp2, timed
    in turns (expf, exp2, exp2, expf; EXP_ROUNDS rounds), so that neither
    gains from its place in the order: each one's median and the median
    of exp2's time over expf's, round by round."""
    from tpu_flash_torch.ops.flash.variant import (KERNEL_TILES, MASK_MODES,
                                                   variant_attention)

    rows = []
    for (bq, bkvm, bkv) in KERNEL_TILES:
        for mode in MASK_MODES:
            def run(exp2, bq=bq, bkvm=bkvm, bkv=bkv, mode=mode):
                return variant_attention(
                    q, k, v, sm_scale=sm, block_q=bq, block_kv_major=bkvm,
                    block_kv=bkv, mask_mode=mode, use_exp2=exp2)

            ms = {False: [], True: []}
            for _ in range(EXP_ROUNDS):
                for exp2 in (False, True, True, False):
                    ms[exp2].append(time_ms(lambda: run(exp2), 10))
            ratios = [(a + b) / (c + d) for a, b, c, d in zip(
                ms[True][::2], ms[True][1::2], ms[False][::2],
                ms[False][1::2])]
            rows.append(dict(case=f"{bq}/{bkvm}/{bkv} {mode}",
                             expf_ms=statistics.median(ms[False]),
                             exp2_ms=statistics.median(ms[True]),
                             exp2_over_expf=statistics.median(ratios),
                             expf_all=ms[False], exp2_all=ms[True]))
            log("variant_exp_in_turns", **rows[-1])
    return rows


def kernel_entries():
    """Each kernel's CUDA entry that the port's wrappers call, by kernel
    name: (module, attribute, plain version of the same signature)."""
    from tpu_flash_torch.ops.decode import paged
    from tpu_flash_torch.ops.flash import (api, backward, debug, forward,
                                           paged_prefill, quantized, ragged)
    quantize = importlib.import_module("tpu_flash_torch.ops.quant.quantize")

    return {
        "flash_fwd": (api, "flash_fwd", forward.flash_fwd_plain),
        "flash_fwd_exact": (api, "flash_fwd_exact", forward.flash_fwd_plain),
        "flash_bwd": (api, "flash_bwd", backward.flash_bwd_plain),
        "paged_decode": (paged, "_paged_decode_cuda",
                         paged.paged_decode_plain),
        "paged_prefill": (paged_prefill, "_paged_prefill_cuda",
                          paged_prefill.paged_prefill_plain),
        "ragged_prefill": (ragged, "_ragged_prefill_cuda",
                           ragged.ragged_prefill_plain),
        "quant_fwd": (quantized, "_quant_fwd_cuda",
                      quantized.quant_fwd_plain),
        "quantize_rows": (quantize, "_quantize_rows_cuda",
                          quantize.quantize_rows_plain),
        "attn_weights": (debug, "_attn_weights_cuda", debug.weights_plain),
    }


@contextlib.contextmanager
def swapped_entries(make):
    """Replace each kernel entry by ``make(name, kernel, plain)`` while
    the block runs."""
    entries = kernel_entries()
    saved = {n: getattr(m, a) for n, (m, a, _) in entries.items()}
    try:
        for n, (m, a, plain) in entries.items():
            setattr(m, a, make(n, saved[n], plain))
        yield
    finally:
        for n, (m, a, _) in entries.items():
            setattr(m, a, saved[n])


def plain_versions(names=None):
    """Route CUDA tensors through the plain PyTorch versions instead of
    the kernels (those in ``names``, or all), for the reference runs on
    the card (the wrappers themselves never do this)."""
    return swapped_entries(
        lambda n, kernel, plain: plain if names is None or n in names
        else kernel)


def shadowed(stats):
    """Each kernel call also runs its plain version on the same inputs;
    ``stats[kernel]`` counts the calls, those whose outputs differ at
    all, the largest |kernel - plain| and the largest ratio of an
    output's error to its case_bar."""
    def make(name, kernel, plain):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ref = plain(*args, **kwargs)
            pairs = [(o, r) for o, r in zip(
                out if isinstance(out, tuple) else (out,),
                ref if isinstance(ref, tuple) else (ref,)) if o is not None]
            st = stats.setdefault(name, dict(calls=0, differing=0,
                                             max_abs_err=0.0, max_of_bar=0.0))
            errs = [max_err(o, r) for o, r in pairs]
            st["calls"] += 1
            st["differing"] += any(e != 0.0 for e in errs)
            st["max_abs_err"] = max([st["max_abs_err"], *errs])
            st["max_of_bar"] = max([st["max_of_bar"], *(
                e and e / case_bar(r) for e, (_, r) in zip(errs, pairs))])
            return out
        return call
    return swapped_entries(make)


@contextlib.contextmanager
def scratch_peak():
    """Yields a dict whose ``bytes`` becomes the largest score scratch
    (prefill_tile.cuh: one slot for each thread block the card runs at
    once) that a K5, K6 or order-exact forward call allocates while the
    block runs (the forward sizes its scratch through paged_prefill's
    tile_scratch)."""
    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.flash import ragged

    seen = dict(bytes=0)
    real = pp.tile_scratch

    def spy(*args, **kwargs):
        scratch, slots = real(*args, **kwargs)
        if scratch is not None:
            seen["bytes"] = max(seen["bytes"],
                                scratch.numel() * scratch.element_size())
        return scratch, slots

    pp.tile_scratch = ragged.tile_scratch = spy
    try:
        yield seen
    finally:
        pp.tile_scratch = ragged.tile_scratch = real


# -- phase 4: the main path at full width -------------------------------------

MAIN_TIERS = (("int8", 128), ("bfloat16", 0))  # (kv_dtype, recent_window)
# Served with no layout fields: the engine resolves the auto layout
# (512-token pages, a 128-token ring at max_seq_len 2048).
AUTO_TIERS = ("int4", "fp8", "int4g32", "k8v4")


def main_path_model(dev):
    """The LLAMA3_8B model and its seeded random bf16 weights on ``dev``."""
    import torch

    from tpu_flash_torch.models import LLAMA3_8B, FlashTransformer

    model = FlashTransformer(LLAMA3_8B, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(SEED))


def main_path_prompts(vocab_size):
    """8 seeded prompts of 100 .. 1500 tokens."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    return [torch.randint(0, vocab_size, (100 + 200 * i,), generator=g)
            .tolist() for i in range(8)]


def main_path_config(kv_dtype, ring, num_pages=161, **config):
    """The main path's EngineConfig (``config`` overrides its fields).
    ``ring`` None leaves the cache layout to the engine's auto policy;
    otherwise ``num_pages`` pages of 128 tokens and that ring."""
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig

    layout = {} if ring is None else dict(
        page_size=128, num_pages=num_pages, max_pages_per_seq=16,
        recent_window=ring)
    return EngineConfig(
        max_batch_size=8, max_seq_len=2048, prefill_chunk=512,
        cache=CacheConfig(kv_dtype=kv_dtype, **layout), **config,
    )


def main_path_engine(model, params, kv_dtype, ring, prompts, num_pages=161,
                     mesh=None, **config):
    """The main path's engine at its default routing, warmed up by one
    short request so that CUDA/cuBLAS initialisation and allocator growth
    stay out of timed runs; ``mesh`` makes it tensor-parallel."""
    from tpu_flash_torch.engine import InferenceEngine

    eng = InferenceEngine(
        model, params, main_path_config(kv_dtype, ring, num_pages, **config),
        mesh=mesh)
    eng.submit(prompts[0][:64], 2)
    eng.run()
    return eng


PREFILL_ROUTES = ("prefill_group", "prefill_ragged", "fused")
DECODE_ROUTES = ("decode", "speculative")


def serve_main(model, params, kv_dtype, ring, prompts, new_tokens, *,
               check_logits=True, num_pages=161, loras=None, prepare=None,
               inspect=None, first=None, **config):
    """Serve ``prompts`` on the port's engine; returns the phase record.

    ``loras``: each prompt's adapter name (or None); ``prepare(engine)``
    runs before the requests are submitted (registering adapters, setting
    spies), ``inspect(engine)`` after the run, its dict joining the
    record; ``first``, a dict, receives the first prefill dispatch's
    tokens, valid lengths and last logits.

    prefill_tok_per_s: prompt tokens over the time spent in prefill
    dispatches (same-stage groups and ragged steps, fused decode rows
    included); decode_tok_per_s: tokens from decode calls (bursts and
    speculative steps) over the time spent in them. The engine's metrics
    time each dispatch between device synchronisations and count them by
    route; the first token of each request comes from its prefill."""
    import torch

    from tpu_flash_torch.engine.metrics import EngineMetrics
    from tpu_flash_torch.ops import build

    eng = main_path_engine(model, params, kv_dtype, ring, prompts,
                           num_pages=num_pages, **config)
    first = {} if first is None else first
    impl = eng._chunked_prefill_impl

    def capture(hist_len, tokens, table_rows, n_valids, slots, *rest):
        last, finite = impl(hist_len, tokens, table_rows, n_valids, slots,
                            *rest)
        if not first:
            first.update(tokens=tokens.clone(), n_valids=n_valids.clone(),
                         last=last.clone())
        return last, finite

    eng._chunked_prefill_impl = capture
    if prepare is not None:
        prepare(eng)
    eng.metrics = m = EngineMetrics(sync_dispatches=True)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    ids = [eng.submit(p, new_tokens, lora=lora)
           for p, lora in zip(prompts, loras or [None] * len(prompts))]
    t0 = time.perf_counter()
    with scratch_peak() as scratch:
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._chunked_prefill_impl  # the hook's cycle through the engine
    launches = build.launch_counts()
    out = [eng.outputs[i] for i in ids]
    if any(len(o) != new_tokens for o in out):
        raise AssertionError(f"token counts {[len(o) for o in out]}")
    prefill_s = sum(m.route_seconds.get(r, 0.0) for r in PREFILL_ROUTES)
    decode_s = sum(m.route_seconds.get(r, 0.0) for r in DECODE_ROUTES)
    decode_tok = sum(m.route_tokens.get(r, 0) for r in DECODE_ROUTES)
    cache = eng.config.cache
    rec = dict(
        kv_dtype=kv_dtype, recent_window=cache.recent_window,
        layout="auto" if ring is None else "explicit",
        cache=dict(page_size=cache.page_size, num_pages=cache.num_pages,
                   max_pages_per_seq=cache.max_pages_per_seq,
                   recent_window=cache.recent_window),
        config={k: str(v) for k, v in config.items()},
        requests=len(prompts), prompt_tokens=m.prefill_tokens,
        new_tokens_each=new_tokens, wall_s=wall, prefill_s=prefill_s,
        prefill_tok_per_s=m.prefill_tokens / prefill_s,
        decode_tokens=decode_tok, decode_s=decode_s,
        decode_tok_per_s=decode_tok / decode_s if decode_s else None,
        routes=m.route_counts(), speculation=eng.speculation_stats(),
        launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        prefill_scratch_mib=scratch["bytes"] / 2**20,
        allocator=type(eng.scheduler.allocator).__name__,
    )
    if rec["allocator"] != "NativeAllocator":
        raise AssertionError(f"the engine ran on {rec['allocator']}, not "
                             f"the native allocator")
    if inspect is not None:
        rec.update(inspect(eng))
    eng.close()
    if not check_logits:
        return rec, out
    # First step's last-position logits against the model's forward on
    # the plain versions on the card (same weights, same tokens, each
    # layer's own window, cap and query scale).
    with torch.no_grad(), plain_versions():
        ref = model.forward(params, first["tokens"])
    rows = torch.arange(ref.shape[0], device=ref.device)
    ref_last = ref[rows, first["n_valids"] - 1]
    err = float((first["last"] - ref_last).abs().max())
    scale = float(ref_last.abs().max())
    rec.update(
        finite=bool(torch.isfinite(first["last"]).all()),
        first_logits_max_abs_err=err, first_logits_max_abs=scale,
        first_logits_rel_err=err / scale,
        first_argmax_equal=float(
            (first["last"].argmax(-1) == ref_last.argmax(-1)).float().mean()
        ),
    )
    return rec, out


# Kernel and plain forwards differ only in summation order inside
# attention; in bf16 each layer re-rounds, so through 32 layers the
# first logits may drift by a few bf16 ulps of their largest magnitude:
# 5% of max |logit| is that bar (bf16 relative ulp 0.8%).
LOGITS_REL_TOL = 0.05


def require_launches(rec, kernels):
    missing = [k for k in kernels if not rec["launches"].get(k)]
    if missing:
        raise AssertionError(f"{missing} never launched: {rec}")


def speculation_prompts(model, params, vocab_size):
    """8 seeded prompts of 1024 tokens whose positions 100-101 hold each
    prompt's last token and its first greedy token t1 (from a run with
    speculation off), so prompt lookup proposes prompt[102:110] after
    t1: 8 drafts for every row that keeps its t1."""
    import torch

    g = torch.Generator().manual_seed(SEED + 3)
    prompts = [torch.randint(0, vocab_size, (1024,), generator=g).tolist()
               for _ in range(8)]
    eng = main_path_engine(model, params, "bfloat16", 0, prompts)
    eng.speculation_k = 0
    ids = [eng.submit(p, 1) for p in prompts]
    eng.run()
    for p, i in zip(prompts, ids):
        p[100:102] = [p[-1], eng.outputs[i][0]]
    eng.close()
    return prompts


def check_main_path(dev):
    """Phase 4: the default routing on the int8 and bf16 tiers, both
    again with paged_prefill=False (gathered history, the ragged kernel),
    the int4, fp8, int4g32 and k8v4 tiers at the auto layout, a traced
    decode window, and a speculative run. Returns the records and what
    phase "parallel" shares: the model, its weights, the prompts and the
    int8 + ring run's tokens."""
    import torch

    from tpu_flash_torch.models import LLAMA3_8B

    t0 = time.perf_counter()
    model, params = main_path_model(dev)
    torch.cuda.synchronize()
    n_params = sum(
        w.numel() for k, v in params.items()
        for w in ([x for layer in v for x in layer.values()]
                  if k == "layers" else [v])
    )
    log("main_path_weights", model=LLAMA3_8B.name, layers=LLAMA3_8B.num_layers,
        params=n_params, gbytes=n_params * 2 / 1e9,
        init_s=time.perf_counter() - t0)
    prompts = main_path_prompts(LLAMA3_8B.vocab_size)
    recs = []
    with torch.no_grad():
        runs = [(kv, ring, {}) for kv, ring in MAIN_TIERS]
        runs += [(kv, ring, dict(paged_prefill=False))
                 for kv, ring in MAIN_TIERS]
        runs += [(kv, None, {}) for kv in AUTO_TIERS]
        reserve_first = {}
        for kv_dtype, ring, config in runs:
            first = reserve_first if not recs else None
            rec, out = serve_main(model, params, kv_dtype, ring, prompts, 32,
                                  first=first, **config)
            if first is not None:
                reserve = (rec, out)
            log("main_path", gpu=gpu_query(), **rec)
            if not rec["finite"]:
                raise AssertionError("non-finite logits")
            if not rec["first_logits_rel_err"] <= LOGITS_REL_TOL:
                raise AssertionError(
                    f"first-step logits off the plain forward: {rec}"
                )
            if rec["routes"]["fused"] < 1:
                raise AssertionError(f"no fused step: {rec}")
            # int4g32 and k8v4 always gather their history, as in JAX.
            gathered = (config.get("paged_prefill") is False
                        or kv_dtype in ("int4g32", "k8v4"))
            require_launches(rec, ["flash_fwd_exact", "paged_decode"] + (
                ["ragged_prefill"] if gathered else ["paged_prefill"]))
            if kv_dtype in AUTO_TIERS:
                require_launches(rec, [
                    f"paged_decode:{decode_tag(kv_dtype, {})}"] + (
                    [] if gathered else [f"paged_prefill:{kv_dtype}"]))
            if gathered and rec["launches"]["paged_prefill"]:
                raise AssertionError(f"paged history with paging off: {rec}")
            recs.append(rec)
        recs.append(trace_decode_window(model, params, prompts))
        recs.append(check_server(model, params, prompts))
        pre = check_preemption(model, params, prompts, reserve)
        recs += list(pre.values())
        recs.append(check_snapshot_path(model, params, prompts,
                                        pre["swap"]["_out"]))
        recs.append(check_lora_path(model, params, prompts, reserve_first))
        for r in recs:
            r.pop("_out", None)
        spec_prompts = speculation_prompts(model, params,
                                           LLAMA3_8B.vocab_size)
        rec, _ = serve_main(model, params, "bfloat16", 0, spec_prompts, 16,
                            check_logits=False)
        log("main_path_speculation", gpu=gpu_query(), **rec)
        if rec["routes"]["speculative"] < 1:
            raise AssertionError(f"no speculative step: {rec}")
        require_launches(rec, ["paged_prefill"])
        recs.append(rec)
    return recs, dict(model=model, params=params, prompts=prompts,
                      reserve_out=reserve[1])


# Optimistic admission at full width: the main path's 8 prompts (100-1500
# tokens, 32 new each) on int8 + the 128-token ring, on PREEMPT_PAGES
# pages of 128 tokens (one of them the trash page). At full context the 8
# requests need 56 pages, but only 2 more than their prompts' 54: on 40
# pages admission would just wait. On 31 usable pages the 6 requests
# admitted first fill the pool, so the first to grow past its prompt's
# pages preempts the newest.
PREEMPT_PAGES = 32


def check_preemption(model, params, prompts, reserve):
    """Phase 4, ``main_path_preemption``: optimistic admission under
    recompute and under swap preemption. Each run must preempt, deliver
    every budget (serve_main), end with every page free (once the prefix
    index lets its pages go) and no stash, and launch K4 and K5; under
    swap the pages (and ring row) of the first request restored must hold,
    byte for byte, what its own pages held when it was swapped out (a
    device copy taken in the scheduler's swap-out hook before the engine
    gathers its stash). Printed beside the reserve run's: prefill and
    decode tok/s, the wall, and the share of tokens that match it (a
    figure: the two runs' prefill chunks have other shapes, and cuBLAS
    picks its algorithm by rows)."""
    import torch

    reserve_rec, reserve_out = reserve
    out = {}
    for mode in ("recompute", "swap"):
        restores, before = [], {}

        def prepare(eng):
            c = eng.cache
            tiers = [t for t in (c.k_pages, c.v_pages, c.k_scales,
                                 c.v_scales) if t is not None]
            real_out, real_restore = (eng.scheduler.swap_out_hook,
                                      eng._swap_restore)

            def out_spy(req, pages):
                # The victim's pages as they stand, before the engine
                # gathers them and the scheduler frees them.
                if (not restores and pages and req.req_id not in before
                        and req.req_id not in eng._swapped):
                    idx = torch.tensor(pages, device=c.k_pages.device)
                    rings = ([r[:, req.batch_slot].clone()
                              for r in (c.k_recent, c.v_recent)]
                             if c.k_recent is not None
                             and req.batch_slot >= 0 else [])
                    before[req.req_id] = (
                        len(pages), [t[:, :, idx].clone() for t in tiers],
                        rings)
                real_out(req, pages)

            def restore_spy(req):
                real_restore(req)
                if restores or req.req_id not in before:
                    return
                n, arrays, rings = before.pop(req.req_id)
                idx = torch.tensor(
                    eng.scheduler.page_table(req.req_id)[:n],
                    device=c.k_pages.device)
                same = [torch.equal(t[:, :, idx], a)
                        for t, a in zip(tiers, arrays, strict=True)]
                same += [torch.equal(r[:, req.batch_slot], a) for r, a in
                         zip((c.k_recent, c.v_recent), rings)]
                restores.append(dict(req=req.req_id, pages=n,
                                     bytes=sum(a.numel() * a.element_size()
                                               for a in arrays),
                                     ring_rows=len(rings),
                                     byte_for_byte=all(same)))
                before.clear()

            eng.scheduler.swap_out_hook = out_spy
            eng._swap_restore = restore_spy

        def inspect(eng):
            if eng.prefix_index is not None:
                eng.prefix_index.drop_all()
            return dict(
                preemptions=eng.scheduler.num_preemptions,
                pages_free_at_end=eng.scheduler.allocator.num_free,
                usable_pages=eng.config.cache.num_pages - 1,
                stashes_left=len(eng._swapped))

        t0 = time.perf_counter()
        rec, toks = serve_main(model, params, "int8", 128, prompts, 32,
                               check_logits=False, num_pages=PREEMPT_PAGES,
                               admission="optimistic", preemption=mode,
                               prepare=prepare, inspect=inspect)
        rec.update(
            preemption=mode, first_restore=restores[:1],
            swap_restores_checked=len(restores),
            match_vs_reserve=token_match(toks, reserve_out),
            reserve=dict(wall_s=reserve_rec["wall_s"],
                         prefill_tok_per_s=reserve_rec["prefill_tok_per_s"],
                         decode_tok_per_s=reserve_rec["decode_tok_per_s"]),
            call_s=time.perf_counter() - t0)
        log("main_path_preemption", gpu=gpu_query(), **rec)
        if not (rec["preemptions"] > 0
                and rec["pages_free_at_end"] == rec["usable_pages"]
                and rec["stashes_left"] == 0):
            raise AssertionError(f"{mode} preemption: {rec}")
        if mode == "swap" and not (restores
                                   and restores[0]["byte_for_byte"]
                                   and restores[0]["ring_rows"] == 2):
            raise AssertionError(f"swap restore off the pages swapped out: "
                                 f"{rec}")
        require_launches(rec, ["paged_decode", "paged_prefill"])
        out[mode] = dict(rec, _out=toks)
    return out


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


@contextlib.contextmanager
def build_tempdir(prefix):
    """A new directory under the checkout's build/ (for the snapshots and
    checkpoints the smoke writes), removed when the block ends."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=prefix, dir=os.path.join(REPO, "build"))
    try:
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_snapshot_path(model, params, prompts, want):
    """Phase 4, ``main_path_snapshot``: the swap-mode engine of
    check_preemption served again, snapshotted mid-decode (at the first
    step after which a victim is swapped out and some request has 8
    tokens, else once some request has 16), restored into a fresh engine
    and run to the end: its tokens must be the uninterrupted swap run's
    (``want``), token for token. The snapshot goes under build/ and is
    removed afterwards; its bytes and the seconds to write and to read it
    are printed."""
    import torch

    from tpu_flash_torch.checkpoint import restore_engine, snapshot_engine
    from tpu_flash_torch.ops import build

    kw = dict(num_pages=PREEMPT_PAGES, admission="optimistic",
              preemption="swap")
    eng = main_path_engine(model, params, "int8", 128, prompts, **kw)
    build.reset_launch_counts()
    ids = [eng.submit(p, 32) for p in prompts]
    steps = 0
    while eng.scheduler.has_work():
        eng.step()
        steps += 1
        most = max(len(eng.outputs[i]) for i in ids)
        if (eng._swapped and most >= 8) or most >= 16:
            break
    swapped = sorted(eng._swapped)
    done = sum(len(eng.outputs[i]) for i in ids)
    with build_tempdir("snapshot-") as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snapshot_engine(tmp, eng)
        write_s = time.perf_counter() - t0
        size = dir_bytes(tmp)
        eng.close()
        del eng
        counts = build.launch_counts()
        fresh = main_path_engine(model, params, "int8", 128, prompts, **kw)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        restore_engine(tmp, fresh)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        fresh.run()
        got = [fresh.outputs[i] for i in ids]
        fresh.close()
        after = build.launch_counts()
        counts = {k: counts.get(k, 0) + after.get(k, 0)
                  for k in set(counts) | set(after)}
    rec = dict(launches=counts, steps_before=steps,
               swapped_at_snapshot=swapped,
               tokens_at_snapshot=done, snapshot_bytes=size,
               write_s=write_s, read_s=read_s,
               match=token_match(got, want), removed=not os.path.exists(tmp))
    log("main_path_snapshot", gpu=gpu_query(), **rec)
    if got != want:
        raise AssertionError(f"snapshot continuation off the uninterrupted "
                             f"run: {rec}")
    require_launches(rec, ["paged_decode"])
    return rec


# Two seeded rank-16 adapters over all seven projections of all 32
# layers. A delta's std is about sqrt(16) * LORA_SCALE of a projection's
# (unit-variance activations, A ~ N(0, LORA_SCALE^2 / fan_in), B ~ N(0,
# 1)): a tenth of it, enough to move the logits past phase 4's bar.
LORA_RANK, LORA_SCALE = 16, 0.025
LORA_NAMES = ("a", "b")


def main_path_adapter(cfg, seed):
    """{layer: {proj: (A, B)}} numpy f32, seeded (on the host)."""
    import numpy as np

    from tpu_flash_torch.engine.lora import seeded_adapter

    return seeded_adapter(cfg, LORA_RANK, LORA_SCALE,
                          np.random.default_rng(seed))


def merged_params(params, adapters):
    """The base params with each adapter delta A B folded into its bf16
    weight (W + A B in f32, rounded once)."""
    import torch

    layers = []
    for li, layer in enumerate(params["layers"]):
        new = dict(layer)
        for p, (a, b) in adapters.get(li, {}).items():
            w = layer[p]
            new[p] = (w.float() + torch.from_numpy(a).to(w.device)
                      @ torch.from_numpy(b).to(w.device)).to(w.dtype)
        layers.append(new)
    return dict(params, layers=layers)


def check_lora_path(model, params, prompts, reserve_first):
    """Phase 4, ``main_path_lora``: two seeded rank-16 adapters over every
    projection of every layer; the 8 prompts served mixed (base, a, b in
    turn) on int8 + ring. The base rows' first logits must be bit for bit
    those of the run with no adapter (``reserve_first``, the same first
    dispatch); each adapted row's within phase 4's bar (LOGITS_REL_TOL of
    max |logit|) of the plain forward on the merged weights W + A B; the
    control, the base run's logits of those rows, must miss it. tok/s
    printed."""
    import torch

    cfg = model.config
    adapters = {n: main_path_adapter(cfg, SEED + 40 + i)
                for i, n in enumerate(LORA_NAMES)}
    loras = [(None, *LORA_NAMES)[i % 3] for i in range(len(prompts))]

    def prepare(eng):
        for n, ad in adapters.items():
            eng.register_lora(n, ad)

    first = {}
    rec, _ = serve_main(model, params, "int8", 128, prompts, 32,
                        check_logits=False, loras=loras, prepare=prepare,
                        first=first)
    base_rows = [i for i, n in enumerate(loras) if n is None]
    rec.update(loras=loras, rank=LORA_RANK, scale=LORA_SCALE,
               base_rows_bit_for_bit=bool(torch.equal(
                   first["last"][base_rows],
                   reserve_first["last"][base_rows])))
    rows = torch.arange(first["tokens"].shape[0], device=first["last"].device)
    for n in LORA_NAMES:
        sel = [i for i, x in enumerate(loras) if x == n]
        merged = merged_params(params, adapters[n])
        with torch.no_grad(), plain_versions():
            ref = model.forward(merged, first["tokens"][sel])
        del merged
        ref_last = ref[rows[:len(sel)], first["n_valids"][sel] - 1]
        scale = float(ref_last.abs().max())
        err = float((first["last"][sel] - ref_last).abs().max())
        ctl = float((reserve_first["last"][sel] - ref_last).abs().max())
        rec[f"adapter_{n}"] = dict(rows=sel, rel_err=err / scale,
                                   control_rel_err=ctl / scale,
                                   argmax_equal=float((
                                       first["last"][sel].argmax(-1)
                                       == ref_last.argmax(-1)).float()
                                       .mean()))
    log("main_path_lora", gpu=gpu_query(), **rec)
    if not rec["base_rows_bit_for_bit"] or any(
            not (rec[f"adapter_{n}"]["rel_err"] <= LOGITS_REL_TOL
                 < rec[f"adapter_{n}"]["control_rel_err"])
            for n in LORA_NAMES):
        raise AssertionError(f"adapted serving off: {rec}")
    require_launches(rec, ["paged_decode", "paged_prefill",
                           "flash_fwd_exact"])
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# The HTTP server (tpu_flash_torch.serve) in front of the main path's
# engine (int8 + ring): one greedy request alone, then SERVER_MIX's
# requests at once from client threads, a bad request and /health.
SERVER_NEW = 16  # new tokens a completion
SERVER_FORCE = 1234  # the token a +100 bias forces


def http_call(addr, method, path, body=None):
    """(status, body bytes, seconds) of one HTTP call to the server."""
    import http.client

    t = time.perf_counter()
    conn = http.client.HTTPConnection(*addr, timeout=600)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data, time.perf_counter() - t


def sse_events(data: bytes):
    """The JSON events of a streamed response, and whether it ended with
    the [DONE] sentinel."""
    events = [json.loads(line[len(b"data: "):])
              for line in data.split(b"\n\n")
              if line.startswith(b"data: ") and b"[DONE]" not in line]
    return events, data.rstrip().endswith(b"data: [DONE]")


def server_mix(prompts, banned):
    """(name, request body) of the concurrent requests: greedy, greedy
    streamed, n=2 greedy, n=3 sampled at temperature 0.8 (the engine's
    seeded generator), one +100 bias forcing SERVER_FORCE, and one -100
    bias banning the tokens ``banned`` (an unbiased run's)."""
    new = dict(max_tokens=SERVER_NEW)
    return [
        ("greedy", dict(prompt=prompts[0], **new)),
        ("stream", dict(prompt=prompts[1], stream=True, **new)),
        ("n2_greedy", dict(prompt=prompts[3], n=2, **new)),
        ("n3_sampled", dict(prompt=prompts[4], n=3, temperature=0.8,
                            **new)),
        ("force", dict(prompt=prompts[5],
                       logit_bias={str(SERVER_FORCE): 100.0}, **new)),
        ("ban", dict(prompt=prompts[2],
                     logit_bias={str(t): -100.0 for t in banned}, **new)),
    ]


def check_server(model, params, prompts):
    """Phase 4, the HTTP server at full width: the main path's engine
    (int8 + ring, default routing) behind ``serve(engine, port=0,
    block=False)``. One greedy request sent alone must give the tokens of
    the same request through ``engine.submit`` alone; then SERVER_MIX
    goes out at once from client threads beside a bad request (400) and
    /health (200). Every completion answers 200 with SERVER_NEW tokens a
    choice, the streamed chunks join up to the final response, greedy
    branches are equal, the forced token fills every position, no banned
    token appears, and paged_decode and paged_prefill launch. Logs
    requests/s and the wall a request with the card's name and power
    limit."""
    import threading

    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.serve import serve

    kv_dtype, ring = MAIN_TIERS[0]
    eng = main_path_engine(model, params, kv_dtype, ring, prompts)
    rid = eng.submit(prompts[2], SERVER_NEW)
    eng.run()
    offline = eng.outputs[rid]
    httpd, es = serve(eng, port=0, block=False)
    addr = httpd.server_address
    try:
        build.reset_launch_counts()
        status, data, alone_s = http_call(
            addr, "POST", "/v1/completions",
            dict(prompt=prompts[2], max_tokens=SERVER_NEW))
        alone = json.loads(data)["choices"][0]["tokens"]
        mix = server_mix(prompts, sorted(set(offline)))
        calls = [(n, "POST", "/v1/completions", b) for n, b in mix]
        calls += [("bad", "POST", "/v1/completions",
                   dict(prompt=prompts[0], lora="x")),
                  ("health", "GET", "/health", None)]
        results = {}

        def client(name, method, path, body):
            results[name] = http_call(addr, method, path, body)

        threads = [threading.Thread(target=client, args=c) for c in calls]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = build.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        es.close()
        eng.close()
    failed = []
    if status != 200 or alone != offline:
        failed.append(f"alone {status}: {alone} != offline {offline}")
    choices = {}
    for name, body in mix:
        code, data, _ = results[name]
        if code != 200:
            failed.append(f"{name}: HTTP {code} {data[:200]!r}")
            continue
        if body.get("stream"):
            events, done = sse_events(data)
            streamed = [t for e in events
                        if e["object"] == "text_completion.chunk"
                        for t in e["choices"][0]["tokens"]]
            final = [e for e in events if e["object"] == "text_completion"]
            if not done or len(final) != 1 or \
                    streamed != final[0]["choices"][0]["tokens"]:
                failed.append(f"{name}: streamed {streamed} against "
                              f"{final}")
                continue
            choices[name] = final[0]["choices"]
        else:
            choices[name] = json.loads(data)["choices"]
        n = body.get("n", 1)
        if [len(c["tokens"]) for c in choices[name]] != [SERVER_NEW] * n:
            failed.append(f"{name}: token counts {choices[name]}")
    if "n2_greedy" in choices and len({
            tuple(c["tokens"]) for c in choices["n2_greedy"]}) != 1:
        failed.append(f"greedy branches differ: {choices['n2_greedy']}")
    if "force" in choices and choices["force"][0]["tokens"] != \
            [SERVER_FORCE] * SERVER_NEW:
        failed.append(f"force: {choices['force']}")
    if "ban" in choices and set(choices["ban"][0]["tokens"]) & set(offline):
        failed.append(f"ban: {choices['ban']} against {offline}")
    if results["bad"][0] != 400 or results["health"][0] != 200:
        failed.append(f"bad {results['bad'][:2]}, health "
                      f"{results['health'][:2]}")
    for k in ("paged_decode", "paged_prefill"):
        if not launches.get(k):
            failed.append(f"{k} never launched: {launches}")
    latencies = [results[n][2] for n, _ in mix]
    rec = dict(kv_dtype=kv_dtype, recent_window=ring, gpu=gpu_query(),
               requests=len(mix), completions=sum(
                   b.get("n", 1) for _, b in mix),
               new_tokens_each=SERVER_NEW, wall_s=wall,
               requests_per_s=len(mix) / wall,
               wall_per_request_s=statistics.mean(latencies),
               max_request_s=max(latencies), alone_s=alone_s,
               health=json.loads(results["health"][1]),
               launches=launches, failed=failed)
    log("main_path_server", **rec)
    if failed:
        raise AssertionError(f"HTTP server: {failed}")
    return rec


# Kernels of the decode window's trace printed, heaviest first;
# paged_decode must be among them.
TRACE_TOP = 10


def trace_decode_window(model, params, prompts):
    """Phase 4's decode window under ``utils/profiling.timed``: the 8
    prompts in the int8 + ring cache, then 32 greedy tokens each at the
    engine's defaults (every step a decode call), CUDA activity only, the
    Chrome trace written under build/profiles. Logs the window's wall
    time, summed kernel time, the device's idle share and its heaviest
    kernels; fails unless paged_decode is among them."""
    from tpu_flash_torch.engine.metrics import EngineMetrics
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.utils.profiling import timed

    kv_dtype, ring = MAIN_TIERS[0]
    eng = main_path_engine(model, params, kv_dtype, ring, prompts)
    for p in prompts:
        eng.submit(p, 32)
    while (eng.scheduler.waiting or any(
            r.prefilled < r.prompt_len
            for r in eng.scheduler.active.values())):
        eng.step()
    eng.metrics = EngineMetrics()
    build.reset_launch_counts()
    logdir = os.path.join(REPO, "build", "profiles")
    win = timed(eng.run, "cuda", logdir)
    eng.close()
    top = sorted(win.kernels.items(), key=lambda kv: -kv[1])[:TRACE_TOP]
    rec = dict(kv_dtype=kv_dtype, recent_window=ring, wall_s=win.wall,
               kernel_s=win.busy, idle_share=win.idle_share(),
               routes=eng.metrics.route_counts(),
               launches=build.launch_counts(),
               top_kernels=[[n[:80], sec] for n, sec in top],
               trace_dir=os.path.relpath(logdir, REPO))
    log("main_path_decode_trace", gpu=gpu_query(), **rec)
    if not any("paged_decode" in n for n, _ in top):
        raise AssertionError(
            f"paged_decode not among the decode window's {TRACE_TOP} "
            f"heaviest kernels: {rec['top_kernels']}")
    return rec


# -- phase "parallel": multi-device serving on one card -------------------------
#
# One H100 cannot run a multi-rank collective (NCCL refuses two ranks on
# one device), so the card runs what one card can: a process group of one
# (NCCL) and the mesh over it, the ring's per-block kernel calls in a
# single-process schedule, head-sliced kernel calls, the tensor-parallel
# engine at a model axis of 1, and two data-parallel replicas sharing the
# card. Multi-rank correctness is held on the CPU (gloo groups in
# tests/test_torch_parallel.py and tests/test_torch_sharded_engine.py).

# The ring merges f32 states of bf16 block outputs and rounds once. A
# block's output is within BF16_TOL_ULPS (2) bf16 ulps of its row's max
# of the plain version's, which is within one ulp of exact attention (it
# rounds P to bf16 and the output once): RING_BLOCK_ULPS ulps of the
# block's own row max, weighted in the merge by the block's share of the
# row's softmax mass (exp(lse_b - lse)). The ring's final rounding and
# the whole-sequence plain reference's own error add RING_REF_ULPS ulps
# of the reference row's max; against K1 over the whole sequence, K1's
# BF16_TOL_ULPS more.
RING_BLOCK_ULPS = 3.0
RING_REF_ULPS = 1.5
RING_N = 4
# name -> (b, hq, hkv, s, d, options): Llama-3-8B attention; Gemma-2-9B's
# geometry with its 4096 window over four 2048-token blocks (diagonal,
# dense, banded with rows that see no key, empty) and cap 50; ALiBi and
# sinks at d 128.
RING_CASES = {
    "llama3_8b_causal": (1, 32, 8, 8192, 128, {}),
    "gemma2_9b_window": (1, 16, 8, 8192, 256,
                         dict(window=4096, softcap=50.0)),
    "alibi_d128": (1, 32, 8, 4096, 128, dict(alibi=True)),
    "sinks_d128": (1, 32, 8, 4096, 128, dict(sinks=True)),
}


def bf16_ulps(top):
    """The bf16 ulp at each magnitude in ``top`` (0 where it is 0)."""
    import torch

    _, e = torch.frexp(top)  # top in [2^(e-1), 2^e): ulp 2^(e - 8)
    return torch.where(top > 0, torch.ldexp(torch.ones_like(top), e - 8),
                       torch.zeros_like(top))


def ring_block_terms(states, n, sinks):
    """Per output row, the sum over the row's ring blocks of the block's
    share of the row's softmax mass times the bf16 ulp of the block's row
    max (RING_BLOCK_ULPS multiplies it): [b, h, s] f32. ``states``: every
    rank's block states, rank-major, source-minor."""
    import torch

    terms = []
    for my in range(n):
        row = states[my * n:(my + 1) * n]
        m = torch.stack([st.m[..., 0] for st in row])
        mass = m if sinks is None else torch.cat([m, sinks.float()[
            None, None, :, None].expand(1, *m.shape[1:])])
        w = torch.exp(m - torch.logsumexp(mass, dim=0))
        ulps = torch.stack([bf16_ulps(st.acc.abs().amax(-1)) for st in row])
        terms.append((w * ulps).sum(0))
    return torch.cat(terms, dim=2)


def ring_dropped_own_block(states, n, sinks, dtype):
    """The control: the last rank's output block from its block states
    (``states`` as ring_block_terms takes them) merged in ring order with
    its own (diagonal) block left out."""
    from tpu_flash_torch.core.softmax import (
        finalize,
        finalize_with_sinks,
        merge_softmax_states,
    )

    my = n - 1
    row = states[my * n:(my + 1) * n]
    state = row[my - 1]
    for src in range(my - 2, -1, -1):
        state = merge_softmax_states(state, row[src])
    if sinks is not None:
        return finalize_with_sinks(state, sinks, dtype)
    return finalize(state, dtype)


# (f) The ring's backward: each block's gradients come from the backward
# kernels (K8/K9) with the lse cotangent of the merge, and a row of dQ,
# dK or dV is the bf16 sum of its blocks' contributions. A block's
# contribution is within BF16_TOL_ULPS (2) ulps of its own row max of its
# plain version's, whose final rounding and the bf16 addition into the
# row add half an ulp each: RING_GRAD_BLOCK_ULPS ulps of each
# contribution's own row max, summed over the row's blocks (contributions
# may cancel, so the row's own max does not bound them). The
# whole-sequence plain reference's
# rounding adds RING_REF_ULPS ulps of its row max. Both sides also round
# inputs of the backward's sums to bf16, each element by at most u =
# 2^-9 of itself, at other magnitudes (a block's P is normalized by its
# own lse): the forward's o (in di = o . dO), the ring's per-block dO (in
# dP, di and dV), dS (before the dQ and dK products) and P (before dV, in
# the kernels). Such roundings are independent from element to element,
# so over a sum of many terms they add as a random walk: a sum of e_t
# with |e_t| <= u |t| has a standard deviation under u sqrt(sum t^2) /
# sqrt(3), and RING_RSS of such root sums a side (over 7 deviations for
# the two sides together) bound it. To first order, with D_ij = dS_ij^2
# + (P_ij cap'_ij scale)^2 (dO_i^2 . v_j^2) and E_i = sum_d (o_id
# dO_id)^2 (di's roundings), on each side dQ_i moves by at most u RING_RSS
# (sqrt(sum_j D_ij k_j^2) + 2 sqrt(E_i) |sum_j P_ij cap'_ij scale k_j|)
# (di is one number for the whole row), dK_j by u RING_RSS sqrt(sum_i
# (D_ij + 4 (P_ij cap'_ij scale)^2 E_i) q_i^2) and dV_j by u RING_RSS
# sqrt(2 sum_i P_ij^2 dO_i^2), over the whole sequence
# (ring_rounding_terms). dQ and dK rows keep bwd_row_bars' floor. The
# control, the last rank's output with its own block and its first
# received one dropped (its nearest keys, which ALiBi favours, and a
# quarter to a half of each row's keys), must miss in at least half of
# that rank's dQ rows and of its own kv block's dK and dV rows (which no
# other rank reads, and the control leaves no contribution). The sink
# logits'
# gradient is held at RING_SINK_REL of its max |ref|; its control, the
# plain gradient with dO's early half scaled by RING_SINK_SHIFT (a sink
# holds weight in early rows, which see few keys), must miss.
RING_GRAD_BLOCK_ULPS = 3.0
RING_ROUND_U = 2.0 ** -9
RING_RSS = 3.0
RING_SINK_REL = 2.0 ** -6
RING_SINK_SHIFT = 2.0


def ring_grad_terms(leaves, opts, do):
    """Per row of dq, dk and dv, the sum over the ring's blocks of the
    bf16 ulp of the block's own contribution's row max: each rank's
    block states differentiated one at a time with the cotangents that
    the merge gives them (comparison launches, after the counted run)."""
    import torch

    from tpu_flash_torch.core.softmax import (
        empty_state,
        finalize,
        finalize_with_sinks,
        merge_softmax_states,
    )
    from tpu_flash_torch.parallel.mesh import take_shard
    from tpu_flash_torch.parallel.ring import block_kind, ring_block_state

    q, k, v = leaves[:3]
    sinks = opts.get("sinks")
    blk = [[take_shard(x, RING_N, r, 2) for r in range(RING_N)]
           for x in (q, k, v)]
    terms = [torch.zeros(x.shape[:3], device=x.device) for x in (q, k, v)]
    for my in range(RING_N):
        live = [src for src in range(my, -1, -1)
                if block_kind(my - src, blk[0][my].shape[2], True,
                              opts["window"]) != "empty"]
        states = [ring_block_state(
            blk[0][my], blk[1][src], blk[2][src], distance=my - src,
            n_ring=RING_N, causal=True, window=opts["window"],
            softcap=opts["softcap"], alibi=opts.get("alibi"))
            for src in live]
        state = empty_state(blk[0][my].shape[:3], q.shape[3],
                            device=q.device)
        for st in states:
            state = merge_softmax_states(state, st)
        out = (finalize(state, q.dtype) if sinks is None
               else finalize_with_sinks(state, sinks, q.dtype))
        cots = torch.autograd.grad(
            out, [t for st in states for t in (st.acc, st.m)],
            take_shard(do, RING_N, my, 2), retain_graph=True)
        for j, st in enumerate(states):
            parts = torch.autograd.grad(
                (st.acc, st.m), (q, k, v), cots[2 * j:2 * j + 2],
                retain_graph=True)
            for t, part in zip(terms, parts):
                t += bf16_ulps(part.float().abs().amax(-1))
    return terms


def ring_rounding_terms(q, k, v, do, opts):
    """Per row of dq, dk and dv, what the bf16 roundings of o, dO, dS and
    P can move on the two sides together (the comment above RING_RSS
    gives the sums), max over d, with the whole sequence's P and di (the
    plain forward's lse and output), a kv tile at a time."""
    import torch

    from tpu_flash_torch.ops.flash.backward import recompute_p, softmax_di
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = d ** -0.5
    kw = dict(causal=True, window=opts["window"], softcap=opts["softcap"],
              alibi=opts.get("alibi"))
    sinks = opts.get("sinks")
    o, lse = flash_fwd_plain(q, k, v, sm_scale=scale, save_lse=True,
                             sinks=None if sinks is None else sinks.detach(),
                             **kw)
    qf = q.float().reshape(b, hkv, g, s, d)
    dof = do.float().reshape(b, hkv, g, s, d)
    lse_c = lse.float().reshape(b, hkv, g, s, 1)
    di = softmax_di(o, do).reshape(b, hkv, g, s, 1)
    e = (o.float() * do.float()).square().sum(-1).reshape(b, hkv, g, s, 1)
    pk, aq2 = torch.zeros_like(qf), torch.zeros_like(qf)
    ak2 = torch.zeros_like(qf[:, :, 0])
    av2 = torch.zeros_like(ak2)
    for t0 in range(0, s, 512):
        kt = k[:, :, t0:t0 + 512].float()
        vt = v[:, :, t0:t0 + 512].float()
        p, dcap = recompute_p(qf, kt, lse_c, t0, sm_scale=scale, **kw)
        pc = p if dcap is None else p * dcap
        ds = pc * (torch.einsum("bhgqd,bhkd->bhgqk", dof, vt) - di) * scale
        pc = pc * scale
        dd = ds.square() + pc.square() * torch.einsum(
            "bhgqd,bhkd->bhgqk", dof.square(), vt.square())
        pk += torch.einsum("bhgqk,bhkd->bhgqd", pc, kt)
        aq2 += torch.einsum("bhgqk,bhkd->bhgqd", dd, kt.square())
        ak2[:, :, t0:t0 + 512] = torch.einsum(
            "bhgqk,bhgqd->bhkd", dd + 4 * pc.square() * e, qf.square())
        av2[:, :, t0:t0 + 512] = torch.einsum(
            "bhgqk,bhgqd->bhkd", p.square(), dof.square())
    sides = 2 * RING_ROUND_U * RING_RSS
    dq = aq2.sqrt() + 2 * e.sqrt() * pk.abs()
    return (sides * dq.reshape(b, hq, s, d).amax(-1),
            sides * ak2.sqrt().amax(-1),
            sides * (2 * av2).sqrt().amax(-1))


def ring_grad_rows(got, ref, terms, rounding, control, grad, rows):
    """One gradient's rows against the plain reference at the ring's
    bar, and the control's ``rows`` (the last rank's q rows, or its own
    kv block) against it."""
    import torch

    floor, _ = bwd_row_bars(ref, grad)
    floor = floor * (RING_REF_ULPS / BF16_TOL_ULPS)
    bars = (RING_GRAD_BLOCK_ULPS * terms + rounding
            + RING_REF_ULPS * bf16_ulps(ref.float().abs().amax(-1)))
    bars = torch.maximum(bars, floor)
    err = (got.float() - ref.float()).abs().amax(-1)
    ctl = (control[..., rows, :].float()
           - ref[..., rows, :].float()).abs().amax(-1)
    return dict(max_abs_err=float(err.max()),
                max_abs_ref=float(ref.float().abs().max()),
                rows_over_bar=int((err > bars).sum()),
                max_of_bar=float((err / bars.clamp_min(1e-30)).max()),
                control_rows_missed=float((ctl > bars[..., rows])
                                          .float().mean()),
                finite=bool(torch.isfinite(got).all()))


def check_ring_backward(dev, q, k, v, opts, i):
    """(f) The schedule's dq, dk, dv (and dsinks) against the plain
    whole-sequence backward, each row within its bar; the control (the
    last rank's two nearest blocks dropped) missing; the schedule's
    forward + backward ms beside one K1 + K8/K9 pair over the whole
    sequence, and the kernels' launches in one schedule's forward and
    backward."""
    import torch

    from tpu_flash_torch.core.softmax import (
        empty_state,
        finalize,
        finalize_with_sinks,
        merge_softmax_states,
    )
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import flash_attention
    from tpu_flash_torch.parallel.mesh import take_shard
    from tpu_flash_torch.parallel.ring import (
        ring_attention_schedule,
        ring_block_state,
    )

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    opts = dict(opts)
    if opts.get("sinks") is not None:
        leaves.append(opts["sinks"].detach().requires_grad_())
        opts["sinks"] = leaves[3]
    g = torch.Generator(device=dev).manual_seed(SEED + 60 + i)
    do = torch.randn(q.shape, generator=g, device=dev).bfloat16()

    def ring():
        out = ring_attention_schedule(*leaves[:3], RING_N, **opts)
        return torch.autograd.grad(out, leaves, do)

    def whole(grad_out=do):
        out = flash_attention(*leaves[:3], **opts)
        return torch.autograd.grad(out, leaves, grad_out)

    build.reset_launch_counts()
    got = ring()
    torch.cuda.synchronize()
    launches = build.launch_counts()
    ring_ms = time_ms(ring, 3, warmup=1)
    whole_ms = time_ms(whole, 3, warmup=1)
    terms = ring_grad_terms(leaves, opts, do)
    rounding = ring_rounding_terms(q, k, v, do, opts)
    with plain_versions():
        ref = whole()
    # The control: the last rank's output from its block states merged
    # in ring order without its own and its first received one,
    # differentiated alone.
    s = q.shape[2]
    blk_len = s // RING_N
    my = RING_N - 1
    blk = [[take_shard(x, RING_N, r, 2) for r in range(RING_N)]
           for x in leaves[:3]]
    state = empty_state(blk[0][my].shape[:3], q.shape[3], device=q.device)
    for src in range(my - 2, -1, -1):
        state = merge_softmax_states(state, ring_block_state(
            blk[0][my], blk[1][src], blk[2][src], distance=my - src,
            n_ring=RING_N, causal=True, window=opts["window"],
            softcap=opts["softcap"], alibi=opts.get("alibi")))
    ctl_out = (finalize(state, q.dtype) if opts.get("sinks") is None
               else finalize_with_sinks(state, opts["sinks"], q.dtype))
    control = torch.autograd.grad(ctl_out, leaves[:3],
                                  do[..., my * blk_len:, :])
    last = slice(my * blk_len, s)
    grads = {name: ring_grad_rows(a, r, t, rd, c, name, last)
             for name, a, r, t, rd, c in zip(("dq", "dk", "dv"), got, ref,
                                             terms, rounding, control)}
    ok = all(r["rows_over_bar"] == 0 and r["finite"]
             and r["control_rows_missed"] >= 0.5 for r in grads.values())
    if len(leaves) == 4:
        shifted = do.clone()
        shifted[..., :s // 2, :] *= RING_SINK_SHIFT
        with plain_versions():
            ctl = whole(shifted)[3]
        bar = RING_SINK_REL * float(ref[3].float().abs().max())
        grads["dsinks"] = dict(max_abs_err=max_err(got[3], ref[3]),
                               max_abs_ref=float(ref[3].abs().max()),
                               bar=bar, control_err=max_err(ctl, ref[3]))
        ok = ok and (grads["dsinks"]["max_abs_err"] <= bar
                     < grads["dsinks"]["control_err"])
    return dict(backward_ok=ok, grads=grads, fwd_bwd_ms=ring_ms,
                whole_k1_k8_k9_ms=whole_ms, fwd_bwd_launches=launches)


def check_ring_case(dev, name, i):
    """One ring case: the schedule (every rank's sources in ring order
    through ring_block_state, merged) against K1 over the whole sequence
    and against the plain version, each row within its bar; the control
    (the last rank's block states merged with its own block left out)
    must miss the bar in at least half of that rank's rows."""
    import torch

    from tpu_flash_torch.core.reference import alibi_slopes
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import flash_attention
    from tpu_flash_torch.parallel.mesh import take_shard
    from tpu_flash_torch.parallel.ring import (
        ring_attention_schedule,
        ring_block_state,
    )

    b, hq, hkv, s, d, extra = RING_CASES[name]
    g = torch.Generator(device=dev).manual_seed(SEED + 40 + i)
    q = torch.randn(b, hq, s, d, generator=g, device=dev).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=g, device=dev).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=g, device=dev).bfloat16()
    opts = dict(causal=True, window=extra.get("window"),
                softcap=extra.get("softcap"))
    if extra.get("alibi"):
        opts["alibi"] = alibi_slopes(hq, dev)
    if extra.get("sinks"):
        opts["sinks"] = torch.randn(hq, generator=g, device=dev)

    def ring():
        return ring_attention_schedule(q, k, v, RING_N, **opts)

    blocks = [[take_shard(x, RING_N, r, 2) for r in range(RING_N)]
              for x in (q, k, v)]

    def block_calls():
        # The schedule's block states alone, unmerged.
        return [ring_block_state(
            blocks[0][my], blocks[1][src], blocks[2][src],
            distance=my - src, n_ring=RING_N, causal=True,
            window=opts["window"], softcap=opts["softcap"],
            alibi=opts.get("alibi"))
            for my in range(RING_N) for src in range(RING_N)]

    build.reset_launch_counts()
    out = ring()
    torch.cuda.synchronize()
    launches = build.launch_counts()
    ring_ms = time_ms(ring, 5)
    blocks_ms = time_ms(block_calls, 5)
    whole = flash_attention(q, k, v, **opts)
    whole_ms = time_ms(lambda: flash_attention(q, k, v, **opts), 5)
    with plain_versions(["flash_fwd"]):
        ref = flash_attention(q, k, v, **opts)
    # The block states again (comparison launches, not counted).
    states = block_calls()
    terms = ring_block_terms(states, RING_N, opts.get("sinks"))
    ref_ulp = bf16_ulps(ref.float().abs().amax(-1))
    bar_plain = RING_BLOCK_ULPS * terms + RING_REF_ULPS * ref_ulp
    bar_k1 = bar_plain + BF16_TOL_ULPS * ref_ulp
    err_plain = (out.float() - ref.float()).abs().amax(-1)
    err_k1 = (out.float() - whole.float()).abs().amax(-1)
    ctl = ring_dropped_own_block(states, RING_N, opts.get("sinks"),
                                 q.dtype)
    last = slice((RING_N - 1) * s // RING_N, s)
    ctl_err = (ctl.float() - ref[..., last, :].float()).abs().amax(-1)
    ctl_missed = float((ctl_err > bar_plain[..., last]).float().mean())
    bwd = check_ring_backward(dev, q, k, v, opts, i)
    rec = dict(
        case=name, b=b, hq=hq, hkv=hkv, s=s, d=d, n_ring=RING_N,
        window=extra.get("window"), softcap=extra.get("softcap"),
        alibi=bool(extra.get("alibi")), sinks=bool(extra.get("sinks")),
        launches={n: launches.get(n, 0) + bwd["fwd_bwd_launches"].get(n, 0)
                  for n in {*launches, *bwd["fwd_bwd_launches"]}},
        ring_ms=ring_ms, blocks_ms=blocks_ms,
        whole_k1_ms=whole_ms,
        max_abs_err_plain=float(err_plain.max()),
        max_abs_err_k1=float(err_k1.max()),
        rows_over_bar_plain=int((err_plain > bar_plain).sum()),
        rows_over_bar_k1=int((err_k1 > bar_k1).sum()),
        max_of_bar_plain=float((err_plain / bar_plain).max()),
        max_of_bar_k1=float((err_k1 / bar_k1).max()),
        control_rows_missed=ctl_missed,
        finite=bool(torch.isfinite(out).all()),
        backward=bwd,
    )
    log("parallel_ring", gpu=gpu_query(), **rec)
    if not (rec["finite"] and rec["rows_over_bar_plain"] == 0
            and rec["rows_over_bar_k1"] == 0 and ctl_missed >= 0.5):
        raise AssertionError(f"ring case {name} off its bar: {rec}")
    if not bwd["backward_ok"]:
        raise AssertionError(f"ring case {name}: backward off its bar, or "
                             f"a control within it: {bwd}")
    require_launches(rec, ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"])
    return rec


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_group_of_one(device_type="cuda"):
    """(a) A process group of one (NCCL on the card) from torchrun's
    environment, and the three-dimensional mesh over it; one all-reduce
    on its model group."""
    import torch
    import torch.distributed as dist

    from tpu_flash_torch.core.config import MeshConfig
    from tpu_flash_torch.parallel import build_mesh, initialize_multihost
    from tpu_flash_torch.parallel.multihost import BACKENDS

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    # NCCL's bootstrap needs a socket interface; this one-host group of
    # one has the loopback.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    if not initialize_multihost(device_type=device_type):
        raise AssertionError("initialize_multihost() found no environment")
    again = initialize_multihost(device_type=device_type)
    mesh = build_mesh(MeshConfig(), device_type)
    x = torch.arange(8.0, device=device_type)
    dist.all_reduce(x, group=mesh.get_group("model"))
    if device_type == "cuda":
        torch.cuda.synchronize()
    rec = dict(backend=dist.get_backend(), world=dist.get_world_size(),
               idempotent=again, dims=list(mesh.mesh_dim_names),
               shape=list(mesh.shape), device_type=mesh.device_type,
               all_reduce_ok=bool(torch.equal(x.cpu(), torch.arange(8.0))),
               init_s=time.perf_counter() - t0)
    log("parallel_group", **rec)
    if (rec["backend"] != BACKENDS[device_type]
            or rec["dims"] != ["data", "seq", "model"]
            or rec["shape"] != [1, 1, 1] or not rec["all_reduce_ok"]
            or not again):
        raise AssertionError(f"group of one: {rec}")
    return mesh


def check_head_slices(dev, mesh):
    """(c) Each half of the kv heads through the sharded functions'
    per-rank bodies: K4 (int8 and bf16 pages, the main path's decode
    shape) and K1 (bf16 causal, b 1 x 2048) outputs bit for bit the whole
    call's slice."""
    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.quant import QuantizedTensor
    from tpu_flash_torch.parallel import (
        sharded_flash_attention,
        sharded_paged_attention,
    )

    def halves(x, n_heads, dim):
        h = n_heads // 2
        return [x.narrow(dim, r * h, h).contiguous() for r in range(2)]

    def page_halves(p):
        if isinstance(p, QuantizedTensor):
            return [p._replace(values=vals, scales=sc) for vals, sc in zip(
                halves(p.values, 8, 0), halves(p.scales, 8, 0))]
        return halves(p, 8, 0)

    build.reset_launch_counts()
    paged = sharded_paged_attention(mesh).local
    cases = {}
    for tier in ("int8", "bfloat16"):
        q, kp, vp, lengths, table, _ = decode_inputs(dev, tier, 0)
        whole = paged(q, kp, vp, lengths, table)
        parts = [paged(qh, kh, vh, lengths, table) for qh, kh, vh in zip(
            halves(q, 32, 1), page_halves(kp), page_halves(vp))]
        cases[f"paged_{tier}"] = differing(torch.cat(parts, 1), whole)
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    q = torch.randn(1, 32, 2048, 128, generator=g, device=dev).bfloat16()
    k = torch.randn(1, 8, 2048, 128, generator=g, device=dev).bfloat16()
    v = torch.randn(1, 8, 2048, 128, generator=g, device=dev).bfloat16()
    flash = sharded_flash_attention(mesh, causal=True).local
    whole = flash(q, k, v)
    parts = [flash(*xs) for xs in zip(halves(q, 32, 1), halves(k, 8, 1),
                                      halves(v, 8, 1))]
    cases["flash_bf16_causal"] = differing(torch.cat(parts, 1), whole)
    torch.cuda.synchronize()
    rec = dict(differing=cases, launches=build.launch_counts())
    log("parallel_head_slices", **rec)
    if any(cases.values()):
        raise AssertionError(f"head-sliced calls off the whole call: {rec}")
    require_launches(rec, ["paged_decode", "flash_fwd"])
    return rec


def check_tp_engine(model, params, prompts, reserve_out, mesh):
    """(d) The tensor-parallel engine at a model axis of 1 on phase 4's
    weights (shared, not copied), int8 + ring, phase 4's 8 prompts x 32
    greedy tokens: no model group (no all-reduce on a group of one) and
    the tokens of phase 4's engine, bit for bit."""
    import torch

    from tpu_flash_torch.ops import build

    eng = main_path_engine(model, params, "int8", 128, prompts, mesh=mesh)
    shared = eng.params is params
    # A model axis of one is one device: the engine keeps no group.
    grouped = eng._tp_group is not None
    build.reset_launch_counts()
    t0 = time.perf_counter()
    ids = [eng.submit(p, 32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = [eng.outputs[i] for i in ids]
    rec = dict(launches=build.launch_counts(), wall_s=wall,
               routes=eng.metrics.route_counts(), weights_shared=shared,
               model_group=grouped,
               cache_kv_heads=eng.cache.k_pages.shape[1],
               match=token_match(out, reserve_out))
    eng.close()
    log("parallel_tp_engine", gpu=gpu_query(), **rec)
    if out != reserve_out or not shared or grouped:
        raise AssertionError(f"TP engine off phase 4's tokens: {rec}")
    require_launches(rec, ["flash_fwd_exact", "paged_decode",
                           "paged_prefill"])
    return rec


# The DP replicas: phase 4's int8 + ring engine on 64 pages (the 8
# prompts need 53 at once; two 161-page caches would make a 3.4 GB
# snapshot: int8 pages and scales, rings as f32). Solo runs and their
# waves take 16 new tokens, the timed runs 32.
DP_PAGES, DP_SOLO_TOKENS = 64, 16


def dp_serve(dp, prompts, new_tokens, snapshot=None):
    """Serve ``prompts`` on a DataParallelEngine, a host-timed step at a
    time (each step ends in its replicas' host fetches; the device is
    synchronised after it): steps that prefill count toward prefill
    seconds, the rest toward decode. ``snapshot(dp)`` runs once, when
    every request holds 8 tokens, outside the timing. Returns the record
    and the fleet's outputs."""
    import torch

    ids = [dp.submit(p, new_tokens) for p in prompts]
    pre_s = dec_s = 0.0
    dec_tok = 0
    snap_s = None

    def totals():
        return (sum(e.metrics.prefill_tokens for e in dp.engines),
                sum(e.metrics.decode_tokens for e in dp.engines))

    while dp.has_work():
        p0, d0 = totals()
        t0 = time.perf_counter()
        dp.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        p1, d1 = totals()
        if p1 > p0:
            pre_s += dt
        else:
            dec_s += dt
            dec_tok += d1 - d0
        if snapshot is not None and snap_s is None and min(
                len(dp.outputs[i]) for i in ids) >= 8:
            t0 = time.perf_counter()
            snapshot(dp)
            snap_s = time.perf_counter() - t0
    prompt_tok = sum(len(p) for p in prompts)
    rec = dict(replicas=dp.replicas, requests=len(prompts),
               prompt_tokens=prompt_tok, prefill_s=pre_s,
               prefill_tok_per_s=prompt_tok / pre_s, decode_s=dec_s,
               decode_tokens=dec_tok,
               decode_tok_per_s=dec_tok / dec_s if dec_s else None,
               snapshot_s=snap_s)
    return rec, [dp.outputs[i] for i in ids]


def check_dp(dev, model, params, prompts):
    """(e) DataParallelEngine with two replicas sharing the card and the
    weights (devices cuda:0 twice), int8 + ring on DP_PAGES pages,
    speculation off:
    - each request's tokens equal that request served alone through one
      engine (cuBLAS picks its algorithm by rows, so a request is held
      against a run of the same rows): four waves of two requests, one a
      replica, against the 8 prompts served one at a time, each for
      DP_SOLO_TOKENS tokens;
    - aggregate prefill and decode tok/s of the 8 prompts at once on 2
      replicas (4 each) against 1 replica (all 8), printed, not a target
      (decode is host-bound, and the replicas' threads share one
      interpreter lock);
    - the 2-replica run snapshotted mid-decode, restored into a fresh DP
      engine and run on: token for token the uninterrupted run."""
    import torch

    from tpu_flash_torch.checkpoint import (
        restore_dp_engine,
        snapshot_dp_engine,
    )
    from tpu_flash_torch.engine import DataParallelEngine, InferenceEngine
    from tpu_flash_torch.ops import build

    cfg = main_path_config("int8", 128, num_pages=DP_PAGES)
    device = "cuda:0" if dev == "cuda" else dev

    def fleet(replicas):
        dp = DataParallelEngine(model, params, cfg, replicas=replicas,
                                devices=[device] * replicas)
        for e in dp.engines:
            e.speculation_k = 0
        return dp

    solo = InferenceEngine(model, params, cfg)
    solo.speculation_k = 0
    t0 = time.perf_counter()
    want = []
    for p in prompts:
        rid = solo.submit(p, DP_SOLO_TOKENS)
        want.append(solo.run()[rid])
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo.close()
    # The record's launches are the DP runs' alone (waves, 1 and 2
    # replicas, the restore), not the solo reference's.
    build.reset_launch_counts()
    dp = fleet(2)
    shared = all(e.params["embed"] is params["embed"] for e in dp.engines)
    t0 = time.perf_counter()
    got = []
    for w in range(0, len(prompts), 2):
        ids = [dp.submit(p, DP_SOLO_TOKENS) for p in prompts[w:w + 2]]
        out = dp.run()
        got += [out[i] for i in ids]
    torch.cuda.synchronize()
    waves_s = time.perf_counter() - t0
    per_replica = [e.metrics.decode_tokens for e in dp.engines]
    dp.close()
    del dp
    runs = {}
    with build_tempdir("dp-snapshot-") as tmp:
        def snapshot(fl):
            snapshot_dp_engine(tmp, fl)
            torch.cuda.synchronize()

        for replicas in (1, 2):
            fl = fleet(replicas)
            runs[replicas] = dp_serve(fl, prompts, 32,
                                      snapshot if replicas == 2 else None)
            fl.close()
        snap_bytes = dir_bytes(tmp)
        fresh = fleet(2)
        t0 = time.perf_counter()
        restore_dp_engine(tmp, fresh)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        resumed = fresh.run()
        resumed = [resumed[i] for i in range(len(prompts))]
        fresh.close()
    one, two = runs[1][0], runs[2][0]
    rec = dict(
        launches=build.launch_counts(), weights_shared=shared,
        solo_match=token_match(got, want), solo_s=solo_s,
        waves_2x1_s=waves_s, decode_tokens_per_replica=per_replica,
        one_replica=one, two_replicas=two,
        prefill_2_over_1=two["prefill_tok_per_s"] / one["prefill_tok_per_s"],
        decode_2_over_1=two["decode_tok_per_s"] / one["decode_tok_per_s"],
        snapshot_bytes=snap_bytes, snapshot_write_s=two["snapshot_s"],
        snapshot_read_s=read_s,
        resume_match=token_match(resumed, runs[2][1]),
    )
    log("parallel_dp", gpu=gpu_query(), **rec)
    if got != want or resumed != runs[2][1] or not shared:
        raise AssertionError(f"DP replicas off their reference: {rec}")
    require_launches(rec, ["flash_fwd_exact", "paged_decode",
                           "paged_prefill"])
    return rec


def check_parallel(dev, model, params, prompts, reserve_out):
    """Phase "parallel": (a) the group of one, (b) the ring schedule's
    cases, (c) head-sliced K4 and K1 calls, (d) the TP engine, (e) the
    data-parallel engine. Every part's launches join the kernels line."""
    import torch.distributed as dist

    mesh = check_group_of_one()
    try:
        recs = [check_ring_case(dev, name, i)
                for i, name in enumerate(RING_CASES)]
        recs.append(check_head_slices(dev, mesh))
        recs.append(check_tp_engine(model, params, prompts, reserve_out,
                                    mesh))
        recs.append(check_dp(dev, model, params, prompts))
    finally:
        dist.destroy_process_group()
    return recs


# Gemma-2-9B at full width (GEMMA2_9B: hidden 3584, 16 q / 8 kv heads of
# 256, ffn 14336, vocab 256000, 42 layers alternating a 4096-token window
# and full attention, softcap 50; ~18.5 GB of seeded random bf16
# weights), uncut, served as phase 4 serves Llama-3-8B on its two main
# tiers (MAIN_TIERS): every kernel of the path at head width 256.


def check_gemma_path(dev):
    """Phase 4, Gemma-2-9B: 8 requests x 32 greedy tokens on an int8
    cache with the ring and on a bf16 cache at the default routing; each
    held as the Llama runs are (finite logits within LOGITS_REL_TOL of
    the plain forward's, a fused step, every kernel launched)."""
    import torch

    from tpu_flash_torch.models import GEMMA2_9B, FlashTransformer

    t0 = time.perf_counter()
    model = FlashTransformer(GEMMA2_9B, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(
        w.numel() for k, v in params.items()
        for w in ([x for layer in v for x in layer.values()]
                  if k == "layers" else [v]))
    log("main_path_weights", model=GEMMA2_9B.name,
        layers=GEMMA2_9B.num_layers, cut="none", params=n_params,
        gbytes=n_params * 2 / 1e9, init_s=time.perf_counter() - t0)
    prompts = main_path_prompts(GEMMA2_9B.vocab_size)
    recs = []
    with torch.no_grad():
        for kv_dtype, ring in MAIN_TIERS:
            rec, _ = serve_main(model, params, kv_dtype, ring, prompts, 32)
            rec["model"] = GEMMA2_9B.name
            log("main_path", gpu=gpu_query(), **rec)
            if not (rec["finite"]
                    and rec["first_logits_rel_err"] <= LOGITS_REL_TOL):
                raise AssertionError(
                    f"Gemma-2 first-step logits off the plain forward: {rec}")
            if rec["routes"]["fused"] < 1:
                raise AssertionError(f"no fused step: {rec}")
            require_launches(rec, ["flash_fwd_exact", "paged_decode",
                                   "paged_prefill"])
            recs.append(rec)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return recs


# -- phase 5: the trained checkpoint ------------------------------------------

TRAINED_PROMPTS = [
    b"def quantize(x, scale):\n    return ",
    b"The cache stores the keys and values of",
    b"import numpy as np\n\n",
]
# The kernel engine must give the plain-version engine's greedy tokens
# exactly, on every tier: the decode kernel computes its plain version's
# arithmetic bit for bit (order-free f64 sums), and the other kernels
# differ from theirs only in f32 summation order. A flip is a finding to
# look into (its first position and logit margin are printed), not noise
# to allow for.
TRAINED_MATCH_MIN = 1.0


def first_flips(model, params, prompts, got, want, lp_got, lp_want):
    """Where each request's kernel-run tokens first leave the plain run's:
    the position, both tokens and both runs' log-probs of them, the
    largest log-prob gap over the tokens before it, and the top two
    tokens and their logit margin there of a cache-free forward on the
    plain versions over the shared prefix."""
    import torch

    flips = []
    for p, g_, w, lg, lw in zip(prompts, got, want, lp_got, lp_want):
        n = next((i for i, (a, b) in enumerate(zip(g_, w)) if a != b), None)
        if n is None:
            continue
        with torch.no_grad(), plain_versions():
            logits = model.forward(params, torch.tensor(
                [p + w[:n]], device=model.device))[0, -1].float()
        top = logits.topk(2)
        flips.append(dict(
            position=n, of=len(w), kernel_token=g_[n], plain_token=w[n],
            kernel_logprob=lg[n], plain_logprob=lw[n],
            max_logprob_gap_before=max(
                (abs(a - b) for a, b in zip(lg[:n], lw[:n])), default=0.0),
            plain_top2=top.indices.tolist(),
            plain_top2_margin=float(top.values[0] - top.values[1])))
    return flips


def token_match(got, want) -> float:
    """Share of positions where two runs' greedy tokens agree."""
    same = sum(a == b for g_, w in zip(got, want) for a, b in zip(g_, w))
    return same / sum(len(w) for w in want)


# The staggered two-request scenario of tests/test_torch_engine_routes.py:
# a same-stage group, a ragged step, a fused step, speculative steps.
STAGGERED = (list(b"for i in range(10):\n    print(i)\nfor i in range(10):\n"
                  b"    print(i)\nfor i in range(10):\n    print("),
             list(b"import numpy as np\n"))


def check_trained(dev):
    """Phase 5: the trained checkpoint at the engine's defaults, kernels
    against plain versions token for token on every cache tier,
    speculation proposing; each tier's greedy match against the bf16
    cache's tokens is printed (quality, not gated)."""
    from tpu_flash_torch.checkpoint import load_hf_dir
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    ckpt = os.path.join(REPO, "checkpoints", "tiny-byte-llama")
    models = {dt: load_hf_dir(ckpt, dtype=dt, device=dev)
              for dt in ("bfloat16", "float32")}
    results, failed = [], []
    # (kv dtype, ring, staggered, paged_prefill, model dtype):
    # TRAINED_PROMPTS arrive together, 32 tokens each; the staggered
    # scenario takes 12 tokens each. paged_prefill=False gathers int8
    # history (the ring overlaid) and runs the ragged kernel and the
    # gathered verify. The quantized tiers also run with a 32-token ring,
    # so decode reads their pages for all but the last 32 positions (the
    # auto 128-token ring would cover every context here); their match
    # against the bf16 cache is read at that ring. float32 pages serve
    # the bf16 model (as CacheConfig allows) and the model loaded in f32.
    for kv_dtype, ring, staggered, paged, mdt in (
            ("bfloat16", 0, False, "auto", "bfloat16"),
            ("int8", 0, False, "auto", "bfloat16"),
            ("int8", 32, False, "auto", "bfloat16"),
            ("int8", 32, True, "auto", "bfloat16"),
            ("int8", 0, False, False, "bfloat16"),
            ("int8", 32, True, False, "bfloat16"),
            ("float32", 0, False, "auto", "bfloat16"),
            ("float32", 0, False, "auto", "float32"),
            ("int4", 32, False, "auto", "bfloat16"),
            ("int4g32", 32, False, "auto", "bfloat16"),
            ("k8v4", 32, False, "auto", "bfloat16"),
            ("fp8", 32, False, "auto", "bfloat16"),
            ("int4", 32, True, "auto", "bfloat16"),
            ("fp8", 32, True, "auto", "bfloat16")):
        cfg = EngineConfig(
            max_batch_size=2 if staggered else 4, max_seq_len=128,
            prefill_chunk=32, paged_prefill=paged,
            cache=CacheConfig(page_size=32, num_pages=12 if staggered else 14,
                              max_pages_per_seq=4, kv_dtype=kv_dtype,
                              recent_window=ring),
        )

        model, params = models[mdt]

        def serve():
            eng = InferenceEngine(model, params, cfg)
            if staggered:
                ids = [eng.submit(STAGGERED[0], 12)]
                eng.step()
                ids.append(eng.submit(STAGGERED[1], 12))
            else:
                ids = [eng.submit(list(p), 32) for p in TRAINED_PROMPTS]
            out = eng.run()
            eng.close()
            return ([out[i] for i in ids], [eng.logprobs[i] for i in ids],
                    eng.metrics.route_counts(), eng.speculation_stats(),
                    type(eng.scheduler.allocator).__name__)

        shadow = {}
        with shadowed(shadow):
            got, lp_got, routes, spec, allocator = serve()
        with plain_versions():
            want, lp_want, _, _, _ = serve()
        match = token_match(got, want)
        if not results:
            bf16_tokens = got
        rec = dict(kv_dtype=kv_dtype, recent_window=ring,
                   staggered=staggered, paged_prefill=str(paged),
                   model_dtype=mdt, match=match,
                   min_match=TRAINED_MATCH_MIN,
                   max_logprob_gap=max(
                       abs(a - b) for lg, lw in zip(lp_got, lp_want)
                       for a, b in zip(lg, lw)),
                   match_vs_bf16_cache=(
                       None if staggered or mdt != "bfloat16"
                       else token_match(got, bf16_tokens)),
                   routes=routes, speculation=spec, shadow=shadow,
                   allocator=allocator,
                   text=[bytes(t).decode("utf-8", "replace") for t in got])
        name = f"{kv_dtype} ring {ring} paged {paged} model {mdt}"
        if allocator != "NativeAllocator":
            failed.append(f"{name}: the engine ran on {allocator}")
        if match < TRAINED_MATCH_MIN:
            prompts = ([STAGGERED[0], STAGGERED[1]] if staggered
                       else [list(p) for p in TRAINED_PROMPTS])
            rec["first_flips"] = first_flips(model, params, prompts, got,
                                             want, lp_got, lp_want)
            # Which kernel the flips come from: the kernel run again with
            # that one kernel on its plain version, against the plain run.
            only = {}
            for k in shadow:
                with plain_versions([k]):
                    only[k] = token_match(serve()[0], want)
            rec["match_with_only_plain"] = only
            failed.append(f"{name}: {match}")
        # At the engine's own inputs every kernel call holds its plain
        # version's output within the phase-3 bar, and decode to the bit.
        if (shadow.get("paged_decode", {}).get("differing")
                or any(v["max_of_bar"] > 1.0 for v in shadow.values())):
            failed.append(f"{name}: kernel call off its plain version "
                          f"{shadow}")
        log("trained_model", **rec)
        if staggered and not all(routes[k] for k in (
                "prefill_group", "prefill_ragged", "fused", "speculative")):
            raise AssertionError(f"a route was not reached: {routes}")
        results.append(rec)
    if failed:
        raise AssertionError(f"trained-model greedy match: {failed}")
    if not sum(r["speculation"]["proposed"] for r in results):
        raise AssertionError("no draft was proposed on the trained model")
    return (results + check_draft_speculation(models["bfloat16"])
            + check_trained_forks(models["bfloat16"])
            + check_trained_preemption(models["bfloat16"]))


# Forks and logit bias on the trained checkpoint: an n=3 greedy group on a
# prompt ending mid page (its tail page copied at the fork), a request with
# its likeliest bytes banned, and a neighbour; 24 new tokens each.
FORK_PROMPTS = (b"The cache stores the keys and values o",
                b"def quantize(x, scale):\n    return ",
                b"import numpy as np\n\n")
FORK_BAN = {t: -100.0 for t in b" etaoinsr"}
FORK_NEW = 24
# (kv dtype, ring): bf16; int8 with a ring (copied at the fork); int4 (a
# token-packed tail page); k8v4 (gathered history).
FORK_TIERS = (("bfloat16", 0), ("int8", 32), ("int4", 32), ("k8v4", 32))


def check_trained_forks(model_and_params, tiers=FORK_TIERS):
    """Phase 5, forks and logit bias: on each of ``tiers`` the mix
    (FORK_PROMPTS: the n=3 group, the ban, the neighbour) at the engine's
    defaults, token for token the same run on the plain versions, with
    every kernel call shadowed by its plain version (decode to the bit,
    the others within the phase-3 bar); no banned byte emitted. Then the
    group's branches against the same prompt served alone, with
    speculation off on both sides (decode then runs over every batch
    slot, so each matmul has the same rows in both runs; a verify batch
    has as many rows as items, and cuBLAS picks its algorithm by rows)."""
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    model, params = model_and_params
    results, failed = [], []
    for kv_dtype, ring in tiers:
        cfg = EngineConfig(
            max_batch_size=6, max_seq_len=128, prefill_chunk=32,
            cache=CacheConfig(page_size=32, num_pages=24,
                              max_pages_per_seq=4, kv_dtype=kv_dtype,
                              recent_window=ring))

        def serve(mix, spec_k=8):
            eng = InferenceEngine(model, params, cfg)
            eng.speculation_k = spec_k
            ids = [eng.submit(list(FORK_PROMPTS[0]), FORK_NEW,
                              n=3 if mix else 1)]
            if mix:
                ids += [eng.submit(list(FORK_PROMPTS[1]), FORK_NEW,
                                   logit_bias=FORK_BAN),
                        eng.submit(list(FORK_PROMPTS[2]), FORK_NEW)]
            eng.run()
            eng.close()
            return [[eng.outputs[c] for c in eng.branches(i)] for i in ids]

        shadow = {}
        with shadowed(shadow):
            got = serve(True)
        with plain_versions():
            want = serve(True)
        (solo,), = serve(False, spec_k=0)
        (group,) = serve(True, spec_k=0)[:1]
        rec = dict(kv_dtype=kv_dtype, recent_window=ring,
                   match_plain=got == want,
                   branches_equal_solo=group == [solo] * 3,
                   banned_emitted=sorted(set(got[1][0]) & set(FORK_BAN)),
                   shadow=shadow,
                   text=[bytes(o).decode("utf-8", "replace")
                         for g_ in got for o in g_])
        log("trained_forks", **rec)
        name = f"{kv_dtype} ring {ring}"
        if not rec["match_plain"]:
            failed.append(f"{name}: kernels {got} != plain {want}")
        if not rec["branches_equal_solo"]:
            failed.append(f"{name}: branches {group} != solo {solo}")
        if rec["banned_emitted"]:
            failed.append(f"{name}: banned bytes {rec['banned_emitted']}")
        if (shadow.get("paged_decode", {}).get("differing")
                or any(v["max_of_bar"] > 1.0 for v in shadow.values())):
            failed.append(f"{name}: kernel call off its plain version "
                          f"{shadow}")
        results.append(rec)
    if failed:
        raise AssertionError(f"trained forks and bias: {failed}")
    return results


# Optimistic admission on the trained checkpoint: TRAINED_PROMPTS, 32 new
# tokens each, on TRAINED_PREEMPT_PAGES pages of 32 tokens (one the trash
# page): at full context the three requests need 8 pages, so the
# scheduler preempts. (kv dtype, ring, preemption, adapter): bf16 and
# int8 + a 32-token ring in both modes, then int8 + ring under swap with
# the first and third request through a seeded adapter.
TRAINED_PREEMPT_PAGES = 6
TRAINED_PREEMPT_RUNS = (("bfloat16", 0, "recompute", False),
                        ("bfloat16", 0, "swap", False),
                        ("int8", 32, "recompute", False),
                        ("int8", 32, "swap", False),
                        ("int8", 32, "swap", True))


def check_trained_preemption(model_and_params):
    """Phase 5, preemption and adapters: each of TRAINED_PREEMPT_RUNS at
    the engine's defaults, token for token the same run on the plain
    versions, with every kernel call shadowed by its plain version
    (decode to the bit, the others within the phase-3 bar), and at least
    one preemption. The adapter run is also snapshotted after its first
    swap (once a request has 8 tokens), restored into a fresh engine and
    run on: its tokens must be the uninterrupted run's. Each run's match
    against the reserve engine's tokens is printed (a figure)."""
    from tpu_flash_torch.checkpoint import restore_engine, snapshot_engine
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    model, params = model_and_params
    adapter = main_path_adapter(model.config, SEED + 50)
    results, failed = [], []
    for kv_dtype, ring, mode, lora in TRAINED_PREEMPT_RUNS:
        def engine(admission="optimistic", num_pages=TRAINED_PREEMPT_PAGES):
            eng = InferenceEngine(model, params, EngineConfig(
                max_batch_size=4, max_seq_len=128, prefill_chunk=32,
                admission=admission, preemption=mode,
                cache=CacheConfig(page_size=32, num_pages=num_pages,
                                  max_pages_per_seq=4, kv_dtype=kv_dtype,
                                  recent_window=ring)))
            if lora:
                eng.register_lora("t", adapter)
            return eng

        def submit(eng):
            return [eng.submit(list(p), 32, lora="t" if lora and i != 1
                               else None)
                    for i, p in enumerate(TRAINED_PROMPTS)]

        def serve(**kw):
            eng = engine(**kw)
            ids = submit(eng)
            eng.run()
            eng.close()
            return ([eng.outputs[i] for i in ids],
                    eng.scheduler.num_preemptions)

        shadow = {}
        with shadowed(shadow):
            got, preemptions = serve()
        with plain_versions():
            want, _ = serve()
        reserve, _ = serve(admission="reserve", num_pages=14)
        name = f"{kv_dtype} ring {ring} {mode}{' adapter' if lora else ''}"
        rec = dict(kv_dtype=kv_dtype, recent_window=ring, preemption=mode,
                   adapter=lora, preemptions=preemptions,
                   match_plain=got == want,
                   match_vs_reserve=token_match(got, reserve), shadow=shadow,
                   text=[bytes(t).decode("utf-8", "replace") for t in got])
        if lora:
            eng = engine()
            ids = submit(eng)
            while eng.scheduler.has_work() and not (
                    eng._swapped
                    and max(len(eng.outputs[i]) for i in ids) >= 8):
                eng.step()
            with build_tempdir("snapshot-") as tmp:
                rec["swapped_at_snapshot"] = sorted(eng._swapped)
                snapshot_engine(tmp, eng)
                eng.close()
                fresh = engine()
                restore_engine(tmp, fresh)
                fresh.run()
                fresh.close()
            rec["snapshot_continuation_equal"] = (
                [fresh.outputs[i] for i in ids] == got)
            if not (rec["swapped_at_snapshot"]
                    and rec["snapshot_continuation_equal"]):
                failed.append(f"{name}: snapshot continuation")
        log("trained_preemption", **rec)
        if not rec["match_plain"]:
            failed.append(f"{name}: kernels {got} != plain {want}")
        if not preemptions:
            failed.append(f"{name}: nothing preempted")
        if (shadow.get("paged_decode", {}).get("differing")
                or any(v["max_of_bar"] > 1.0 for v in shadow.values())):
            failed.append(f"{name}: kernel call off its plain version "
                          f"{shadow}")
        results.append(rec)
    if failed:
        raise AssertionError(f"trained preemption: {failed}")
    return results


def check_draft_speculation(model_and_params):
    """Phase 5, draft-model speculation: the bf16 checkpoint on a bf16
    cache serves TRAINED_PROMPTS for 32 tokens with speculation off, then
    with k 8 drafts from the model itself (self-draft) and from a seeded
    random model of the same shape (weak draft). Each speculative run's
    tokens must be the run without speculation's, token for token, with
    drafts proposed and verified and the draft model's forward launched
    (``flash_fwd``) and the verify (``paged_prefill``); the acceptance
    rate is logged."""
    import torch

    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine
    from tpu_flash_torch.ops import build

    model, params = model_and_params
    weak = model.init(torch.Generator(device=model.device)
                      .manual_seed(SEED + 99))
    cfg = EngineConfig(
        max_batch_size=4, max_seq_len=128, prefill_chunk=32,
        cache=CacheConfig(page_size=32, num_pages=14, max_pages_per_seq=4,
                          kv_dtype="bfloat16", recent_window=0))

    def serve(spec_k, draft):
        eng = InferenceEngine(model, params, cfg, draft=draft)
        eng.speculation_k = spec_k
        ids = [eng.submit(list(p), 32) for p in TRAINED_PROMPTS]
        eng.run()
        eng.close()
        return ([eng.outputs[i] for i in ids], eng.speculation_stats(),
                eng.metrics.route_counts())

    want, _, _ = serve(0, None)
    results = []
    for name, draft in (("self", (model, params)), ("weak", (model, weak))):
        build.reset_launch_counts()
        got, spec, routes = serve(8, draft)
        rec = dict(draft=name, match=token_match(got, want),
                   acceptance_rate=spec["acceptance_rate"], speculation=spec,
                   routes=routes, launches=build.launch_counts())
        log("trained_draft_model", **rec)
        if got != want:
            raise AssertionError(f"{name}-draft speculation changed the "
                                 f"greedy tokens: {rec}")
        if not (spec["proposed"] and routes["speculative"]):
            raise AssertionError(f"{name} draft never verified: {rec}")
        require_launches(rec, ["flash_fwd", "paged_prefill"])
        results.append(rec)
    return results


# -- phase 6: training at full width ------------------------------------------

TRAIN_LAYERS = 4       # of LLAMA3_8B's 32: the only cut
TRAIN_TOKENS = (4, 2049)  # 4 rows of 2048 trained positions
TRAIN_STEPS = 6
TRAIN_LR = 1e-4
# The first step's gradients on the kernels against those on the plain
# versions, per tensor: ||g_kernel - g_plain|| / ||g_plain||. The two
# differ only in attention's f32 summation order, but that flips bf16
# roundings (o, dS, each layer's activations, and the bf16 logits, where
# one flip moves a token's softmax weight by up to 1% at these logits'
# magnitude), and each flip spreads through 4 layers of bf16 matmuls.
# On the CPU, tiny-byte-llama's bf16 gradients in JAX and in the port
# differ by 1.4-2.6% per tensor for the same reason; the bar is 5%. The
# control, the plain gradients of another seeded batch, must miss it.
TRAIN_GRAD_REL_TOL = 0.05


def train_model(dev):
    """LLAMA3_8B at full width cut to TRAIN_LAYERS layers, with seeded
    random bf16 weights made on ``dev``."""
    import dataclasses

    import torch

    from tpu_flash_torch.models import LLAMA3_8B, FlashTransformer

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=TRAIN_LAYERS)
    model = FlashTransformer(cfg, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(SEED))


def train_batch(dev, vocab_size, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab_size, TRAIN_TOKENS, generator=g,
                         device=dev)


def first_step_grads(model, params, tokens):
    """(loss, every parameter's gradient) of one backward pass, the
    leaves' ``.grad`` cleared so that dropping the list frees them."""
    from tpu_flash_torch.parallel import loss_and_grads, param_leaves

    loss, grads = loss_and_grads(model, params, tokens)
    for w in param_leaves(params):
        w.grad = None
    return float(loss), grads


def check_training(dev):
    """Phase 6: gradients against the plain versions, then AdamW steps
    on one repeated batch."""
    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.parallel import (make_train_step, param_leaves,
                                          param_names)

    t0 = time.perf_counter()
    model, params = train_model(dev)
    cfg = model.config
    n_params = sum(w.numel() for w in param_leaves(params))
    batch = train_batch(dev, cfg.vocab_size, SEED + 6)
    other = train_batch(dev, cfg.vocab_size, SEED + 7)
    log("train_weights", model=cfg.name, layers=cfg.num_layers,
        cut=f"depth {cfg.num_layers} of 32 layers; widths uncut",
        params=n_params, batch=list(TRAIN_TOKENS),
        init_s=time.perf_counter() - t0)

    with plain_versions():
        loss_plain, plain = first_step_grads(model, params, batch)
        _, control = first_step_grads(model, params, other)
    loss_kernel, kernel = first_step_grads(model, params, batch)
    rel, ctrl = [], []
    for a, r, c in zip(kernel, plain, control):
        norm = float(r.float().norm())
        rel.append(float((a.float() - r.float()).norm()) / norm)
        ctrl.append(float((c.float() - r.float()).norm()) / norm)
    names = param_names(params)
    worst = max(range(len(rel)), key=rel.__getitem__)
    rec = dict(loss_kernel=loss_kernel, loss_plain=loss_plain,
               tol=TRAIN_GRAD_REL_TOL, max_rel=rel[worst],
               worst=names[worst], min_control_rel=min(ctrl),
               rel={n: r for n, r in zip(names, rel)})
    log("train_first_step_grads", **rec)
    del kernel, plain, control
    torch.cuda.empty_cache()
    if not (max(rel) <= TRAIN_GRAD_REL_TOL
            and min(ctrl) > TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"first-step gradients off the plain path, "
                             f"or a control within the bar: {rec}")

    opt = torch.optim.AdamW(param_leaves(params), lr=TRAIN_LR,
                            weight_decay=0.01)
    step = make_train_step(model, optimizer=opt, max_grad_norm=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(loss))
    launches = build.launch_counts()
    positions = TRAIN_TOKENS[0] * (TRAIN_TOKENS[1] - 1)
    rec = dict(gpu=gpu_query(), losses=losses, step_s=secs,
               train_tok_per_s=positions * (TRAIN_STEPS - 1)
               / sum(secs[1:]),
               tokens_per_step=positions, lr=TRAIN_LR, launches=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("train_steps", **rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    require_launches(rec, ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"])
    del params, opt, step
    torch.cuda.empty_cache()
    return [rec, check_mesh_training(dev, model, batch, other, rec)]


# (g) The mesh train step (parallel/train.py, make_train_step(model, mesh))
# on a fresh NCCL group of one, at phase 6's model and batch: its first
# step's loss within TRAINED_LOSS_TOL (0.02 nats) and every gradient
# within TRAIN_GRAD_REL_TOL of the one-device step's on the same weights
# (the two differ in the sequence the model runs, 2049 positions with the
# last masked against 2048, and so in cuBLAS's algorithms and the bf16
# roundings after them), the control (another batch's one-device
# gradients) missing; MESH_RESUME_AT AdamW steps, a sharded
# TrainCheckpointManager checkpoint, MESH_STEPS - MESH_RESUME_AT more;
# then the checkpoint restored into a fresh shard and optimizer and the
# same steps again, every loss bit for bit.
MESH_STEPS = 4
MESH_RESUME_AT = 2


def check_mesh_training(dev, model, batch, other, one_device):
    """(g) The DP x TP x SP step at a mesh of one on the card."""
    import functools

    import torch
    import torch.distributed as dist

    from tpu_flash_torch.checkpoint import TrainCheckpointManager
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.parallel import (make_train_step, param_leaves,
                                          param_names)

    t_phase = time.perf_counter()
    mesh = check_group_of_one()
    try:
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        loss_one, want = first_step_grads(model, params, batch)
        _, control = first_step_grads(model, params, other)
        shard, build_step = make_train_step(
            model, mesh, make_optimizer=functools.partial(
                torch.optim.AdamW, lr=TRAIN_LR, weight_decay=0.01))
        local = shard(params)
        names = param_names(params)
        del params
        step = build_step(local)
        build.reset_launch_counts()
        losses, secs = [], []

        def timed_step(st, p):
            t = time.perf_counter()
            loss = float(st(p, batch))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            return loss

        losses.append(timed_step(step, local))
        rel, ctrl = [], []
        for w, r, c in zip(param_leaves(local), want, control):
            norm = float(r.float().norm())
            rel.append(float((w.grad.float() - r.float()).norm()) / norm)
            ctrl.append(float((c.float() - r.float()).norm()) / norm)
        del want, control
        worst = max(range(len(rel)), key=rel.__getitem__)
        losses += [timed_step(step, local)
                   for _ in range(MESH_RESUME_AT - 1)]
        launches = build.launch_counts()
        with build_tempdir("mesh-ckpt-") as tmp:
            with TrainCheckpointManager(tmp, max_to_keep=1) as mgr:
                t0 = time.perf_counter()
                mgr.save(MESH_RESUME_AT, local, step.optimizer.state_dict(),
                         mesh=mesh)
                torch.cuda.synchronize()
                save_s = time.perf_counter() - t0
                size = dir_bytes(tmp)
                losses += [timed_step(step, local)
                           for _ in range(MESH_STEPS - MESH_RESUME_AT)]
                del local, step
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                at, rp, ros = mgr.restore_latest(device=dev, mesh=mesh)
                resumed_step = build_step(rp)
                resumed_step.optimizer.load_state_dict(ros)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
        resumed = [float(resumed_step(rp, batch))
                   for _ in range(MESH_STEPS - MESH_RESUME_AT)]
        del rp, ros, resumed_step
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    positions = TRAIN_TOKENS[0] * (TRAIN_TOKENS[1] - 1)
    timed = secs[1:]
    rec = dict(gpu=gpu_query(), mesh=list(mesh.shape), losses=losses,
               first_loss_one_device=loss_one,
               first_loss_diff=abs(losses[0] - loss_one),
               loss_tol=TRAINED_LOSS_TOL, grad_tol=TRAIN_GRAD_REL_TOL,
               max_rel=rel[worst], worst=names[worst],
               min_control_rel=min(ctrl), step_s=secs,
               train_tok_per_s=positions * len(timed) / sum(timed),
               one_device_train_tok_per_s=one_device["train_tok_per_s"],
               resumed_at=at, resumed_losses=resumed,
               bit_for_bit=resumed == losses[MESH_RESUME_AT:],
               checkpoint_bytes=size, save_s=save_s, restore_s=restore_s,
               launches=launches, wall_s=time.perf_counter() - t_phase)
    log("train_mesh", **rec)
    if not (rec["first_loss_diff"] <= TRAINED_LOSS_TOL
            and max(rel) <= TRAIN_GRAD_REL_TOL
            and min(ctrl) > TRAIN_GRAD_REL_TOL
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"the mesh step off the one-device step, or "
                             f"a control within the bar: {rec}")
    if not (rec["bit_for_bit"] and at == MESH_RESUME_AT):
        raise AssertionError(f"resumed mesh training off the uninterrupted "
                             f"losses: {rec}")
    require_launches(rec, ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"])
    return rec


# -- phase 7: the trained checkpoint, trained ---------------------------------

# Kernel and plain paths on the bf16 checkpoint differ only in
# attention's summation order: a bf16 flip moves a logit by one ulp (1/16
# at its magnitude), which moves a mean loss over 4096 bytes by well
# under 1e-3; through 10 AdamW steps, whose first updates are about lr
# times the gradient's sign, only entries whose gradient sits within
# that noise of 0 can step apart. 0.02 nats (about 1% of the loss) bars
# each step's loss; the control, each kernel-path loss against the next
# step's plain-path loss (another batch), must miss it. This phase checks
# that the two paths train alike end to end, not the kernels' gradients:
# AdamW's early steps barely see a per-tensor factor on a gradient, so
# such a fault would pass here. Phase 3 (each kernel against its plain
# version) and phase 6 (every first-step gradient against the plain
# path's) are what would catch it.
TRAINED_LOSS_TOL = 0.02
TRAINED_STEPS = 10
TRAINED_LR = 3e-4  # checkpoints/tiny-byte-llama/train_meta.json
TRAINED_ROWS, TRAINED_LEN = 8, 513


def markdown_bytes() -> bytes:
    """The repo's own Markdown files (root level), concatenated."""
    names = sorted(n for n in os.listdir(REPO) if n.endswith(".md"))
    return b"".join(open(os.path.join(REPO, n), "rb").read() for n in names)


def markdown_batches(dev, n):
    """``n`` seeded batches of TRAINED_ROWS windows of TRAINED_LEN bytes,
    with segment ids or None: batch n // 2 packs two documents a row (the
    first 256 bytes of one window, the rest from another)."""
    import torch

    data = torch.frombuffer(bytearray(markdown_bytes()), dtype=torch.uint8)
    g = torch.Generator().manual_seed(SEED + 8)
    out = []
    for i in range(n):
        starts = torch.randint(0, len(data) - TRAINED_LEN, (TRAINED_ROWS,),
                               generator=g)
        rows = torch.stack([data[s:s + TRAINED_LEN] for s in starts]).long()
        seg = None
        if i == n // 2:
            rows[:, 256:] = rows.roll(1, dims=0)[:, 256:]
            seg = torch.zeros_like(rows)
            seg[:, 256:] = 1
            seg = seg.to(dev)
        out.append((rows.to(dev), seg))
    return out


def check_trained_training(dev):
    """Phase 7: the checkpoint's loss on the kernels and on the plain
    versions, then 10 AdamW steps on each path from the same weights."""
    import torch

    from tpu_flash_torch.checkpoint import load_hf_dir
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.parallel import make_train_step, param_leaves

    ckpt = os.path.join(REPO, "checkpoints", "tiny-byte-llama")
    batches = markdown_batches(dev, TRAINED_STEPS + 1)
    evals = {}
    for path in ("kernel", "plain"):
        model, params = load_hf_dir(ckpt, dtype="bfloat16", device=dev)
        ctx = plain_versions() if path == "plain" else contextlib.nullcontext()
        with ctx:
            with torch.no_grad():
                evals[path] = float(model.loss_fn(params, batches[-1][0]))
            opt = torch.optim.AdamW(param_leaves(params), lr=TRAINED_LR,
                                    weight_decay=0.01)
            step = make_train_step(model, optimizer=opt, max_grad_norm=1.0)
            build.reset_launch_counts()
            losses = [float(step(params, toks, seg))
                      for toks, seg in batches[:TRAINED_STEPS]]
            launches = build.launch_counts()
        evals[path + "_steps"] = losses
        evals[path + "_launches"] = launches
    diff = [abs(a - b) for a, b in zip(evals["kernel_steps"],
                                       evals["plain_steps"])]
    control = [abs(a - b) for a, b in zip(evals["kernel_steps"],
                                          evals["plain_steps"][1:])]
    resume = check_train_resume(dev, ckpt, batches, evals["kernel_steps"])
    rec = dict(eval_loss_kernel=evals["kernel"],
               eval_loss_plain=evals["plain"], ln_256=math.log(256),
               step_losses_kernel=evals["kernel_steps"],
               step_losses_plain=evals["plain_steps"],
               max_step_diff=max(diff), control_max_diff=max(control),
               tol=TRAINED_LOSS_TOL, lr=TRAINED_LR,
               launches=evals["kernel_launches"],
               batch=[TRAINED_ROWS, TRAINED_LEN],
               packed_step=TRAINED_STEPS // 2, resume=resume)
    log("trained_training", **rec)
    if not (abs(evals["kernel"] - evals["plain"]) <= TRAINED_LOSS_TOL
            and evals["kernel"] < 0.5 * math.log(256)):
        raise AssertionError(f"trained-checkpoint loss: {rec}")
    if not (max(diff) <= TRAINED_LOSS_TOL
            and max(control) > TRAINED_LOSS_TOL
            and all(math.isfinite(x) for x in evals["kernel_steps"])):
        raise AssertionError(f"training steps off the plain path: {rec}")
    require_launches(rec, ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"])
    if any(evals["plain_launches"].values()):
        raise AssertionError(f"the plain path launched a kernel: {rec}")
    if not resume["bit_for_bit"]:
        raise AssertionError(f"resumed training off the uninterrupted "
                             f"losses: {rec}")
    return rec


TRAINED_RESUME_AT = 4


def check_train_resume(dev, ckpt, batches, want):
    """Phase 7, resume: the kernel path's first TRAINED_RESUME_AT steps
    again from the checkpoint, a ``TrainCheckpointManager`` checkpoint of
    the params and the AdamW state (under build/, removed afterwards),
    both restored into fresh objects (weights loaded anew, a new
    optimizer), then the remaining steps. Every loss must be the
    uninterrupted kernel run's (``want``) bit for bit."""
    import torch

    from tpu_flash_torch.checkpoint import TrainCheckpointManager, load_hf_dir
    from tpu_flash_torch.parallel import make_train_step, param_leaves

    def trainer(params):
        opt = torch.optim.AdamW(param_leaves(params), lr=TRAINED_LR,
                                weight_decay=0.01)
        return opt, make_train_step(model, optimizer=opt, max_grad_norm=1.0)

    k = TRAINED_RESUME_AT
    model, params = load_hf_dir(ckpt, dtype="bfloat16", device=dev)
    opt, step = trainer(params)
    got = [float(step(params, toks, seg)) for toks, seg in batches[:k]]
    with build_tempdir("train-ckpt-") as tmp, \
            TrainCheckpointManager(tmp, max_to_keep=2) as mgr:
        t0 = time.perf_counter()
        mgr.save(k, params, opt.state_dict())
        save_s = time.perf_counter() - t0
        size = dir_bytes(tmp)
        del params, opt, step
        model, fresh = load_hf_dir(ckpt, dtype="bfloat16", device=dev)
        t0 = time.perf_counter()
        at, params, opt_state = mgr.restore_latest(like_params=fresh)
        restore_s = time.perf_counter() - t0
    opt, step = trainer(params)
    opt.load_state_dict(opt_state)
    got += [float(step(params, toks, seg))
            for toks, seg in batches[k:TRAINED_STEPS]]
    return dict(saved_after_step=at, checkpoint_bytes=size, save_s=save_s,
                restore_s=restore_s, losses=got,
                bit_for_bit=got == list(want))


# -- phase 8: the port's bench and the variant sweep --------------------------

# Calibration floor of the bench's differential timing (its --iters): the
# windows still grow to BENCH_WINDOW_S, so this cuts only the floor, not
# coverage.
BENCH_ITERS = 8
# Phase 8's differential timing (bench/suite.py::time_per_call): windows of
# at least BENCH_WINDOW_S seconds, each pair BENCH_REPEATS times, where the
# bench's CLI takes 0.15 s and 4. A depth cut that keeps the smoke within
# its time: every row still runs, its rate over a shorter window.
BENCH_WINDOW_S, BENCH_REPEATS = 0.05, 3
RATE_METRICS = ("tflops", "tokens_per_s", "us_per_chunk", "train_tflops",
                "decode_tokens_per_s", "device_decode_tokens_per_s")
BENCH_CONFIGS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]
# Config 9's gates (tests/test_quality.py): the in-ring report's prefix
# match against the bf16 cache.
QUALITY_GATES = {"int8": 0.95, "int4": 0.90, "fp8": 0.90}


@contextlib.contextmanager
def bench_windows():
    """The bench's time_per_call at BENCH_WINDOW_S and BENCH_REPEATS
    unless a caller gives its own (the bench modules look it up at call
    time)."""
    from tpu_flash_torch.bench import suite

    real = suite.time_per_call

    def short(fn, **kw):
        kw.setdefault("target_window", BENCH_WINDOW_S)
        kw.setdefault("repeats", BENCH_REPEATS)
        return real(fn, **kw)

    suite.time_per_call = short
    try:
        yield
    finally:
        suite.time_per_call = real


@contextlib.contextmanager
def recorded_greedy(calls):
    """Appends (kv_dtype, token lists) of every ``generate_greedy`` call
    (``bench/quality.py``) while the block runs."""
    from tpu_flash_torch.bench import quality

    real = quality.generate_greedy

    def spy(model, params, prompts, max_new_tokens, kv_dtype="bfloat16",
            **kw):
        out = real(model, params, prompts, max_new_tokens, kv_dtype, **kw)
        calls.append((kv_dtype, out))
        return out

    quality.generate_greedy = spy
    try:
        yield calls
    finally:
        quality.generate_greedy = real


def check_quality(rows, kernel_calls, dev):
    """Config 9 on the card: the gates of QUALITY_GATES on its in-ring
    rows, and every generate_greedy call's tokens equal to the same call
    on the plain versions (config 9 run again under plain_versions).

    The gates follow the JAX package's but pass by construction here: the
    in-ring contexts (8 prompt + 32 new tokens) sit under the default
    128-token ring, so paged attention reads almost nothing from the
    quantized pages. The check that covers the quantized tiers is the
    token equality with the plain versions over all 11 calls, the
    beyond-window report's (a 32-token ring) included."""
    from tpu_flash_torch.bench.__main__ import config9_quant_quality

    plain_calls = []
    with plain_versions(), recorded_greedy(plain_calls):
        config9_quant_quality(BENCH_ITERS, device=dev)
    differ = [i for i, (a, b) in enumerate(zip(kernel_calls, plain_calls))
              if a != b]
    in_ring = {r["name"].split()[2].removesuffix("-kv"): r["value"]
               for r in rows if r["config"] == 9 and "greedy" in r["name"]}
    missed = {dt: in_ring.get(dt) for dt, gate in QUALITY_GATES.items()
              if not in_ring.get(dt, 0.0) >= gate}
    rec = dict(calls=len(kernel_calls), plain_calls=len(plain_calls),
               differ_plain=[kernel_calls[i][0] for i in differ],
               gates=QUALITY_GATES, prefix_match=in_ring)
    log("bench_quality", **rec)
    if (missed or differ or not kernel_calls
            or len(kernel_calls) != len(plain_calls)):
        raise AssertionError(
            f"config 9: below its gates {missed}, tokens off the plain "
            f"versions' {rec['differ_plain']}")
    return rec


def check_bench(dev):
    """Phase 8: ``python -m tpu_flash_torch.bench --configs 1-12``
    in-process on the card, every row logged; it fails unless config 1's
    parity rows and config 3's int8 quantization-delta row pass their
    targets, every rate is finite and positive, config 9 meets its gates
    with the plain versions' tokens (``check_quality``), each config-10
    row's kernel time a step is below its wall time, and the configs
    launched their kernels. Then the debug entry point,
    ``attention_weights``, on config 1's shapes (P within
    DEBUG_WEIGHTS_TOL of the oracle's weights), and the variant sweep
    (``python -m tpu_flash_torch.bench.experiments``): every variant
    through the parity gate and timed. Launch counts are reset first, so
    they are this phase's alone (config 9's plain-version run launches
    none)."""
    import torch

    from tpu_flash_torch.bench import experiments
    from tpu_flash_torch.bench.__main__ import run_configs
    from tpu_flash_torch.ops import build

    build.reset_launch_counts()
    t0 = time.perf_counter()
    greedy, rows, config_s = [], [], {}
    with recorded_greedy(greedy), bench_windows():
        for c in BENCH_CONFIGS:
            t = time.perf_counter()
            rows += run_configs([c], iters=BENCH_ITERS, device=dev)
            torch.cuda.synchronize()
            config_s[c] = time.perf_counter() - t
        t = time.perf_counter()
        weights = [debug_weights_row(dev, *shape) for shape in DEBUG_SHAPES]
        sweep = experiments.sweep(device=dev, iters=BENCH_ITERS)
        torch.cuda.synchronize()
    rec = dict(rows=len(rows), variants=len(sweep),
               wall_s=time.perf_counter() - t0, config_s=config_s,
               weights_and_sweep_s=time.perf_counter() - t,
               launches=build.launch_counts(), debug_weights=weights)
    gpu = gpu_query()
    for r in rows:
        log("bench", gpu=gpu, **r)
    for r in sweep:
        log("variant_sweep", gpu=gpu, **r)
    log("bench_phase", **rec)
    missed = [r["name"] for r in rows + weights + sweep
              if "pass" in r and not r["pass"]]
    bad = [r["name"] for r in rows + sweep
           if r.get("metric") in RATE_METRICS + ("ms",)
           and not (math.isfinite(r["value"]) and r["value"] > 0)]
    slow = [r["name"] for r in rows if r["config"] == 10
            and not 0 < r["step_us"] < r["wall_step_us"]]
    configs = {r["config"] for r in rows}
    if (missed or bad or slow
            or len([r for r in rows if "pass" in r]) != 3
            or configs != set(BENCH_CONFIGS)
            or not all("value" in r for r in sweep)):
        raise AssertionError(
            f"bench: rows off target {missed}, rates not finite and "
            f"positive {bad}, kernel time not below wall {slow}, configs "
            f"{sorted(configs)}"
        )
    rec["quality"] = check_quality(rows, greedy, dev)
    require_launches(rec, ["flash_fwd", "flash_fwd_exact", "paged_decode",
                           "paged_prefill", "paged_decode:int4_mxu",
                           "flash_bwd_dkv", "flash_bwd_dq", "quant_fwd",
                           "quant_fwd:int8", "quant_fwd:fp8_native",
                           "quantize_rows", "attn_weights", "variant_fwd"])
    return rec


# Config 1's two parity shapes (b, h, s, d, causal), in f32.
DEBUG_SHAPES = ((1, 1, 128, 64, False), (2, 4, 384, 128, True))
DEBUG_WEIGHTS_TOL = 1e-5  # f32 P <= 1: the two sum in different orders


def debug_weights_row(dev, b, h, s, d, causal):
    """The debug entry point as a user checking a config 1 parity row
    would call it: ``attention_weights`` (the forward kernel's lse, then
    the weights kernel) against the oracle's weights."""
    import torch

    from tpu_flash_torch.core.reference import reference_attention
    from tpu_flash_torch.ops.flash import attention_weights

    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev)
               for _ in range(3))
    with torch.no_grad():
        _, w = attention_weights(q, k, v, causal=causal)
    _, want = reference_attention(q, k, v, causal=causal,
                                  return_weights=True)
    err = max_err(w, want)
    return dict(name=f"attention_weights b{b} h{h} s{s} d{d} float32"
                f"{' causal' if causal else ''}", max_abs_err=err,
                target=DEBUG_WEIGHTS_TOL, **{"pass": err <= DEBUG_WEIGHTS_TOL})


# Phase 2's libraries with tensor-core instances: (kernel attribute of
# ops.build, the pattern of its kernel functions, the pattern of those
# that must run on the tensor cores, the instances of each (kernel, on
# the tensor cores) the source builds). A function's kernel is the
# pattern's first group, or the library's name. flash_fwd's tensor-core
# kernel has two builds a head width: for calls with rows that see no key
# and for the others. Every other instance
# must have no tensor-core instruction: flash_fwd's order-exact instances
# (the prefill tile over dense K/V: d 64, 128 and 256 in f32 and bf16,
# bf16 also at 16 rows a block), which flash_fwd_exact and f32 flash_fwd
# launch. The backward's and the weights kernel's f32 instances run on
# the tensor cores too (three-pass TF32: HMMA.1684.F32.TF32).
TC_LIBRARIES = {
    "flash_bwd": ("FLASH_BWD_DKV", r"flash_bwd_(dkv|dq)_kernel",
                  r"D(kv|q)Tiles", {("dkv", True): 6, ("dq", True): 6}),
    "attn_weights": ("ATTN_WEIGHTS", r"attn_weights_kernel",
                     r"attn_weights_kernel", {("attn_weights", True): 6}),
    "flash_fwd": ("FLASH_FWD", r"flash_fwd(?:_tc|_dense)?_kernel",
                  r"flash_fwd_tc_kernel",
                  {("flash_fwd", True): 6, ("flash_fwd", False): 9}),
    "variant_fwd": ("VARIANT_FWD", r"variant_fwd_kernel",
                    r"variant_fwd_kernel", {("variant_fwd", True): 20}),
    # K10: every instance on the tensor cores (quant_instances
    # checks which instructions each mode needs).
    "quant_fwd": ("QUANT_FWD", r"quant_(fwd|onepass)_kernel", r"quant_",
                  {("fwd", True): 18, ("onepass", True): 6}),
    # The order-exact prefill tile (prefill_tile.cuh): no instance of K5
    # or K6 may hold a tensor-core instruction.
    "paged_prefill": ("PAGED_PREFILL", r"paged_prefill_kernel", r"(?!)",
                      {("paged_prefill", False): 30}),
    "ragged_prefill": ("RAGGED_PREFILL", r"ragged_prefill_kernel", r"(?!)",
                       {("ragged_prefill", False): 4}),
}


def prefill_occupancy():
    """Shared memory and blocks an SM (the CUDA occupancy calculator on
    the built kernels) of every instance of the order-exact prefill tile
    that a call can take: K6 by dtype and head width, K5 by q dtype, page
    dtype, head width and rows a block (16 for bf16 verify-sized calls),
    the forward's dense instances by dtype, head width and rows a block.
    Raises if an instance at d <= 128 fits fewer than two blocks an
    SM."""
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash.paged_prefill import (
        PAGE_KINDS,
        tile_occupancy,
    )

    rows = []

    def query(kernel, *args):
        smem, blocks = tile_occupancy(kernel, args)
        return dict(smem_bytes=smem, blocks_per_sm=blocks)

    for dt, dname in enumerate(("float32", "bfloat16")):
        for d in (128, 256):
            rows.append(dict(kernel="ragged_prefill", q=dname, d=d, rows=64,
                             **query(build.RAGGED_PREFILL, dt, d)))
    for dt, dname in enumerate(("float32", "bfloat16")):
        for kind, pk in PAGE_KINDS.items():
            for d in (128, 256):
                for r in (64, 16) if dname == "bfloat16" else (64,):
                    rows.append(dict(kernel="paged_prefill", q=dname,
                                     pages=kind, d=d, rows=r,
                                     **query(build.PAGED_PREFILL, dt, pk, d,
                                             r)))
    for dt, dname in enumerate(("float32", "bfloat16")):
        for d in (64, 128, 256):
            for r in (64, 16) if dname == "bfloat16" else (64,):
                rows.append(dict(kernel="flash_fwd_exact", q=dname, d=d,
                                 rows=r, **query(build.FLASH_FWD_EXACT, dt,
                                                 d, r)))
    thin = [r for r in rows if r["d"] <= 128 and r["blocks_per_sm"] < 2]
    if thin:
        raise AssertionError(
            f"fewer than two blocks an SM at d <= 128: {thin}")
    return rows


# Phase 2's shapes for K4's occupancy query, by head width: (q heads, kv
# heads, tokens a page table holds = the kv block, ring) as phases 3 and 4
# call it: Llama-3-8B at the serving layout, Gemma-2-9B at 8192 tokens.
DECODE_SHAPES = {128: (32, 8, 2048, 128), 256: (16, 8, 4096, 128)}
DECODE_INSTANCES = 44  # 2 q dtypes x 11 (K, V) tier pairs x 2 widths


def decode_instances():
    """Each instance of the paged decode kernel (K4): its registers and
    spill bytes (nvcc's -Xptxas -v log), and at DECODE_SHAPES (batch 8)
    with the slices the wrapper picks there its shared memory
    a block, blocks an SM and clusters the card holds at once (the CUDA
    occupancy calculator).
    Raises if the library does not hold its 44 instances or one of them
    fits no cluster."""
    import re

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.decode import paged as dp

    import torch

    names = {v: k for k, v in dp.TIERS.items()}
    funcs, cur = {}, None
    for ln in build.PAGED_DECODE.build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = funcs.setdefault(m[1], {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    rows = []
    for name, info in sorted(funcs.items()):
        m = re.search(r"paged_decode_kernelI(f|13__nv_bfloat16)Li(\d+)ELi"
                      r"(\d+)ELi(\d+)E", name)
        if not m:
            continue
        q, kt, vt, d = int(m[1] != "f"), int(m[2]), int(m[3]), int(m[4])
        hq, hkv, tokens, ring = DECODE_SHAPES[d]
        slices = dp.launch_slices(
            torch.empty(8, hq, d, device="cuda",
                        dtype=(torch.float32, torch.bfloat16)[q]),
            names[kt], names[vt], hkv, 128, tokens // 128, tokens, ring)
        smem, blocks, clusters = dp.decode_occupancy(
            q, kt, vt, hq, hkv, 128, tokens // 128, tokens, ring, d, slices,
            8)
        rows.append(dict(q=("float32", "bfloat16")[q], k_tier=names[kt],
                         v_tier=names[vt], d=d, **info, slices=slices,
                         smem_bytes=smem,
                         blocks_per_sm=blocks, clusters=clusters))
    if len(rows) != DECODE_INSTANCES or any(r["clusters"] < 1 for r in rows):
        raise AssertionError(
            f"paged_decode: {len(rows)} instances (want "
            f"{DECODE_INSTANCES}), or one fits no cluster: {rows}")
    return rows


def tc_instances(lib):
    """Each kernel function of one of TC_LIBRARIES' built libraries: its
    dtype, registers and spill bytes (nvcc's -Xptxas -v log) and its
    tensor-core instructions (HMMA, HGMMA, IMMA) in the SASS (cuobjdump;
    c++filt for readable names only). Raises without cuobjdump, if the
    library does not hold the instances it should, or if an instance
    that must run on the tensor cores has no tensor-core instruction or
    another has any."""
    import re
    import shutil

    from tpu_flash_torch.ops import build

    attr, func_re, tc_re, want = TC_LIBRARIES[lib]
    k = getattr(build, attr)
    funcs, cur = {}, None
    for ln in k.build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = funcs.setdefault(m[1], {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError(f"{lib}: no cuobjdump to read the SASS")
    sass, cur = {}, None
    dump = subprocess.run([tool, "-sass", str(k.library_path())],
                          capture_output=True, text=True, check=True)
    for ln in dump.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = sass.setdefault(m[1], dict(hmma=0, hgmma=0, imma=0))
        elif cur is not None:
            cur["hmma"] += len(re.findall(r"\bHMMA\b", ln))
            cur["hgmma"] += len(re.findall(r"\bHGMMA\b", ln))
            cur["imma"] += len(re.findall(r"\bIMMA\b", ln))
    names = sorted(n for n in set(funcs) | set(sass) if re.search(func_re, n))
    plain = names
    if shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    rows = []
    for name, readable in zip(names, plain):
        m = re.search(func_re, name)
        tc = bool(re.search(tc_re, name))
        row = dict(function=readable.replace("(anonymous namespace)::", ""),
                   kernel=m[1] if m.lastindex else lib,
                   dtype=instance_dtype(name, tc),
                   needs_tensor_cores=tc,
                   **funcs.get(name, {}),
                   **sass.get(name, dict(hmma=0, hgmma=0, imma=0)))
        row["tensor_cores"] = bool(row["hmma"] or row["hgmma"]
                                   or row["imma"])
        rows.append(row)
    count = {key: sum((r["kernel"], r["needs_tensor_cores"]) == key
                      for r in rows) for key in want}
    wrong = [r["function"] for r in rows
             if r["tensor_cores"] != r["needs_tensor_cores"]]
    if wrong or count != want or len(rows) != sum(want.values()):
        raise AssertionError(
            f"{lib}: instances without the tensor-core instructions they "
            f"need or with ones they must not have: {wrong}; instances of "
            f"each (kernel, on the tensor cores): {count}, built "
            f"{len(rows)}, want {want}")
    return rows


def instance_dtype(name, tc) -> str:
    """An instance's input dtype from its mangled name: bf16 where the
    name says so, f32 where it takes float (``If``) or the TF32 tiles,
    else bf16 for a tensor-core instance."""
    if "bfloat16" in name:
        return "bfloat16"
    if "tf32" in name or "IfLi" in name:
        return "float32"
    return "bfloat16" if tc else "float32"


QUANT_MODES = ("int8", "fp8", "fp8_native", "onepass")


def quant_instances():
    """Each K10 instance (csrc/quant_fwd.cu: d x mode x output dtype) with
    its registers, spills and tensor-core instructions (tc_instances) and
    its shared memory a block and blocks an SM (the CUDA occupancy
    calculator). Raises unless every instance holds IMMA (int8 scores,
    fp8 scores as exact int8 limb products, the staircase's P V) and
    every tiled one HMMA (P V in bf16)."""
    import re

    import torch

    from tpu_flash_torch.ops.flash.quantized import quant_occupancy

    rows, bad = [], []
    for r in tc_instances("quant_fwd"):
        # c++filt's names, or the mangled ones where it is missing.
        fn = r["function"]
        m = (re.search(r"quant_fwd_kernel<(\d+), (\d), (\w+)>", fn)
             or re.search(r"quant_fwd_kernelILi(\d+)ELi(\d)E(f|13__nv_bf)",
                          fn))
        if m:
            d, mode, out = int(m[1]), QUANT_MODES[int(m[2])], m[3]
        else:
            m = (re.search(r"quant_onepass_kernel<(\d+), (\w+)>", fn)
                 or re.search(r"quant_onepass_kernelILi(\d+)E(f|13__nv_bf)",
                              fn))
            d, mode, out = int(m[1]), "onepass", m[2]
        out = "float32" if out in ("float", "f") else "bfloat16"
        smem, blocks = quant_occupancy(mode, getattr(torch, out), d)
        row = dict(r, d=d, mode=mode, out=out, smem_bytes=smem,
                   blocks_per_sm=blocks,
                   dtype="fp8" if mode.startswith("fp8") else "int8")
        rows.append(row)
        if not r["imma"] or (mode != "onepass" and not r["hmma"]):
            bad.append(r["function"])
    if bad:
        raise AssertionError(f"quant_fwd: instances without the IMMA / HMMA "
                             f"their mode needs: {bad}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tpu_flash_torch.ops import build

    dev = "cuda"
    # Plain versions and references compute f32 products in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_query()
    walls, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        walls[name] = now - mark[0]
        mark[0] = now

    log("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", seconds=secs, wall_s=time.perf_counter() - t0,
        ptxas=[ln.strip() for k in build.KERNELS.values()
               for ln in k.build_log.splitlines() if "Used" in ln],
        **{f"{lib}_instances": (quant_instances() if lib == "quant_fwd"
                                else tc_instances(lib))
           for lib in TC_LIBRARIES},
        prefill_occupancy=prefill_occupancy(),
        decode_instances=decode_instances())
    lap("build")
    if "--trained-only" in sys.argv[1:]:
        check_trained(dev)  # phase 5 alone, to look into a greedy flip
        return 0
    summary = {**check_flash(dev),
               **check_flash_bwd(dev),
               **check_decode(dev),
               **check_paged_prefill(dev),
               "ragged_prefill": check_ragged(dev),
               "quant_fwd": check_quant_fwd(dev),
               "quantize_rows": check_quantize_rows(dev),
               "attn_weights": check_attn_weights(dev),
               "variant_fwd": check_variant(dev)}
    check_widths(dev, summary)
    check_flash_blind(dev, summary)
    check_flash_orphan(dev, summary)
    check_decode_wide_group(dev)
    lap("kernels")
    main_runs, shared = check_main_path(dev)
    lap("main_path_llama3_8b")
    main_runs += check_parallel(dev, **shared)
    del shared
    gc.collect()
    torch.cuda.empty_cache()
    lap("parallel")
    main_runs += check_gemma_path(dev)
    lap("main_path_gemma2_9b")
    check_trained(dev)
    lap("trained_model")
    main_runs += check_training(dev)
    lap("training")
    check_trained_training(dev)
    lap("trained_training")
    main_runs.append(check_bench(dev))
    lap("bench")
    log("phase_walls", seconds=walls, total_s=time.perf_counter() - START)
    # One row per kernel, and one per page tier of the two kernels that
    # serve several ("<kernel>:<tier>", launched under that tag).
    kernels = []
    for name, s in summary.items():
        k = build.KERNELS[name.split(":")[0]]
        kernels.append(dict(
            name=name, route="cuda",
            source=os.path.relpath(str(k.source), REPO),
            replaces=k.replaces,
            launches=sum(r["launches"].get(name, 0) for r in main_runs),
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            **{x: y for x, y in s.items()
               if x.startswith(("whole_", "d256_", "d64_", "fastest_",
                                "fp32_", "call_", "warm_"))},
        ))
    print(gpu_query(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
