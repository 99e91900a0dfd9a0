#!/usr/bin/env python3
"""Chip smoke test of the tpu_flash_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; it needs no JAX and no
network. Phases, one JSON line each:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from tpu_flash_torch/csrc (one nvcc per
     source, all started together), with the build seconds;
  3. kernels: each kernel against its plain PyTorch version on the card
     at the main path's shapes, with times, bounds and a library
     yardstick: the forward (segment ids included), the backward pair
     (dK/dV and dQ) at the training shape, decode over every page tier
     (bf16, int8, int4, int4g32, k8v4, fp8; int8_mxu and fp8_native on
     and off), paged prefill over bf16, int8, int4 and fp8 pages, ragged
     prefill;
  4. main path: Llama-3-8B geometry at full width (all 32 layers, seeded
     random bf16 weights made on the card) served by the port's engine at
     its default routing (paged prefill, fused mixed steps, speculation
     k 8): 8 requests x 32 greedy tokens on an int8 cache with the recent
     ring and on a bf16 cache; the same two with paged_prefill=False
     (gathered history, the ragged kernel); the int4, fp8, int4g32 and
     k8v4 tiers with no layout fields (the engine's auto layout, printed);
     and 8 prompts of 1024 tokens built so that prompt lookup drafts,
     served for 16 tokens through speculative verify. Launch counters
     (per kernel and per page tier) reset before each run;
  5. trained model: checkpoints/tiny-byte-llama served at the engine's
     defaults on every cache tier, and a staggered two-request scenario
     that reaches every route (int8, int4, fp8); the int8 runs again with
     paged_prefill=False; each run's greedy text against the same engine
     on the plain versions (token for token; every kernel call also held
     against its plain version on the same inputs, decode to the bit),
     and each tier's greedy match against the bf16 cache's tokens;
  6. training at full width: Llama-3-8B widths cut to 4 of its 32 layers
     (the only cut), seeded random bf16 weights made on the card, batch
     4 x 2048 tokens, AdamW with a norm clip for 6 steps on one repeated
     seeded batch: loss per step, train tok/s, the first step's
     gradients against the plain versions' (and a control batch's);
  7. the trained checkpoint: its loss over windows of the repo's own
     Markdown on the kernels and on the plain versions, then 10 AdamW
     steps on each path from the same weights and batches (one batch
     packed with segment ids), step losses compared.

Then the nvidia-smi line, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. Without CUDA it exits 2 at once.
``--trained-only`` runs phases 1, 2 and 5 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCALE = 128 ** -0.5
PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12, "fp8": 1979e12,
                  "float32": 67e12}
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


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


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


def raise_if_failed(kernel: str, rows) -> None:
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(
            f"{kernel}: off its plain version, or a control within the "
            f"bar, in {bad}"
        )


# -- phase 3: each kernel against its plain version --------------------------


def flash_cases(dev):
    """(name, q, k, v, kwargs, control kwargs) at the main path's prefill
    shapes: hq 32, hkv 8, d 128, bf16. The control drops the case's
    option."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(b, sq, skv):
        def rn(*s):
            return torch.randn(*s, generator=g, device=dev).bfloat16()

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
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    return bound(nbytes, ops, "bfloat16")


def check_flash(dev):
    import torch

    from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain

    scale = 128 ** -0.5
    rows = []
    for name, q, k, v, kw, control in flash_cases(dev):
        out = flash_fwd(q, k, v, sm_scale=scale, **kw)
        torch.cuda.synchronize()
        ref = flash_fwd_plain(q, k, v, sm_scale=scale, **kw)
        off = max_err(out, flash_fwd_plain(q, k, v, sm_scale=scale,
                                           **control))
        ms = time_ms(lambda: flash_fwd(q, k, v, sm_scale=scale, **kw), 10)
        plain_ms = time_ms(
            lambda: flash_fwd_plain(q, k, v, sm_scale=scale, **kw), 3
        )
        bound_ms, bound_by = flash_bound(q, k, kw)
        row = dict(case=name, shape=list(q.shape), kv_len=k.shape[2],
                   control={k_: str(v_) for k_, v_ in control.items()},
                   **agreement(out, ref, off), ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if name == "prompt_causal":
            row["library_ms"] = sdpa_ms(q, k, v)
        elif name == "chunk_q_offset":
            row["library_ms"] = sdpa_ms(q, k, v, mask=attention_mask(
                q.shape[0], q.shape[2], k.shape[2], kw))
        rows.append(row)
        log("kernel_vs_plain", kernel="flash_fwd", **row)
    raise_if_failed("flash_fwd", rows)
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def sdpa_ms(q, k, v, mask=None):
    """PyTorch's fused attention on the same inputs (causal, or under a
    boolean ``mask``): a yardstick only, never called by the port."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
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

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args)
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


def bwd_bound(q, k, kw, which):
    """Least time of one backward kernel: its inputs read once (q, dO,
    k, v, lse and di) and the function's outputs written once (dK and dV
    per kv head, as the backward returns them, or dQ), against its
    products over the live pairs: S, dP, dV, dK (8 d FLOPs a pair) for
    dK/dV, S, dP, dQ (6 d) for dQ."""
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
    return bound(nbytes, ops, str(q.dtype).removeprefix("torch."))


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
    kernels against the plain version, each within its own bar, and the
    control (the plain version without the case's option) outside it. o
    and lse come from the plain forward for both sides. The sinks case
    also holds the autograd path's dsinks (kernels) against the plain
    path's."""
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
        ref = bw.flash_bwd_plain(*args, sm_scale=SCALE, **bkw)
        cargs, ckw = residuals(q, k, v, do, control)
        off = bw.flash_bwd_plain(*cargs, sm_scale=SCALE, **ckw)
        grads = {}
        for gname, a, r, c in zip(("dq", "dk", "dv"), out, ref, off):
            # dV = P^T dO does not depend on an lse cotangent: no control.
            no_control = gname == "dv" and "dlse" in kw
            grads[gname] = agreement(a, r, None if no_control
                                     else max_err(a, c))
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
            *args, sm_scale=SCALE, part=w, **bkw), 2) for w in ms}
        bounds = {w: bwd_bound(q, k, bkw, w) for w in ms}
        # The pair as flash_bwd launches it, its plain version and PyTorch's
        # fused-attention backward: three times of the whole backward.
        whole = dict(ms=time_ms(run, 5), plain_ms=time_ms(
            lambda: bw.flash_bwd_plain(*args, sm_scale=SCALE, **bkw), 2),
            library_ms=sdpa_bwd_ms(q, k, v, do, kw))
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
            whole_library_ms=first["whole"]["library_ms"])
    return out


def decode_inputs(dev, kv_dtype, ring, ps=128):
    """The main path's decode shape: b 8, hq 32 / hkv 8, d 128, context
    2048 in ``ps``-token pages (128 as phase 4's explicit bf16/int8
    layout, 512 as the auto layout of the quantized tiers) out of 1 +
    160 * 128 / ps. ``kv_dtype`` is a cache tier (k8v4: int8 K, int4
    V)."""
    import torch

    from tpu_flash_torch.engine.cache import side_dtypes
    from tpu_flash_torch.ops.quant import quantize_pages

    g = torch.Generator(device=dev).manual_seed(SEED)
    b, hq, hkv, d = 8, 32, 8, 128
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


# Bytes one token of one kv head takes in the cache, per side: payload
# (4-bit tiers half a byte an element) and scales (an f32 per token, or
# int4g32's 2 * d/32 f32 (scale, zero) pairs).
SIDE_BYTES = {"bfloat16": 2 * 128, "int8": 128 + 4, "int4": 64 + 4,
              "int4g32": 64 + 8 * 4, "fp8": 128 + 4}
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
    per_tok = hkv * sum(SIDE_BYTES[t] for t in side_dtypes(kv_dtype))
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


# (case, kv dtype, page size, f32 q, kwargs, control). The control is the
# kwargs with the case's option dropped, a plain function, or a page
# transform that a kernel ignoring part of the tier's format would match
# (on V only where K would swamp it). The 4-bit and fp8 cases take the
# auto layout's 512-token pages and 128-token ring of phase 4.
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
        q, kp, vp, lengths, table, ring = decode_inputs(
            dev, kv_dtype, kw.pop("ring", 0), ps
        )
        if f32_q:
            q = q.float()
        kw.update(ring)

        def kernel(over=None, pages=(kp, vp)):
            args = dict(kw)
            if over is not None:
                args = dict(over)
                if args.pop("ring", 0):
                    args.update(ring)
            return dp.paged_attention(q, *pages, lengths, table, **args)

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
        row = dict(case=name, tier=decode_tag(kv_dtype, kw), batch=q.shape[0],
                   context=int(lengths[0]), page_size=ps,
                   q_dtype=str(q.dtype).removeprefix("torch."),
                   control=str(ctl), **agreement(out, ref, off),
                   ms=time_ms(kernel, 50), plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
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
    query, key) pair."""
    b, hq, q_len, d = q.shape
    hist = sum(min(off, window - 1) if window else off for off in offsets)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * hkv * q_len * d * q.element_size()
              + 2 * hist * kv_bytes_per_token + 4 * b)
    ops = 4.0 * hq * d * prefill_pairs(offsets, q_len, window)
    return bound(nbytes, ops, "bfloat16")


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
    the verify shape and each option, each against its plain version and
    a control that drops the case's option."""
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
    # 512 tokens (phase 4), the others phase 4's explicit 128.
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
    ]:
        ps = 512 if kv in ("int4", "fp8") else 128
        q, ck, cv, kp, vp, table = paged_prefill_inputs(dev, b, q_len,
                                                        hist_cap, kv, ps=ps)

        def run(offs=offsets, pages=(kp, vp), kw=kw):
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
                off = max_err(out, run(pages=(unscaled(kp), unscaled(vp))))
            else:
                off = max_err(out, run(
                    offs=control.get("offsets", offsets),
                    kw=control.get("kw", kw)))
        bound_ms, bound_by = prefill_bound(q, 8, offsets, kw.get("window"),
                                           8 * SIDE_BYTES[kv])
        row = dict(case=name, batch=b, q_len=q_len, hist_cap=hist_cap,
                   pages=kv, page_size=ps, offsets=offsets,
                   control=control if isinstance(control, str)
                   else {k_: str(v_) for k_, v_ in control.items()},
                   **agreement(out, ref, off), ms=time_ms(run, 10),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None)
        rows.append(row)
        log("kernel_vs_plain", kernel="paged_prefill", **row)
    raise_if_failed("paged_prefill", rows)
    out = {"paged_prefill": dict(
        rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))}
    for r in rows:
        if r["pages"] in ("int4", "fp8"):
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
    {0, 512, 1024, 1536} over [history padded to 1536 | chunk], and a
    window case."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from tpu_flash_torch.ops.flash import ragged

    rows = []
    q_len, hist_cap = 512, 1536
    for name, offsets, kw, control in [
        ("mixed_offsets", [0, 512, 1024, 1536], {},
         dict(offsets=[1536] * 4)),
        ("window", [0, 512, 1024, 1536], dict(window=256), dict(kw={})),
    ]:
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        b = len(offsets)
        q = torch.randn(b, 32, q_len, 128, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, 8, hist_cap + q_len, 128, generator=g,
                            device=dev).bfloat16() for _ in range(2))

        def run(offs=offsets, kw=kw):
            o = torch.tensor(offs, dtype=torch.int32, device=dev)
            return ragged.flash_attention_ragged(q, k, v, o,
                                                 hist_cap=hist_cap, **kw)

        out = run()
        torch.cuda.synchronize()
        with plain_versions():
            ref = run()
            plain_ms = time_ms(run, 3)
            off = max_err(out, run(offs=control.get("offsets", offsets),
                                   kw=control.get("kw", kw)))
        bound_ms, bound_by = prefill_bound(q, 8, offsets, kw.get("window"),
                                           8 * 128 * 2)
        mask = ragged_mask(offsets, q_len, hist_cap, kw.get("window"), dev)
        try:
            sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
            library_ms = time_ms(
                lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), 10)
        except TypeError:  # PyTorch without enable_gqa
            library_ms = None
        row = dict(case=name, batch=b, q_len=q_len, hist_cap=hist_cap,
                   offsets=offsets,
                   control={k_: str(v_) for k_, v_ in control.items()},
                   **agreement(out, ref, off), ms=time_ms(run, 10),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        rows.append(row)
        log("kernel_vs_plain", kernel="ragged_prefill", **row)
    raise_if_failed("ragged_prefill", rows)
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def kernel_entries():
    """Each kernel's CUDA entry that the port's wrappers call, by kernel
    name: (module, attribute, plain version of the same signature)."""
    from tpu_flash_torch.ops.decode import paged
    from tpu_flash_torch.ops.flash import (api, backward, forward,
                                           paged_prefill, ragged)

    return {
        "flash_fwd": (api, "flash_fwd", forward.flash_fwd_plain),
        "flash_bwd": (api, "flash_bwd", backward.flash_bwd_plain),
        "paged_decode": (paged, "_paged_decode_cuda",
                         paged.paged_decode_plain),
        "paged_prefill": (paged_prefill, "_paged_prefill_cuda",
                          paged_prefill.paged_prefill_plain),
        "ragged_prefill": (ragged, "_ragged_prefill_cuda",
                           ragged.ragged_prefill_plain),
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


def main_path_engine(model, params, kv_dtype, ring, prompts, **config):
    """The main path's engine at its default routing (``config`` overrides
    EngineConfig fields), warmed up by one short request so that
    CUDA/cuBLAS initialisation and allocator growth stay out of timed
    runs. ``ring`` None leaves the cache layout to the engine's auto
    policy; otherwise 128-token pages and that ring."""
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    layout = {} if ring is None else dict(
        page_size=128, num_pages=161, max_pages_per_seq=16,
        recent_window=ring)
    cfg = EngineConfig(
        max_batch_size=8, max_seq_len=2048, prefill_chunk=512,
        cache=CacheConfig(kv_dtype=kv_dtype, **layout), **config,
    )
    eng = InferenceEngine(model, params, cfg)
    eng.submit(prompts[0][:64], 2)
    eng.run()
    return eng


PREFILL_ROUTES = ("prefill_group", "prefill_ragged", "fused")
DECODE_ROUTES = ("decode", "speculative")


def serve_main(model, params, kv_dtype, ring, prompts, new_tokens, *,
               check_logits=True, **config):
    """Serve ``prompts`` on the port's engine; returns the phase record.

    prefill_tok_per_s: prompt tokens over the time spent in prefill
    dispatches (same-stage groups and ragged steps, fused decode rows
    included); decode_tok_per_s: tokens from decode calls (bursts and
    speculative steps) over the time spent in them. The engine's metrics
    time each dispatch between device synchronisations and count them by
    route; the first token of each request comes from its prefill."""
    import torch

    from tpu_flash_torch.engine.metrics import EngineMetrics
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    eng = main_path_engine(model, params, kv_dtype, ring, prompts, **config)
    first = {}
    impl = eng._chunked_prefill_impl

    def capture(hist_len, tokens, table_rows, n_valids, slots):
        last, finite = impl(hist_len, tokens, table_rows, n_valids, slots)
        if not first:
            first.update(tokens=tokens.clone(), n_valids=n_valids.clone(),
                         last=last.clone())
        return last, finite

    eng._chunked_prefill_impl = capture
    eng.metrics = m = EngineMetrics(sync_dispatches=True)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    ids = [eng.submit(p, new_tokens) for p in prompts]
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    )
    eng.close()
    if not check_logits:
        return rec, out
    # First step's last-position logits against a forward through the
    # plain versions on the card (same weights, same tokens).
    with torch.no_grad():
        ref = model.forward(
            params, first["tokens"],
            attention_fn=lambda q, k, v: flash_fwd_plain(
                q, k, v, causal=True, sm_scale=q.shape[-1] ** -0.5
            ),
        )
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
    the int4, fp8, int4g32 and k8v4 tiers at the auto layout, and a
    speculative run."""
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
        for kv_dtype, ring, config in runs:
            rec, _ = serve_main(model, params, kv_dtype, ring, prompts, 32,
                                **config)
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
            require_launches(rec, ["flash_fwd", "paged_decode"] + (
                ["ragged_prefill"] if gathered else ["paged_prefill"]))
            if kv_dtype in AUTO_TIERS:
                require_launches(rec, [
                    f"paged_decode:{decode_tag(kv_dtype, {})}"] + (
                    [] if gathered else [f"paged_prefill:{kv_dtype}"]))
            if gathered and rec["launches"]["paged_prefill"]:
                raise AssertionError(f"paged history with paging off: {rec}")
            recs.append(rec)
        spec_prompts = speculation_prompts(model, params,
                                           LLAMA3_8B.vocab_size)
        rec, _ = serve_main(model, params, "bfloat16", 0, spec_prompts, 16,
                            check_logits=False)
        log("main_path_speculation", gpu=gpu_query(), **rec)
        if rec["routes"]["speculative"] < 1:
            raise AssertionError(f"no speculative step: {rec}")
        require_launches(rec, ["paged_prefill"])
        recs.append(rec)
    del params
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
                    eng.metrics.route_counts(), eng.speculation_stats())

        shadow = {}
        with shadowed(shadow):
            got, lp_got, routes, spec = serve()
        with plain_versions():
            want, lp_want, _, _ = serve()
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
                   text=[bytes(t).decode("utf-8", "replace") for t in got])
        name = f"{kv_dtype} ring {ring} paged {paged} model {mdt}"
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
    rec = dict(eval_loss_kernel=evals["kernel"],
               eval_loss_plain=evals["plain"], ln_256=math.log(256),
               step_losses_kernel=evals["kernel_steps"],
               step_losses_plain=evals["plain_steps"],
               max_step_diff=max(diff), control_max_diff=max(control),
               tol=TRAINED_LOSS_TOL, lr=TRAINED_LR,
               launches=evals["kernel_launches"],
               batch=[TRAINED_ROWS, TRAINED_LEN],
               packed_step=TRAINED_STEPS // 2)
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
    return rec


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
    log("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", seconds=secs, wall_s=time.perf_counter() - t0,
        ptxas=[ln.strip() for k in build.KERNELS.values()
               for ln in k.build_log.splitlines() if "Used" in ln])
    if "--trained-only" in sys.argv[1:]:
        check_trained(dev)  # phase 5 alone, to look into a greedy flip
        return 0
    summary = {"flash_fwd": check_flash(dev),
               **check_flash_bwd(dev),
               **check_decode(dev),
               **check_paged_prefill(dev),
               "ragged_prefill": check_ragged(dev)}
    main_runs = check_main_path(dev)
    check_trained(dev)
    main_runs.append(check_training(dev))
    check_trained_training(dev)
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
            **{x: y for x, y in s.items() if x.startswith("whole_")},
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
