#!/usr/bin/env python3
"""Chip smoke test of the tpu_flash_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; it needs no JAX and no
network. Phases, one JSON line each:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the four CUDA kernels from tpu_flash_torch/csrc (one nvcc
     each, started together), with the build seconds;
  3. kernels: each kernel against its plain PyTorch version on the card
     at the main path's shapes, with times, bounds and a library
     yardstick;
  4. main path: Llama-3-8B geometry at full width (all 32 layers, seeded
     random bf16 weights made on the card) served by the port's engine at
     its default routing (paged prefill, fused mixed steps, speculation
     k 8): 8 requests x 32 greedy tokens on an int8 cache with the recent
     ring and on a bf16 cache; the same two with paged_prefill=False
     (gathered history, the ragged kernel); and 8 prompts of 1024 tokens
     built so that prompt lookup drafts, served for 16 tokens through
     speculative verify. Launch counters reset before each run;
  5. trained model: checkpoints/tiny-byte-llama served at the engine's
     defaults with bf16 and int8 caches, and a staggered two-request
     scenario that reaches every route; the int8 runs again with
     paged_prefill=False; each run's greedy text against the same engine
     on the plain versions.

Then the nvidia-smi line, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. Without CUDA it exits 2 at once.
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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
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
    return [
        ("prompt_causal", *qkv(4, 512, 512), causal, dict(causal=False)),
        ("chunk_q_offset", *qkv(4, 512, 1536),
         dict(causal=True, q_offset=1024), dict(causal=False)),
        ("window", *qkv(2, 512, 512), dict(causal=True, window=128), causal),
        ("softcap", *qkv(2, 512, 512), dict(causal=True, softcap=5.0),
         causal),
        ("sinks", *qkv(2, 512, 512), dict(causal=True, sinks=sinks), causal),
        ("alibi", *qkv(2, 512, 512), dict(causal=True, alibi=slopes), causal),
    ]


def flash_bound(q, k, kw):
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    off, win = kw.get("q_offset", 0), kw.get("window")
    pairs = 0
    for i in range(sq):
        hi = min(skv, i + off + 1) if kw.get("causal") else skv
        lo = max(0, i + off - win + 1) if win else 0
        pairs += hi - lo
    ops = 4.0 * b * hq * pairs * d
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
        rows.append(row)
        log("kernel_vs_plain", kernel="flash_fwd", **row)
    raise_if_failed("flash_fwd", rows)
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def sdpa_ms(q, k, v):
    """PyTorch's fused attention on the same causal whole-prompt inputs:
    a yardstick only, never called by the port."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    try:
        sdpa(q, k, v, is_causal=True, enable_gqa=True)
    except TypeError:  # PyTorch without enable_gqa
        return None
    return time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                   10)


def decode_inputs(dev, kv_dtype, ring):
    """The main path's decode shape: b 8, hq 32 / hkv 8, d 128, context
    2048 in 128-token pages (16 per sequence) out of 161."""
    import torch

    from tpu_flash_torch.ops.quant import quantize

    g = torch.Generator(device=dev).manual_seed(SEED)
    b, hq, hkv, d, ps, pps, n_pages = 8, 32, 8, 128, 128, 16, 161
    kp = torch.randn(hkv, n_pages, ps, d, generator=g, device=dev)
    vp = torch.randn(hkv, n_pages, ps, d, generator=g, device=dev)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    lengths = torch.full((b,), 2048, dtype=torch.int32, device=dev)
    q = torch.randn(b, hq, d, generator=g, device=dev).bfloat16()
    if kv_dtype == "int8":
        kp, vp = quantize(kp), quantize(vp)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    kw = {}
    if ring:
        r = torch.randn(2, b, hkv, ring, d, generator=g, device=dev)
        kw = dict(recent_k=r[0].bfloat16(), recent_v=r[1].bfloat16())
    return q, kp, vp, lengths, table, kw


def decode_bound(q, k, lengths, kw, kv_dtype):
    from tpu_flash_torch.ops.quant import QuantizedTensor

    b, hq, d = q.shape
    hkv = (k.values if isinstance(k, QuantizedTensor) else k).shape[0]
    w = kw["recent_k"].shape[2] if "recent_k" in kw else 0
    tokens = int(lengths.sum())
    page_tokens = sum(max(int(n) - w, 0) for n in lengths)
    per_tok = hkv * d * (1 if kv_dtype == "int8" else 2)
    if kv_dtype == "int8":
        per_tok += hkv * 4  # one f32 scale per token and kv head
    nbytes = (2 * page_tokens * per_tok + 2 * b * w * hkv * d * 2
              + 2 * q.numel() * q.element_size() + 8 * b + 4 * b * 16)
    ops = 4.0 * hq * d * tokens
    return bound(nbytes, ops, kv_dtype)


def without_p_cast(q, kp, vp, lengths, table, sm_scale, **_):
    """The bf16 tier's plain version without its bf16 P cast: the f32 tier
    on the same bf16 page values. With bf16-valued q and a power-of-two
    sm_scale the q rows are bf16 already, so P's cast is all that
    differs."""
    from tpu_flash_torch.ops.decode import paged as dp

    ppb = dp.pages_per_block(kp.shape[2], table.shape[1], True)
    return dp.paged_decode_plain(
        q, kp, vp, None, None, lengths, table, tier=dp.TIER_F32,
        sm_scale=sm_scale, pages_per_compute_block=ppb,
    )


def check_decode(dev):
    import torch

    from tpu_flash_torch.ops.decode import paged as dp

    rows = []
    # (case, kv dtype, f32 q, kwargs, control): the control is the
    # kwargs with the case's option dropped, or a plain function. A bf16
    # output cannot show the bf16 P cast (it moves outputs by under one
    # output ulp here), so "bf16_f32_q" shows it on an f32 output.
    for name, kv_dtype, f32_q, kw, control in [
        ("bf16", "bfloat16", False, {}, None),
        ("bf16_f32_q", "bfloat16", True, dict(sm_scale=0.125),
         without_p_cast),
        ("int8_mxu", "int8", False, dict(int8_mxu=True),
         dict(int8_mxu=False)),
        ("int8_exact", "int8", False, dict(int8_mxu=False),
         dict(int8_mxu=True)),
        ("int8_mxu_ring128", "int8", False, dict(int8_mxu=True, ring=128),
         dict(int8_mxu=True)),
    ]:
        kw = dict(kw)
        q, kp, vp, lengths, table, ring = decode_inputs(
            dev, kv_dtype, kw.pop("ring", 0)
        )
        if f32_q:
            q = q.float()
        kw.update(ring)

        def kernel(**over):
            return dp.paged_attention(q, kp, vp, lengths, table,
                                      **(over or kw))

        out = kernel()
        torch.cuda.synchronize()
        with plain_versions():
            ref = kernel()
            plain_ms = time_ms(kernel, 3)
            if callable(control):
                off = max_err(out, control(q, kp, vp, lengths, table, **kw))
            else:
                off = None if control is None else max_err(out,
                                                           kernel(**control))
        bound_ms, bound_by = decode_bound(q, kp, lengths, kw, kv_dtype)
        row = dict(case=name, batch=q.shape[0], context=int(lengths[0]),
                   q_dtype=str(q.dtype).removeprefix("torch."),
                   control=getattr(control, "__name__", control),
                   **agreement(out, ref, off), ms=time_ms(kernel, 50),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None)
        rows.append(row)
        log("kernel_vs_plain", kernel="paged_decode", **row)
    raise_if_failed("paged_decode", rows)
    primary = next(r for r in rows if r["case"] == "int8_mxu_ring128")
    return dict(primary, max_abs_err=max(r["max_abs_err"] for r in rows))


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


def paged_prefill_inputs(dev, b, q_len, hist_cap, kv_dtype, seed=SEED):
    """Chunk q/K/V (hq 32 / hkv 8, d 128, bf16) and 128-token pages
    holding hist_cap tokens per row (bf16, or int8 with per-token
    scales), with a random page table over 16 * b + 1 pages."""
    import torch

    from tpu_flash_torch.ops.quant import quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    ps, pps = 128, 16
    n_pages = pps * b + 1

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = rn(b, 32, q_len, 128).bfloat16()
    ck, cv = rn(b, 8, q_len, 128).bfloat16(), rn(b, 8, q_len, 128).bfloat16()
    kp, vp = rn(8, n_pages, ps, 128), rn(8, n_pages, ps, 128)
    if kv_dtype == "int8":
        kp, vp = quantize(kp), quantize(vp)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    return q, ck, cv, kp, vp, table


def check_paged_prefill(dev):
    """K5 at the main path's shapes: chunks at history 1024, mixed stages,
    the verify shape and each option, each against its plain version and
    a control that drops the case's option."""
    import torch

    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.quant import QuantizedTensor

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    # Scores have std ~1 here: softcap 5 bends the largest, sinks near
    # log(kv_len) + 1 weigh about as much as all the keys.
    sinks = (math.log(1536) + 1.0
             + 0.5 * torch.randn(32, generator=g, device=dev))
    slopes = torch.linspace(0.5, 0.004, 32, device=dev)
    rows = []
    # (case, b, q_len, hist_cap, pages, offsets, kwargs, control): the
    # control is kwargs/offsets overrides, or "unscaled" (int8 pages
    # without their scales).
    verify_lens = [1100 + 100 * i for i in range(8)]
    for name, b, q_len, hist_cap, kv, offsets, kw, control in [
        ("chunk_bf16", 4, 512, 1024, "bfloat16", [1024] * 4, {},
         dict(offsets=[0] * 4)),
        ("chunk_int8", 4, 512, 1024, "int8", [1024] * 4, {}, "unscaled"),
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
        q, ck, cv, kp, vp, table = paged_prefill_inputs(dev, b, q_len,
                                                        hist_cap, kv)

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
                pages = tuple(QuantizedTensor(t.values,
                                              torch.ones_like(t.scales),
                                              "int8") for t in (kp, vp))
                off = max_err(out, run(pages=pages))
            else:
                off = max_err(out, run(
                    offs=control.get("offsets", offsets),
                    kw=control.get("kw", kw)))
        # Per token and all 8 kv heads: d payload bytes (+ an f32 scale
        # for int8 pages).
        per_tok = 8 * (128 + 4 if kv == "int8" else 2 * 128)
        bound_ms, bound_by = prefill_bound(q, 8, offsets, kw.get("window"),
                                           per_tok)
        row = dict(case=name, batch=b, q_len=q_len, hist_cap=hist_cap,
                   pages=kv, offsets=offsets,
                   control=control if isinstance(control, str)
                   else {k_: str(v_) for k_, v_ in control.items()},
                   **agreement(out, ref, off), ms=time_ms(run, 10),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None)
        rows.append(row)
        log("kernel_vs_plain", kernel="paged_prefill", **row)
    raise_if_failed("paged_prefill", rows)
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


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


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors through the plain PyTorch versions instead of
    the kernels, for the reference runs on the card (the wrappers
    themselves never do this)."""
    from tpu_flash_torch.ops.decode import paged
    from tpu_flash_torch.ops.flash import api, forward, paged_prefill, ragged

    saved = (api.flash_fwd, paged._paged_decode_cuda,
             paged_prefill._paged_prefill_cuda, ragged._ragged_prefill_cuda)
    api.flash_fwd = forward.flash_fwd_plain
    paged._paged_decode_cuda = paged.paged_decode_plain
    paged_prefill._paged_prefill_cuda = paged_prefill.paged_prefill_plain
    ragged._ragged_prefill_cuda = ragged.ragged_prefill_plain
    try:
        yield
    finally:
        (api.flash_fwd, paged._paged_decode_cuda,
         paged_prefill._paged_prefill_cuda,
         ragged._ragged_prefill_cuda) = saved


# -- phase 4: the main path at full width -------------------------------------

MAIN_TIERS = (("int8", 128), ("bfloat16", 0))  # (kv_dtype, recent_window)


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
    runs."""
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    cfg = EngineConfig(
        max_batch_size=8, max_seq_len=2048, prefill_chunk=512,
        cache=CacheConfig(page_size=128, num_pages=161, max_pages_per_seq=16,
                          kv_dtype=kv_dtype, recent_window=ring),
        **config,
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
    rec = dict(
        kv_dtype=kv_dtype, recent_window=ring,
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
    missing = [k for k in kernels if not rec["launches"][k]]
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
    """Phase 4: the default routing on both tiers, both tiers again with
    paged_prefill=False (gathered history, the ragged kernel), and a
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
            gathered = config.get("paged_prefill") is False
            require_launches(rec, ["flash_fwd", "paged_decode"] + (
                ["ragged_prefill"] if gathered else ["paged_prefill"]))
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
# exactly: both take the same roundings, the prompts and weights are
# fixed, and every chip run so far matched at 1.000. A flip would be a
# finding to look into (with its logit margin), not noise to allow for.
TRAINED_MATCH_MIN = 1.0


# The staggered two-request scenario of tests/test_torch_engine_routes.py:
# a same-stage group, a ragged step, a fused step, speculative steps.
STAGGERED = (list(b"for i in range(10):\n    print(i)\nfor i in range(10):\n"
                  b"    print(i)\nfor i in range(10):\n    print("),
             list(b"import numpy as np\n"))


def check_trained(dev):
    """Phase 5: the trained checkpoint at the engine's defaults, kernels
    against plain versions token for token, speculation proposing."""
    from tpu_flash_torch.checkpoint import load_hf_dir
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    model, params = load_hf_dir(
        os.path.join(REPO, "checkpoints", "tiny-byte-llama"),
        dtype="bfloat16", device=dev,
    )
    results = []
    # (kv dtype, ring, staggered, paged_prefill): TRAINED_PROMPTS arrive
    # together, 32 tokens each; the staggered scenario takes 12 tokens
    # each. paged_prefill=False gathers int8 history (the ring overlaid)
    # and runs the ragged kernel and the gathered verify.
    for kv_dtype, ring, staggered, paged in (
            ("bfloat16", 0, False, "auto"), ("int8", 0, False, "auto"),
            ("int8", 32, True, "auto"), ("int8", 0, False, False),
            ("int8", 32, True, False)):
        cfg = EngineConfig(
            max_batch_size=2 if staggered else 4, max_seq_len=128,
            prefill_chunk=32, paged_prefill=paged,
            cache=CacheConfig(page_size=32, num_pages=12 if staggered else 14,
                              max_pages_per_seq=4, kv_dtype=kv_dtype,
                              recent_window=ring),
        )

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
            return ([out[i] for i in ids], eng.metrics.route_counts(),
                    eng.speculation_stats())

        got, routes, spec = serve()
        with plain_versions():
            want, _, _ = serve()
        same = sum(a == b for g_, w in zip(got, want) for a, b in zip(g_, w))
        total = sum(len(w) for w in want)
        match = same / total
        rec = dict(kv_dtype=kv_dtype, recent_window=ring,
                   staggered=staggered, paged_prefill=str(paged), match=match,
                   min_match=TRAINED_MATCH_MIN, routes=routes,
                   speculation=spec,
                   text=[bytes(t).decode("utf-8", "replace") for t in got])
        log("trained_model", **rec)
        if not match >= TRAINED_MATCH_MIN:
            raise AssertionError(f"trained-model greedy match {match}")
        if staggered and not all(routes[k] for k in (
                "prefill_group", "prefill_ragged", "fused", "speculative")):
            raise AssertionError(f"a route was not reached: {routes}")
        results.append(rec)
    if not sum(r["speculation"]["proposed"] for r in results):
        raise AssertionError("no draft was proposed on the trained model")
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tpu_flash_torch.ops import build

    dev = "cuda"
    gpu = gpu_query()
    log("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", seconds=secs, wall_s=time.perf_counter() - t0,
        ptxas=[ln.strip() for k in build.KERNELS.values()
               for ln in k.build_log.splitlines() if "Used" in ln])
    summary = {"flash_fwd": check_flash(dev),
               "paged_decode": check_decode(dev),
               "paged_prefill": check_paged_prefill(dev),
               "ragged_prefill": check_ragged(dev)}
    main_runs = check_main_path(dev)
    check_trained(dev)
    kernels = []
    for name, k in build.KERNELS.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=os.path.relpath(str(k.source), REPO),
            replaces=k.replaces,
            launches=sum(r["launches"][name] for r in main_runs),
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
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
