#!/usr/bin/env python3
"""Chip smoke test of the tpu_flash_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; it needs no JAX and no
network. Phases, one JSON line each:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: both CUDA kernels from tpu_flash_torch/csrc (one nvcc each,
     started together), with the build seconds;
  3. kernels: each kernel against its plain PyTorch version on the card
     at the main path's shapes, with times, bounds and a library
     yardstick;
  4. main path: Llama-3-8B geometry at full width (all 32 layers, seeded
     random bf16 weights made on the card) served by the port's engine,
     8 requests x 32 greedy tokens, on an int8 cache with the recent ring
     and then on a bf16 cache; launch counters reset before each run;
  5. trained model: checkpoints/tiny-byte-llama served with bf16 and
     int8 caches, its greedy text against the same engine on the plain
     versions.

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


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors through the plain PyTorch versions instead of
    the kernels, for the reference runs on the card (the wrappers
    themselves never do this)."""
    from tpu_flash_torch.ops.decode import paged
    from tpu_flash_torch.ops.flash import api, forward

    saved = (api.flash_fwd, paged._paged_decode_cuda)
    api.flash_fwd = forward.flash_fwd_plain
    paged._paged_decode_cuda = paged.paged_decode_plain
    try:
        yield
    finally:
        api.flash_fwd, paged._paged_decode_cuda = saved


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


def main_path_engine(model, params, kv_dtype, ring, prompts):
    """The main path's engine, warmed up by one short request so that
    CUDA/cuBLAS initialisation and allocator growth stay out of timed
    runs."""
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    cfg = EngineConfig(
        max_batch_size=8, max_seq_len=2048, prefill_chunk=512,
        cache=CacheConfig(page_size=128, num_pages=161, max_pages_per_seq=16,
                          kv_dtype=kv_dtype, recent_window=ring),
        paged_prefill=False, fused_mixed_step=False,
    )
    eng = InferenceEngine(model, params, cfg)
    eng.submit(prompts[0][:64], 2)
    eng.run()
    return eng


def serve_8b(model, params, kv_dtype, ring, prompts, new_tokens):
    """Serve ``prompts`` on the port's engine; returns the phase record.

    prefill_tok_per_s: prompt tokens over the time spent in prefill
    groups; decode_tok_per_s: tokens from decode bursts over the time
    spent in them (each timed between device synchronisations; the first
    token of each request comes from its prefill)."""
    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    eng = main_path_engine(model, params, kv_dtype, ring, prompts)
    first = {}
    spent = {"prefill": 0.0, "decode": 0.0}
    impl = eng._chunked_prefill_impl

    def capture(hist_len, tokens, table_rows, n_valids, slots):
        last, finite = impl(hist_len, tokens, table_rows, n_valids, slots)
        if not first:
            first.update(tokens=tokens.clone(), n_valids=n_valids.clone(),
                         last=last.clone())
        return last, finite

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out
        return run

    eng._chunked_prefill_impl = capture
    eng._run_prefill_group = timed("prefill", eng._run_prefill_group)
    eng._run_decode = timed("decode", eng._run_decode)
    torch.cuda.synchronize()
    tok0, dec0 = eng.metrics.prefill_tokens, eng.metrics.decode_tokens
    build.reset_launch_counts()
    ids = [eng.submit(p, new_tokens) for p in prompts]
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefill_tok = eng.metrics.prefill_tokens - tok0
    decode_tok = eng.metrics.decode_tokens - dec0
    launches = build.launch_counts()
    eng._chunked_prefill_impl = impl
    out = [eng.outputs[i] for i in ids]
    if any(len(o) != new_tokens for o in out):
        raise AssertionError(f"token counts {[len(o) for o in out]}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
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
    argmax_equal = float(
        (first["last"].argmax(-1) == ref_last.argmax(-1)).float().mean()
    )
    finite = bool(torch.isfinite(first["last"]).all())
    rec = dict(
        kv_dtype=kv_dtype, recent_window=ring, requests=len(prompts),
        prompt_tokens=prefill_tok, new_tokens_each=new_tokens,
        wall_s=wall, prefill_s=spent["prefill"],
        prefill_tok_per_s=prefill_tok / spent["prefill"],
        decode_tokens=decode_tok, decode_s=spent["decode"],
        decode_tok_per_s=decode_tok / spent["decode"],
        launches=launches, finite=finite,
        first_logits_max_abs_err=err, first_logits_max_abs=scale,
        first_logits_rel_err=err / scale, first_argmax_equal=argmax_equal,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    eng.close()
    return rec


# Kernel and plain forwards differ only in summation order inside
# attention; in bf16 each layer re-rounds, so through 32 layers the
# first logits may drift by a few bf16 ulps of their largest magnitude:
# 5% of max |logit| is that bar (bf16 relative ulp 0.8%).
LOGITS_REL_TOL = 0.05


def check_main_path(dev):
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
        for kv_dtype, ring in MAIN_TIERS:
            rec = serve_8b(model, params, kv_dtype, ring, prompts, 32)
            log("main_path", gpu=gpu_query(), **rec)
            if not rec["finite"]:
                raise AssertionError("non-finite logits")
            if not rec["first_logits_rel_err"] <= LOGITS_REL_TOL:
                raise AssertionError(
                    f"first-step logits off the plain forward: {rec}"
                )
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


def check_trained(dev):
    import torch

    from tpu_flash_torch.checkpoint import load_hf_dir
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    model, params = load_hf_dir(
        os.path.join(REPO, "checkpoints", "tiny-byte-llama"),
        dtype="bfloat16", device=dev,
    )
    results = []
    for kv_dtype, ring in (("bfloat16", 0), ("int8", 0)):
        cfg = EngineConfig(
            max_batch_size=4, max_seq_len=128, prefill_chunk=32,
            cache=CacheConfig(page_size=32, num_pages=14,
                              max_pages_per_seq=4, kv_dtype=kv_dtype,
                              recent_window=ring),
            paged_prefill=False, fused_mixed_step=False,
        )

        def serve():
            eng = InferenceEngine(model, params, cfg)
            ids = [eng.submit(list(p), 32) for p in TRAINED_PROMPTS]
            out = eng.run()
            eng.close()
            return [out[i] for i in ids]

        got = serve()
        with plain_versions():
            want = serve()
        same = sum(a == b for g_, w in zip(got, want) for a, b in zip(g_, w))
        total = sum(len(w) for w in want)
        match = same / total
        rec = dict(kv_dtype=kv_dtype, match=match, min_match=TRAINED_MATCH_MIN,
                   text=[bytes(t).decode("utf-8", "replace") for t in got])
        log("trained_model", **rec)
        if not match >= TRAINED_MATCH_MIN:
            raise AssertionError(f"trained-model greedy match {match}")
        results.append(rec)
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
               "paged_decode": check_decode(dev)}
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
