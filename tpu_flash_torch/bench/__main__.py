"""Benchmark CLI of the port: the counterpart of ``python -m tpu_flash.bench``,
one JSON row per bench row on stdout.

    python -m tpu_flash_torch.bench --configs 1,2,3,4,5,6,7,8,9,10,11,12
        [--iters N] [--json out.json] [--device cuda|cpu]

  1. parity vs exact oracle        (B=1 s=128 d=64 fp32, <=1e-2; a bf16
                                    causal sweep row)
  2. Llama-2-7B prefill TFLOP/s    (32h d=128 2K causal bf16, vs roofline;
                                    4K causal, 2K non-causal)
  3. GQA decode, int8 KV, 4K ctx   (tokens/s at int8/bf16/f32 pages + the
                                    int8 quantization delta row)
  4. int8 and fp8 QKV prefill at 8K ctx (the quantized-input kernel)
     + paged int8 and bf16 decode at 8K ctx
  5. 32K context               (8-head 32K causal prefill TFLOP/s; int4
                                decode b4 gqa4 at 32K, 1024-token pages)
  6. engine serving throughput (the whole engine on the host's wall clock,
                                b8 int8 cache, 4-layer model: steady state,
                                and staggered arrivals with fused mixed
                                steps on and off)
  7. windowed decode           (b8 gqa4, 32K context, 4K window, int8 and
                                bf16 pages; speedup over full context)
  8. windowed paged prefill    (a 512-token chunk over 32K of history,
                                4K window, bf16 and int8 pages; speedup
                                over the full-history sweep)
  9. quantized-cache generation quality (greedy token match of each cache
                                tier against the bf16 cache, tiny
                                random-weight model at d 128; and past a
                                32-token ring)
  10. engine decode on the kernels' time (the engine's burst, host
                                excluded, with the wall time per step and
                                the device's idle share beside it; toy
                                rows and Llama-3-8B widths at 8 layers)
  11. attention train step     (forward + the backward kernels through
                                autograd, 3.5x forward FLOPs; 2K h32, 8K h8)
  12. speculative serving      (off, self-draft k8 and k16, prompt lookup;
                                random weights and the trained
                                checkpoints/tiny-byte-llama)

Rows keep the JAX bench's names and metrics (the JAX bench's config-6
rows say "config": 4; here they say 6). Rates are the card's own against
the card's data-sheet figures (``utils/device.py``). Config 2 carries no
measured-ceiling gate: the JAX bench's gate is a ceiling measured on a
TPU, which says nothing about this card. ``SIZES`` holds the lengths of
configs 5-12 (tests shrink them). On ``--device cpu`` the kernels' plain
versions run: parity and quality rows mean what they say, throughput rows
time PyTorch's CPU kernels and carry ``"backend": "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

# Sizes of configs 5-12, the JAX bench's.
SIZES = {
    "long_ctx": 32768,    # config 5's prefill and decode, 7's, 8's history
    "window": 4096,       # configs 7 and 8
    "chunk": 512,         # config 8
    "train": ((32, 2048), (8, 8192)),  # config 11: (heads, seq) rows
    # Configs 6, 10 (toy rows) and 12 (random weights): the engine
    # benches' model.
    "engine_model": dict(num_layers=4, hidden=1024, num_q_heads=8,
                         head_dim=128),
    # Config 6: batch, prompt and new tokens a request; its multi-LoRA
    # row's adapters (rank, count; over every layer and projection).
    "engine": dict(batch=8, prompt_len=512, new_tokens=64),
    "engine_lora": dict(lora_rank=16, lora_count=2),
    # Config 10: the toy rows' batch, prompt tokens, the context each row
    # reserves, decode steps a burst, and the production rows' model
    # (Llama-3-8B widths, 8 layers) and batches.
    "device_decode": dict(batch=8, prompt_len=512, max_ctx=1024, burst=8),
    "production": dict(num_layers=8, hidden=4096, num_q_heads=32,
                       num_kv_heads=8, batches=(8, 16, 32)),
    # Config 9: new tokens of the in-ring report and the beyond-window one.
    "quality_new_tokens": (32, 96),
    # Config 12's random-weight rows: batch, prompt and new tokens.
    "speculative": dict(batch=4, prompt_len=48, new_tokens=96),
}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def config1_parity(iters: int, device="cuda"):
    """Max |flash - oracle| on BASELINE config 1 + a bf16 causal sweep."""
    del iters
    from tpu_flash_torch.core.reference import reference_gqa_attention
    from tpu_flash_torch.ops.flash import flash_attention

    rows = []
    # (shape..., dtype, causal, tolerance): 1e-2 is the BASELINE config-1
    # target for fp32; the bf16 sweep row gets bf16 rounding headroom.
    for (b, h, s, d, dt, causal, tol) in [
        (1, 1, 128, 64, torch.float32, False, 1e-2),  # the literal config 1
        (2, 4, 384, 128, torch.bfloat16, True, 2e-2),  # unaligned + causal
    ]:
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn(b, h, s, d, generator=g, device=device).to(dt)
                   for _ in range(3))
        with torch.no_grad():
            out = flash_attention(q, k, v, causal=causal)
        ref = reference_gqa_attention(q, k, v, causal=causal)
        err = float((out.float() - ref.float()).abs().max())
        rows.append({
            "config": 1,
            "name": f"parity b{b} h{h} s{s} d{d} "
                    f"{str(dt).removeprefix('torch.')}"
                    f"{' causal' if causal else ''}",
            "metric": "max_abs_err",
            "value": err,
            "target": tol,
            "pass": err <= tol,
        })
        _log(f"  {rows[-1]['name']}: err={err:.2e}")
    return rows


def config2_prefill(iters: int, device="cuda"):
    from tpu_flash_torch.bench.suite import bench_flash_prefill

    rows = []
    # Headline 2K causal + 4K causal and 2K non-causal. No measured-ceiling
    # gate (module docstring).
    for kwargs in (dict(), dict(seq=4096), dict(causal=False)):
        res = bench_flash_prefill(iters=iters, device=device, **kwargs)
        _log(f"  {res.name}: {res.tflops:.1f} TFLOP/s "
             f"({100 * res.roofline_frac:.1f}% roofline)")
        rows.append({
            "config": 2,
            "name": res.name,
            "metric": "tflops",
            "value": res.tflops,
            "roofline_tflops": res.roofline_tflops,
            "roofline_frac": res.roofline_frac,
        })
    return rows


def decode_row(config, name, tps, secs, gbps):
    _log(f"  {name}: {tps:.0f} tok/s ({secs * 1e3:.3f} ms/step, "
         f"{gbps:.0f} GB/s KV)")
    return {"config": config, "name": name, "metric": "tokens_per_s",
            "value": tps, "step_ms": secs * 1e3, "kv_hbm_gbps": gbps}


def quant_delta_row(device="cuda"):
    """Paged int8 decode against exact attention on the dequantized pages
    and on the fp pages (b 2, hq 8 / hkv 2, d 128, 1024 tokens in pages
    of 128)."""
    from tpu_flash_torch.core.reference import (
        gather_pages_to_dense,
        reference_decode_attention,
    )
    from tpu_flash_torch.ops.decode import paged_attention
    from tpu_flash_torch.ops.quant import dequantize, quantize_pages

    b, hq, hkv, d, ctx, ps = 2, 8, 2, 128, 1024, 128
    pages_per_seq = ctx // ps
    num_pages = b * pages_per_seq + 1
    g = torch.Generator(device=device).manual_seed(1)
    k_pages = torch.randn(hkv, num_pages, ps, d, generator=g, device=device)
    v_pages = torch.randn(hkv, num_pages, ps, d, generator=g, device=device)
    q = torch.randn(b, hq, d, generator=g, device=device)
    page_indices = torch.arange(
        b * pages_per_seq, dtype=torch.int32, device=device
    ).reshape(b, pages_per_seq)
    lengths = torch.full((b,), ctx, dtype=torch.int32, device=device)
    kq8 = quantize_pages(k_pages, "int8")
    vq8 = quantize_pages(v_pages, "int8")
    with torch.no_grad():
        out_q = paged_attention(q, kq8, vq8, lengths, page_indices)
    k_dense = gather_pages_to_dense(dequantize(kq8), page_indices)
    v_dense = gather_pages_to_dense(dequantize(vq8), page_indices)
    ref = reference_decode_attention(q, k_dense, v_dense, lengths)
    delta = float((out_q - ref).abs().max())
    ref_fp = reference_decode_attention(
        q, gather_pages_to_dense(k_pages, page_indices),
        gather_pages_to_dense(v_pages, page_indices), lengths)
    delta_fp = float((out_q - ref_fp).abs().max())
    _log(f"  int8-kv decode delta vs exact fp: {delta_fp:.2e} "
         f"(kernel-vs-dequant-oracle {delta:.2e})")
    return {
        "config": 3,
        "name": "decode int8-kv quant delta",
        "metric": "max_abs_err",
        "value": delta_fp,
        "kernel_vs_dequant_oracle": delta,
        "target": 0.05,
        "pass": delta_fp <= 0.05,
    }


def config3_decode(iters: int, device="cuda"):
    from tpu_flash_torch.bench.suite import bench_decode_tokens_per_s

    rows = []
    # Page sizes of the auto policy (utils/tuning.py): 512 for quantized
    # caches, 1024 for fp ones, named in every row.
    for kv_quant, fp_dtype, ps, label in (
        ("int8", None, 512, "int8"),
        (None, torch.bfloat16, 1024, "bf16"),
        (None, torch.float32, 1024, "fp32"),
    ):
        res = bench_decode_tokens_per_s(
            kv_quant=kv_quant, page_size=ps, iters=max(64, iters),
            device=device,
            **({"fp_dtype": fp_dtype} if fp_dtype is not None else {}),
        )
        rows.append(decode_row(3, f"decode b8 gqa4 4K {label}-kv ps{ps}",
                               *res))
    rows.append(quant_delta_row(device))
    return rows


def config4_quantized(iters: int, device="cuda"):
    from tpu_flash_torch.bench.suite import (
        attention_flops,
        bench_decode_tokens_per_s,
        time_per_call,
    )
    from tpu_flash_torch.ops.flash import (
        flash_attention_quantized,
        quantize_attention_inputs,
    )
    from tpu_flash_torch.utils.device import device_info

    rows = []
    # Quantized-QKV prefill at 8K context, Llama-3-8B attention geometry,
    # both 8-bit payloads (fp8 at the card's default tier).
    b, hq, hkv, s, d = 1, 32, 8, 8192, 128
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, hq, s, d, generator=g, device=device).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=g, device=device).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=g, device=device).bfloat16()
    flops = attention_flops(b, hq, s, s, d, True)
    info = device_info(device)
    for dtype_name in ("fp8", "int8"):
        qi = quantize_attention_inputs(q, k, v, dtype_name)
        secs = time_per_call(
            lambda: flash_attention_quantized(
                qi, causal=True, out_dtype=torch.bfloat16),
            device=device, inner=max(4, iters // 2),
        )
        tflops = flops / secs / 1e12
        # An 8-bit kernel's share of the card's 8-bit tensor-core rate.
        peak = info.peak_int8_tflops
        rows.append({
            "config": 4,
            "name": f"{dtype_name}-qkv prefill b{b} h{hq} s{s} d{d} causal",
            "metric": "tflops",
            "value": tflops,
            "roofline_frac": tflops / peak if peak else 0.0,
        })
        _log(f"  {dtype_name} prefill 8K: {tflops:.2f} TFLOP/s")
    rows.append(decode_row(4, "paged-int8 decode b8 gqa4 8K ps512",
                           *bench_decode_tokens_per_s(
                               context=8192, kv_quant="int8", page_size=512,
                               iters=max(64, iters), device=device)))
    rows.append(decode_row(4, "paged-bf16 decode b8 gqa4 8K ps1024",
                           *bench_decode_tokens_per_s(
                               context=8192, kv_quant=None,
                               fp_dtype=torch.bfloat16, page_size=1024,
                               iters=max(64, iters), device=device)))
    return rows


def config5_longcontext(iters: int, device="cuda"):
    """32K-context numbers: an 8-head causal prefill and int4 decode."""
    from tpu_flash_torch.bench.suite import (
        bench_decode_tokens_per_s,
        bench_flash_prefill,
    )

    ctx = SIZES["long_ctx"]
    res = bench_flash_prefill(batch=1, num_q_heads=8, num_kv_heads=8,
                              seq=ctx, iters=max(4, iters // 4),
                              device=device)
    _log(f"  {res.name}: {res.tflops:.1f} TFLOP/s "
         f"({100 * res.roofline_frac:.1f}% roofline)")
    rows = [{"config": 5, "name": res.name, "metric": "tflops",
             "value": res.tflops, "roofline_frac": res.roofline_frac}]
    rows.append(decode_row(
        5, f"int4-kv decode b4 gqa4 {ctx // 1024}K ps1024",
        *bench_decode_tokens_per_s(batch=4, context=ctx, kv_quant="int4",
                                   page_size=1024, iters=max(64, iters),
                                   device=device)))
    return rows


def config7_windowed_decode(iters: int, device="cuda"):
    """Sliding-window decode: 32K context, 4K window, the windowed tok/s
    and its speedup over full-context decode on the same cache."""
    from tpu_flash_torch.bench.suite import bench_decode_tokens_per_s

    ctx, win = SIZES["long_ctx"], SIZES["window"]
    rows = []
    for kv_quant, fp_dtype, label in (("int8", None, "int8"),
                                      (None, torch.bfloat16, "bf16")):
        kwargs = dict(context=ctx, kv_quant=kv_quant, iters=max(64, iters),
                      pages_per_compute_block=32 if kv_quant else 16,
                      device=device)
        if fp_dtype is not None:
            kwargs["fp_dtype"] = fp_dtype
        tps_w, secs_w, gbps_w = bench_decode_tokens_per_s(window=win,
                                                          **kwargs)
        tps_f, _, _ = bench_decode_tokens_per_s(**kwargs)
        rows.append({
            "config": 7,
            "name": f"windowed decode b8 gqa4 {ctx // 1024}K ctx win{win} "
                    f"{label}-kv",
            "metric": "tokens_per_s",
            "value": tps_w,
            "step_ms": secs_w * 1e3,
            "attended_hbm_gbps": gbps_w,
            "full_ctx_tokens_per_s": tps_f,
            "window_speedup": tps_w / tps_f if tps_f else None,
        })
        _log(f"  {rows[-1]['name']}: {tps_w:.0f} tok/s windowed vs "
             f"{tps_f:.0f} full ({tps_w / tps_f:.2f}x)")
    return rows


def config8_windowed_prefill(iters: int, device="cuda"):
    """A windowed 512-token prefill chunk over 32K of paged history: us a
    chunk and the speedup over the full-history sweep on the same cache."""
    from tpu_flash_torch.bench.suite import bench_paged_prefill_chunk

    hist, win, chunk = SIZES["long_ctx"], SIZES["window"], SIZES["chunk"]
    rows = []
    for kv_quant, label in ((None, "bf16"), ("int8", "int8")):
        kwargs = dict(hist=hist, chunk=chunk, kv_quant=kv_quant, iters=iters,
                      device=device)
        secs_w, gbps_w = bench_paged_prefill_chunk(window=win, **kwargs)
        secs_f, _ = bench_paged_prefill_chunk(**kwargs)
        rows.append({
            "config": 8,
            "name": f"windowed paged prefill chunk{chunk} "
                    f"{hist // 1024}K hist win{win} {label}-kv",
            "metric": "us_per_chunk",
            "value": secs_w * 1e6,
            "attended_hbm_gbps": gbps_w,
            "full_hist_us_per_chunk": secs_f * 1e6,
            "window_speedup": secs_f / secs_w if secs_w else None,
        })
        _log(f"  {rows[-1]['name']}: {secs_w * 1e6:.0f} us windowed vs "
             f"{secs_f * 1e6:.0f} full ({secs_f / secs_w:.2f}x)")
    return rows


def config6_engine(iters: int, device="cuda"):
    """The whole serving stack (scheduler, chunked prefill, burst decode,
    sampling, watchdogs) on the host's wall clock, after a warm-up round;
    then staggered arrivals (mixed prefill and decode steps) with fused
    mixed steps on and off; then the first row again with every request
    through one of ``SIZES["engine_lora"]``'s adapters."""
    del iters
    from tpu_flash_torch.bench.suite import bench_engine_tokens_per_s

    kw = dict(SIZES["engine_model"], **SIZES["engine"], device=device)
    tps, _, m, _ = bench_engine_tokens_per_s(**kw)
    _log(f"  engine steady-state: {tps:.0f} tok/s "
         f"(p50 step {m.get('p50_step_ms', 0):.1f} ms)")
    rows = [{
        "config": 6,
        "name": f"engine continuous-batching b{kw['batch']} int8-kv "
                f"({kw['num_layers']}-layer model)",
        "metric": "decode_tokens_per_s",
        "value": tps,
        "p50_step_ms": m.get("p50_step_ms", 0.0),
        "mean_occupancy": m.get("mean_batch_occupancy", 0.0),
    }]
    for fused in (True, False):
        tps_s, wall_s, m_s, _ = bench_engine_tokens_per_s(
            staggered=True, fused_mixed_step=fused, **kw)
        _log(f"  staggered fused={fused}: {tps_s:.0f} tok/s, "
             f"wall {wall_s:.1f}s "
             f"(p50 step {m_s.get('p50_step_ms', 0):.1f} ms)")
        rows.append({
            "config": 6,
            "name": f"engine staggered arrivals fused={fused}",
            "metric": "decode_tokens_per_s",
            "value": tps_s,
            "wall_s": wall_s,
            "p50_step_ms": m_s.get("p50_step_ms", 0.0),
        })
    lora = SIZES["engine_lora"]
    tps_l, wall_l, m_l, _ = bench_engine_tokens_per_s(**lora, **kw)
    _log(f"  multi-LoRA: {tps_l:.0f} tok/s, wall {wall_l:.1f}s "
         f"(p50 step {m_l.get('p50_step_ms', 0):.1f} ms)")
    rows.append({
        "config": 6,
        "name": f"engine continuous-batching b{kw['batch']} int8-kv "
                f"multi-LoRA {lora['lora_count']} x r{lora['lora_rank']} "
                f"({kw['num_layers']}-layer model)",
        "metric": "decode_tokens_per_s",
        "value": tps_l,
        "wall_s": wall_l,
        "p50_step_ms": m_l.get("p50_step_ms", 0.0),
        "base_decode_tokens_per_s": tps,
    })
    return rows


def config9_quant_quality(iters: int, device="cuda"):
    """Generation quality of the quantized caches: greedy-decode the same
    prompts through the engine with a bf16 cache and with each quantized
    tier; token-match rates (``bench/quality.py``). The model has random
    weights, so argmax margins are far smaller than a trained model's:
    the rates are a lower bound."""
    del iters
    import dataclasses

    from tpu_flash_torch.bench.quality import quant_quality_report
    from tpu_flash_torch.models import TINY_TEST, FlashTransformer

    cfg = dataclasses.replace(TINY_TEST, head_dim=128)
    model = FlashTransformer(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    prompts = [
        [3, 14, 15, 9, 2, 6, 53, 58],
        [97, 93, 23, 84, 62, 64, 33, 83],
        [11, 200, 47, 5, 130, 77, 8, 99],
    ]
    new_in, new_beyond = SIZES["quality_new_tokens"]
    geo = dict(baseline_dtype="bfloat16", page_size=128, max_seq_len=512,
               prefill_chunk=64)
    report = quant_quality_report(
        model, params, prompts, max_new_tokens=new_in,
        kv_dtypes=("int8", "int4", "int4g32", "k8v4", "fp8"), **geo)
    rows = []
    for dt, r in report.items():
        rows.append({
            "config": 9,
            "name": f"quant quality {dt}-kv greedy token match "
                    "(tiny random-weight model)",
            "metric": "prefix_match_rate",
            "value": r["prefix_match"],
            "positionwise_match_rate": r["positionwise_match"],
            "n_tokens": r["n_tokens"],
        })
        _log(f"  {dt}: prefix {r['prefix_match']:.3f} "
             f"positionwise {r['positionwise_match']:.3f}")
    # Past the ring: a 32-token exact ring under the generated context,
    # so most attention reads quantized pages (the default 128-token ring
    # would cover these short contexts entirely).
    report_bw = quant_quality_report(
        model, params, prompts, max_new_tokens=new_beyond,
        kv_dtypes=("int8", "int4", "int4g32", "k8v4"), recent_window=32,
        **geo)
    ctx = len(prompts[0]) + new_beyond
    for dt, r in report_bw.items():
        rows.append({
            "config": 9,
            "name": f"quant quality {dt}-kv beyond-window stress "
                    f"(ring 32 << context {ctx}, random-weight model)",
            "metric": "prefix_match_rate",
            "value": r["prefix_match"],
            "positionwise_match_rate": r["positionwise_match"],
            "n_tokens": r["n_tokens"],
        })
        _log(f"  {dt} beyond-window: prefix {r['prefix_match']:.3f} "
             f"positionwise {r['positionwise_match']:.3f}")
    return rows


def device_decode_row(name, res, **extra):
    tps, _, sec_step, wall_step, idle = res
    _log(f"  {name}: {tps:.0f} tok/s ({sec_step * 1e6:.0f} us/step kernel "
         f"time, {wall_step * 1e6:.0f} us/step wall, idle {idle:.3f})")
    return {"config": 10, "name": name,
            "metric": "device_decode_tokens_per_s", "value": tps,
            "step_us": sec_step * 1e6, "wall_step_us": wall_step * 1e6,
            "idle_share": idle, **extra}


def config10_engine_device(iters: int, device="cuda"):
    """Serving decode on the kernels' time: the engine's own burst with
    the lengths held constant, its kernel time summed from a trace (host
    excluded; on the CPU the time of PyTorch's ops), beside the wall time
    per step and the device's idle share over the same window. Toy rows
    (MHA and GQA-4), then Llama-3-8B widths at 8 layers over a batch
    sweep at the engine's auto cache layout."""
    from tpu_flash_torch.bench.suite import bench_engine_device_decode
    from tpu_flash_torch.core.config import CacheConfig
    from tpu_flash_torch.utils.tuning import resolve_cache_config

    toy, lens = SIZES["engine_model"], SIZES["device_decode"]
    inner = max(4, iters // 4)
    rows = []
    for kv_dtype, hkv, label in (("bfloat16", 8, "mha"), ("int8", 8, "mha"),
                                 ("bfloat16", 2, "gqa4")):
        res = bench_engine_device_decode(
            kv_dtype=kv_dtype, num_kv_heads=hkv, inner=inner, device=device,
            **toy, **lens)
        rows.append(device_decode_row(
            f"engine device-side decode b{lens['batch']} {toy['num_layers']}L "
            f"h{toy['num_q_heads']}/{hkv}kv d{toy['head_dim']} {label} "
            f"{kv_dtype}-kv (per-layer rates scale; kernel time, host "
            "excluded)", res))
    prod = dict(SIZES["production"])
    batches = prod.pop("batches")
    for batch, kv_dtype in ((batches[0], "bfloat16"),
                            *((b, "int8") for b in batches)):
        resolved = resolve_cache_config(
            CacheConfig(kv_dtype=kv_dtype), max_seq_len=lens["max_ctx"],
            max_batch_size=batch)
        res = bench_engine_device_decode(
            kv_dtype=kv_dtype, page_size=None, inner=inner, device=device,
            **prod, **dict(lens, batch=batch))
        rows.append(device_decode_row(
            f"engine device-side decode b{batch} {prod['num_layers']}L "
            f"h{prod['num_q_heads']}/{prod['num_kv_heads']}kv d128 "
            f"hidden{prod['hidden']} gqa4 {kv_dtype}-kv auto-layout "
            f"ps{resolved.page_size} ring{resolved.recent_window} "
            "(production shape; per-layer rates scale; kernel time, host "
            "excluded)", res, page_size=resolved.page_size,
            recent_window=resolved.recent_window))
    return rows


SPEC_TEXT = (b"def attention(q, k, v):\n    scores = q @ k.T / sqrt(d)\n"
             b"    return softmax(scores) @ v\n\n"
             b"def paged_decode(cache, q):\n")


def config12_speculative(iters: int, device="cuda"):
    """Speculative decoding at serving level: plain burst decode,
    self-draft speculation (the draft model is the target: the acceptance
    ceiling wherever its 64-token window suffices) at k 8 and 16, and
    prompt lookup on random prompts (the low-acceptance overhead regime),
    on random weights and on the trained checkpoint (real margins). The
    tokens/s count the timed round's tokens (the JAX bench's count the
    warm-up round's too)."""
    del iters
    import os

    from tpu_flash_torch.bench.suite import bench_engine_speculative

    variants = [("random", None, None)]
    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "checkpoints", "tiny-byte-llama")
    if os.path.isdir(ckpt):
        from tpu_flash_torch.checkpoint import load_hf_dir

        mp = load_hf_dir(ckpt, dtype="bfloat16", device=device)
        prompts = [list(SPEC_TEXT[i:i + 48]) for i in (0, 16, 32, 48)]
        variants.append(("trained", mp, prompts))
    spec = SIZES["speculative"]
    rows = []
    for substrate, mp, prompts in variants:
        for mode, k in (("off", 8), ("self-draft", 8), ("self-draft", 16),
                        ("prompt-lookup", 8)):
            r = bench_engine_speculative(
                mode=mode, spec_k=k, model_and_params=mp, prompts=prompts,
                device=device, **SIZES["engine_model"], **spec)
            batch = len(prompts) if prompts else spec["batch"]
            plen = (max(len(p) for p in prompts) if prompts
                    else spec["prompt_len"])
            rows.append({
                "config": 12,
                "name": f"speculative serving {mode} k{k} b{batch} "
                        f"{substrate}-weights bf16-kv ps128 "
                        f"({plen}-token prompts, {spec['new_tokens']} new)",
                "metric": "tokens_per_s",
                "value": r["tokens_per_s"],
                "steps": r["steps"],
                "decode_tokens_per_step": r["decode_tokens_per_step"],
                "acceptance_rate": r["acceptance_rate"],
            })
            _log(f"  {substrate} {mode} k{k}: "
                 f"{r['tokens_per_s']:.0f} tok/s, {r['steps']} steps, "
                 f"{r['decode_tokens_per_step']:.2f} tok/step, "
                 f"accept {r['acceptance_rate']:.2f}")
    return rows


def config11_train(iters: int, device="cuda"):
    """The attention training step (forward + the backward kernels through
    the port's autograd function), 3.5x forward FLOPs."""
    from tpu_flash_torch.bench.suite import bench_train_step

    rows = []
    for heads, seq in SIZES["train"]:
        res = bench_train_step(num_q_heads=heads, num_kv_heads=heads,
                               seq=seq, iters=max(4, iters // 4),
                               device=device)
        _log(f"  {res.name}: {res.tflops:.1f} TFLOP/s "
             f"({100 * res.roofline_frac:.1f}% roofline), "
             f"{res.seconds * 1e3:.2f} ms/step")
        rows.append({"config": 11, "name": res.name,
                     "metric": "train_tflops", "value": res.tflops,
                     "roofline_frac": res.roofline_frac,
                     "ms_per_step": res.seconds * 1e3})
    return rows


CONFIGS = {
    1: config1_parity,
    2: config2_prefill,
    3: config3_decode,
    4: config4_quantized,
    5: config5_longcontext,
    6: config6_engine,
    7: config7_windowed_decode,
    8: config8_windowed_prefill,
    9: config9_quant_quality,
    10: config10_engine_device,
    11: config11_train,
    12: config12_speculative,
}


def run_configs(configs, iters: int = 32, device="cuda"):
    """The rows of each config in ``configs``, in order."""
    all_rows = []
    backend = torch.device(device).type
    for c in configs:
        _log(f"config {c}:")
        with torch.no_grad():
            rows = CONFIGS[c](iters, device=device)
        for r in rows:
            r["backend"] = backend
        all_rows.extend(rows)
    return all_rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Benchmarks of the PyTorch + CUDA port, the JAX "
                    "bench's configs")
    ap.add_argument("--configs", default="1,2,3,4,5,7,8,11")
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--json", default=None, help="write rows as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    try:
        wanted = [int(x) for x in args.configs.split(",")]
    except ValueError:
        ap.error(f"--configs must be comma-separated integers, got "
                 f"{args.configs!r}")
    unknown = [c for c in wanted if c not in CONFIGS]
    if unknown:
        ap.error(f"unknown config(s) {unknown}; available: "
                 f"{sorted(CONFIGS)}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA card (use --device cpu for the "
                 "plain versions)")
    if dev.type == "cuda":
        _log(f"device: {torch.cuda.get_device_name(dev)}")
    rows = run_configs(wanted, args.iters, args.device)
    for r in rows:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        _log(f"wrote {args.json}")


if __name__ == "__main__":
    main()
