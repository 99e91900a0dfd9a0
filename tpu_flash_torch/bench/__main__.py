"""Benchmark CLI of the port: the counterpart of ``python -m tpu_flash.bench``
for its kernel-level configs (1-5, 7, 8, 11), one JSON row per bench row on
stdout.

    python -m tpu_flash_torch.bench --configs 1,2,3,4,5,7,8,11 [--iters N]
        [--json out.json] [--device cuda|cpu]

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
  7. windowed decode           (b8 gqa4, 32K context, 4K window, int8 and
                                bf16 pages; speedup over full context)
  8. windowed paged prefill    (a 512-token chunk over 32K of history,
                                4K window, bf16 and int8 pages; speedup
                                over the full-history sweep)
  11. attention train step     (forward + the backward kernels through
                                autograd, 3.5x forward FLOPs; 2K h32, 8K h8)

Rows keep the JAX bench's names and metrics. Rates are the card's own
against the card's data-sheet figures (``utils/device.py``). Config 2
carries no measured-ceiling gate: the JAX bench's gate is a ceiling
measured on a TPU, which says nothing about this card. The engine-level
configs 6, 9, 10 and 12 are not ported yet (ROADMAP queue 1, item 16).
``SIZES`` holds the lengths of configs 5, 7, 8 and 11 (tests shrink
them). On ``--device cpu`` the kernels' plain versions run: parity rows
mean what they say, throughput rows time PyTorch's CPU kernels and carry
``"backend": "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

# Configs of the JAX bench that wait for a later slice of the port.
NOT_PORTED = (6, 9, 10, 12)
# Lengths of configs 5, 7, 8 and 11, the JAX bench's.
SIZES = {
    "long_ctx": 32768,    # config 5's prefill and decode, 7's, 8's history
    "window": 4096,       # configs 7 and 8
    "chunk": 512,         # config 8
    "train": ((32, 2048), (8, 8192)),  # config 11: (heads, seq) rows
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
    7: config7_windowed_decode,
    8: config8_windowed_prefill,
    11: config11_train,
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
                    "bench's kernel-level configs")
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
    later = [c for c in wanted if c in NOT_PORTED]
    if later:
        ap.error(f"config(s) {later} of the JAX bench are not ported yet "
                 f"(ROADMAP queue 1, item 16); available: {sorted(CONFIGS)}")
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
