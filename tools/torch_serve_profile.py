#!/usr/bin/env python3
"""Where the port's serving time goes on one CUDA card.

    python3 tools/torch_serve_profile.py [--prefill-only]

Serves the work of ``chip_smoke.py`` phase 4 with its own model, prompts
and engines (Llama-3-8B geometry, 32 layers, seeded random bf16 weights;
8 prompts of 100..1500 tokens) at the engine's default routing (paged
prefill, fused mixed steps, speculation k 8) on an int8 cache with the
128-token ring and on a bf16 cache, and traces two windows with
``torch.profiler`` (``--prefill-only``: the prefill windows alone):

  * prefill: the requests with max_new_tokens=1, so every step is a
    prefill dispatch (chunks past the first attend their history through
    paged_prefill); then, on the int8 + ring cache with
    paged_prefill=False, four prompts one step ahead of the other four,
    so that chunks at mixed stages attend gathered history through
    ragged_prefill in one dispatch;
  * decode: 32-token requests from the first step after every prompt is
    in the cache, so every step is a decode call (a burst, or a
    speculative verify where prompt lookup drafts). The window runs three
    times with the same greedy work: untraced for its wall time, untraced
    again with speculation off (what the per-step draft lookup costs
    where it rarely engages), then traced.

For each window it prints one JSON line: the engine's dispatches by
route, host wall time, summed device kernel time, the device's idle
share (1 - kernel time / wall, one stream; for decode also against the
untraced wall time), the kernel time by class (flash_fwd, paged_decode,
paged_prefill, ragged_prefill, matmul, other) and the heaviest kernels.
Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CLASSES = (
    ("flash_fwd", ("flash_fwd_dense_kernel", "flash_fwd_tc_kernel")),
    ("paged_decode", ("paged_decode_kernel",)),
    ("paged_prefill", ("paged_prefill_kernel",)),
    ("ragged_prefill", ("ragged_prefill_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def trace(fn):
    """(wall seconds, {kernel name: device seconds}) of fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # Device activity only: host-side op tracing would slow the eager,
    # host-bound decode loop and inflate the idle share.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.key and ev.device_type.name == "CUDA":
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us * 1e-6
    return wall, kernels


def report(window, kv_dtype, wall, kernels, tokens, routes,
           untraced_wall=None, untraced_wall_no_spec=None):
    busy = sum(kernels.values())
    by_class = {}
    for name, sec in kernels.items():
        cls = classify(name)
        by_class[cls] = by_class.get(cls, 0.0) + sec
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "window": window, "kv_dtype": kv_dtype, "tokens": tokens,
        "dispatches": routes,
        "wall_s": wall, "device_kernel_s": busy,
        "idle_share": 1.0 - busy / wall if wall else None,
        "untraced_wall_s": untraced_wall,
        "untraced_idle_share": (1.0 - busy / untraced_wall
                                if untraced_wall else None),
        "untraced_wall_speculation_off_s": untraced_wall_no_spec,
        "by_class_s": by_class,
        "top_kernels": [[n[:80], s] for n, s in top],
    }), flush=True)


def fill_to_decode(eng, prompts, new_tokens):
    """Submit ``prompts`` and step until every one is in the cache, so
    the engine's next steps are all decode bursts."""
    for p in prompts:
        eng.submit(p, new_tokens)
    while any(r.prefilled < r.prompt_len
              for r in eng.scheduler.active.values()) \
            or eng.scheduler.waiting:
        eng.step()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (MAIN_TIERS, main_path_engine, main_path_model,
                            main_path_prompts)
    from tpu_flash_torch.engine.metrics import EngineMetrics
    from tpu_flash_torch.models import LLAMA3_8B

    model, params = main_path_model("cuda")
    prompts = main_path_prompts(LLAMA3_8B.vocab_size)
    with torch.no_grad():
        for kv_dtype, ring in MAIN_TIERS:
            eng = main_path_engine(model, params, kv_dtype, ring, prompts)
            for p in prompts:
                eng.submit(p, 1)
            eng.metrics = EngineMetrics()
            wall, kernels = trace(eng.run)
            report("prefill", kv_dtype, wall, kernels,
                   sum(len(p) for p in prompts), eng.metrics.route_counts())
            if "--prefill-only" in sys.argv[1:]:
                eng.close()
                continue
            # The decode window three times, the same greedy work each
            # time: untraced for its wall time, untraced with speculation
            # off, then traced for its kernels.
            untraced = []
            for spec_k in (eng.speculation_k, 0):
                fill_to_decode(eng, prompts, 32)
                eng.speculation_k, saved = spec_k, eng.speculation_k
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run()
                torch.cuda.synchronize()
                untraced.append(time.perf_counter() - t0)
                eng.speculation_k = saved
            fill_to_decode(eng, prompts, 32)
            eng.metrics = EngineMetrics()
            wall, kernels = trace(eng.run)
            report("decode", kv_dtype, wall, kernels,
                   eng.metrics.decode_tokens, eng.metrics.route_counts(),
                   *untraced)
            eng.close()
        kv_dtype, ring = MAIN_TIERS[0]
        eng = main_path_engine(model, params, kv_dtype, ring, prompts,
                               paged_prefill=False)
        eng.metrics = EngineMetrics()

        def staggered():
            for p in prompts[:4]:
                eng.submit(p, 1)
            eng.step()
            for p in prompts[4:]:
                eng.submit(p, 1)
            eng.run()

        wall, kernels = trace(staggered)
        report("prefill staggered, paged_prefill=False", kv_dtype, wall,
               kernels, sum(len(p) for p in prompts),
               eng.metrics.route_counts())
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
