#!/usr/bin/env python3
"""Where the port's training time goes on one CUDA card.

    python3 tools/torch_train_profile.py

Trains the model of ``chip_smoke.py`` phase 6 (Llama-3-8B widths cut to 4
of its 32 layers, seeded random bf16 weights, batch 4 x 2048 tokens,
AdamW with a norm clip of 1.0) on one repeated seeded batch: two warm-up
steps, three steps untraced for their wall time, then three steps traced
with ``torch.profiler`` (device activity only). Prints one JSON line: the
wall time of each window, summed device kernel time, the device's idle
share (1 - kernel time / wall, one stream; against the traced and the
untraced wall), kernel time by class (flash_fwd, flash_bwd, matmul,
optimizer: the foreach kernels of AdamW and the norm clip, other) and the
heaviest kernels. Needs a CUDA card, nvcc and PyTorch.
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
    ("flash_bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")),
    ("optimizer", ("multi_tensor_apply",)),
)
STEPS = 3


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (SEED, TRAIN_LR, TRAIN_TOKENS, gpu_query,
                            train_batch, train_model)
    from torch_serve_profile import trace
    from tpu_flash_torch.parallel import make_train_step, param_leaves

    model, params = train_model("cuda")
    batch = train_batch("cuda", model.config.vocab_size, SEED + 6)
    opt = torch.optim.AdamW(param_leaves(params), lr=TRAIN_LR,
                            weight_decay=0.01)
    step = make_train_step(model, optimizer=opt, max_grad_norm=1.0)

    def steps():
        for _ in range(STEPS):
            step(params, batch)

    for _ in range(2):
        step(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    wall, kernels = trace(steps)
    busy = sum(kernels.values())
    by_class = {}
    for name, sec in kernels.items():
        cls = classify(name)
        by_class[cls] = by_class.get(cls, 0.0) + sec
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    positions = STEPS * TRAIN_TOKENS[0] * (TRAIN_TOKENS[1] - 1)
    print(json.dumps({
        "window": "train", "gpu": gpu_query(), "steps": STEPS,
        "layers": model.config.num_layers, "tokens": positions,
        "wall_s": wall, "untraced_wall_s": untraced,
        "train_tok_per_s_untraced": positions / untraced,
        "device_kernel_s": busy,
        "idle_share": 1.0 - busy / wall,
        "untraced_idle_share": 1.0 - busy / untraced,
        "by_class_s": by_class,
        "top_kernels": [[n[:80], s] for n, s in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
