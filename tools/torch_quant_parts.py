#!/usr/bin/env python3
"""What each part of the quantized-input forward's tiled step (K10,
``csrc/quant_fwd.cu``) costs, on one CUDA card.

    python3 tools/torch_quant_parts.py [--rounds N] [--json out.jsonl]

Builds the kernel once as it is and once for each ``QUANT_FWD_OMIT`` bit
(the part left out: the exp, the score products, the P V products, the
score transform, V's widening with fp8 K's limb split), a ``#define``
line before a copy of the source under ``build/``, and times config 4 (b1,
32/8 heads, s8192, d 128, causal, bf16 out) in int8 and fp8 native with
every build in turns (in order, then reversed; ``--rounds`` rounds,
default 2): CUDA-event ms of 3 calls back to back, the median of each
build, and the share of the whole build's time that leaving the part out
saves. A build with a part left out computes wrong outputs; no bar is
held. Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PARTS = {0: "nothing", 1: "exp", 2: "score products", 4: "P V products",
         8: "score transform", 16: "V widening and fp8 K limb split"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_quant_parts: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import quantized as qz

    rounds = 2
    if "--rounds" in sys.argv:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
    out = None
    if "--json" in sys.argv:
        out = open(sys.argv[sys.argv.index("--json") + 1], "w")

    product = build.QUANT_FWD
    text = product.source.read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for bits in PARTS:
        path = build.BUILD_DIR / f"quant_fwd_omit{bits}.cu"
        path.write_text(f"#define QUANT_FWD_OMIT {bits}\n{text}")
        kernels[bits] = build.CudaKernel(
            product.name, product.symbol, product.argtypes, replaces="-",
            source=os.path.relpath(path.with_suffix(""), build.CSRC_DIR))
    procs = [(k, k.start_build()) for k in kernels.values()]
    for k, proc in procs:
        k.finish_build(proc)
    gpu = cs.gpu_query()
    for tier, dtype_name, kw in (
            ("int8", "int8", dict(causal=True)),
            ("fp8_native", "fp8", dict(causal=True, fp8_native=True))):
        qi = cs.quant_inputs("cuda", dtype_name, cs.QUANT_SEQ)[3]
        ms = {bits: [] for bits in PARTS}
        try:
            for _ in range(rounds):
                for bits in list(PARTS) + list(PARTS)[::-1]:
                    build.QUANT_FWD = kernels[bits]
                    ms[bits].append(cs.time_ms(
                        lambda: qz.quant_fwd(*qi[:6], dtype_name=dtype_name,
                                             sm_scale=cs.SCALE, **kw), 3,
                        warmup=1))
        finally:
            build.QUANT_FWD = product
        whole = statistics.median(ms[0])
        for bits, what in PARTS.items():
            med = statistics.median(ms[bits])
            row = dict(tier=tier, omit=bits, left_out=what, ms=med,
                       ms_all=ms[bits], share_saved=1.0 - med / whole,
                       gpu=gpu)
            line = json.dumps(row)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
        del qi
    return 0


if __name__ == "__main__":
    sys.exit(main())
