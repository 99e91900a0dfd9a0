#!/usr/bin/env python3
"""Split shapes of the paged decode kernel (K4), swept on one CUDA card.

    python3 tools/torch_decode_sweep.py [--json out.json] [--rounds N]
    python3 tools/torch_decode_sweep.py --parts [--json out.json]

``tpu_flash_torch/csrc/paged_decode.cu`` cuts each (batch row, kv head)
over a thread-block cluster of ``slices`` blocks (a launch argument,
``ops.decode.paged.SLICES``) and streams K/V through ``DECODE_STAGES``
staged tiles (a compile-time constant, 3 in the product; the sweep
builds 2 and 4 beside it, all at once). Only the cluster design is built
(no multi-kernel split to compare).
Shapes (``chip_smoke.py`` phase 3's decode inputs: b 8, 32 q / 8 kv
heads, d 128, a 2048-token table): every row at 2048 tokens, and a
serving-like ragged batch (phase 4's prompt lengths 100..1500 plus a few
decoded tokens), each on int8 mxu pages with the 128-token ring (phase
4's main cache), bf16 pages and fp8-native pages (512-token pages, the
auto layout). Every (slices, stages) is timed in turns: each round runs
the variants in order and then in reverse. A time is device time
(``chip_smoke.device_ms``: CUDA events around each call, the L2 cache
overwritten before it, the host's enqueue, which outlasts the kernel
here, hidden behind a spin kernel). Each variant's output is held against the
plain version and the built variant bit for bit. One JSON line a (shape,
variant): the median ms, every reading, the differing element counts;
the variant the wrapper picks is marked ``built``. Exit 1 if any variant
differs from the plain version.

``--parts`` times builds with parts of the kernel left out
(``DECODE_OMIT``: the score dots, the P V products, the K/V staging, the
softmax and P quantization) against the whole kernel at the full-length
int8 + ring and bf16 shapes; their outputs are wrong, so nothing is held.

Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SLICES = (1, 2, 3, 4, 6, 8)
STAGES = (2, 3, 4)
PRODUCT_STAGES = 3
# Phase 4's eight prompt lengths after 16 decoded tokens.
SERVING_LENGTHS = tuple(100 + 200 * i + 16 for i in range(8))
PARTS = {0: "nothing", 1: "score dots", 2: "P V products",
         4: "K/V staging", 8: "softmax and P quantization", 15: "all four"}
ITERS = 20


def shapes(dev):
    """name: run() at the sweep's shapes."""
    import torch

    from chip_smoke import decode_inputs
    from tpu_flash_torch.ops.decode import paged as dp

    out = {}
    for tier, ring, ps, kw in (("int8", 128, 128, dict(int8_mxu=True)),
                               ("bfloat16", 0, 128, {}),
                               ("fp8", 128, 512, dict(fp8_native=True))):
        q, kp, vp, full, table, rk = decode_inputs(dev, tier, ring, ps)
        serving = torch.tensor(SERVING_LENGTHS, dtype=torch.int32,
                               device=dev)
        k_tier, v_tier = (dp.side_tier(x, int8_mxu=True, fp8_native=True)[0]
                          for x in (kp, vp))
        pps = table.shape[1]
        ppb = dp.pages_per_block(ps, pps, True)
        picked = dp.launch_slices(q, k_tier, v_tier, 8, ps, pps, ppb * ps,
                                  ring)
        for name, lens in (("full", full), ("serving", serving)):
            def run(q=q, kp=kp, vp=vp, lens=lens, table=table,
                    args=dict(kw, **rk)):
                return dp.paged_attention(q, kp, vp, lens, table, **args)

            out[f"{tier}{'_ring' if ring else ''}_{name}"] = (run, picked)
    return out


def in_turns(variants, use, run, rounds):
    """{variant: [ms, twice a round]}: each round times the variants in
    order and then in reverse, ``use(variant)`` making it the one the
    wrapper launches."""
    from chip_smoke import device_ms

    ms = {x: [] for x in variants}
    for _ in range(rounds):
        for x in variants + variants[::-1]:
            use(x)
            ms[x].append(device_ms(run, ITERS))
    return ms


def differing(a, b) -> int:
    return int((a != b).sum())


def variant_builds(tag, defines):
    """{key: CudaKernel}: the K4 source built once for each
    ``defines[key]`` (a line put before it; the library named after
    ``tag`` and the key), the nvcc runs started together; the product
    library for the key whose line is None."""
    from tpu_flash_torch.ops import build

    product = build.PAGED_DECODE
    text = product.source.read_text()
    libs = {}
    for key, line in defines.items():
        if line is None:
            libs[key] = product
            continue
        name = f"paged_decode_{tag}{key}"
        path = build.BUILD_DIR / f"{name}.cu"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(f"{line}\n{text}")
        k = build.CudaKernel(name, product.symbol, product.argtypes,
                             replaces="-")
        k.source = path  # outside csrc/; csrc/ stays on the include path
        libs[key] = k
    procs = [(k, k.start_build()) for k in libs.values()]
    for k, proc in procs:
        k.finish_build(proc)
    return libs


def sweep(rounds, gpu):
    import torch

    from chip_smoke import plain_versions
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.decode import paged as dp

    libs = variant_builds("stages", {
        st: None if st == PRODUCT_STAGES else f"#define DECODE_STAGES {st}"
        for st in STAGES})
    variants = [(s, st) for s in SLICES for st in STAGES]
    rows = []
    saved = dp.SLICES, build.PAGED_DECODE

    def use(x):
        dp.SLICES, build.PAGED_DECODE = x[0], libs[x[1]]

    try:
        for shape, (run, slices) in shapes("cuda").items():
            with plain_versions():
                ref = run()
            dp.SLICES, build.PAGED_DECODE = None, libs[PRODUCT_STAGES]
            built = run()
            torch.cuda.synchronize()
            picked = (slices, PRODUCT_STAGES)
            outs = {}
            for x in variants:
                use(x)
                outs[x] = run()
            torch.cuda.synchronize()
            ms = in_turns(variants, use, run, rounds)
            for x in variants:
                row = dict(shape=shape, slices=x[0], stages=x[1],
                           built=x == picked, ms=statistics.median(ms[x]),
                           ms_all=ms[x],
                           differing_plain=differing(outs[x], ref),
                           differing_built=differing(outs[x], built),
                           gpu=gpu)
                row["ok"] = row["differing_plain"] == 0
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        dp.SLICES, build.PAGED_DECODE = saved
    return rows


def parts(rounds, gpu):
    """The kernel with parts left out, in turns with the whole kernel."""
    from tpu_flash_torch.ops import build

    product = build.PAGED_DECODE
    libs = variant_builds("omit", {
        bits: f"#define DECODE_OMIT {bits}" for bits in PARTS})

    def use(bits):
        build.PAGED_DECODE = libs[bits]

    runs = shapes("cuda")
    rows = []
    try:
        for shape in ("int8_ring_full", "bfloat16_full"):
            ms = in_turns(list(PARTS), use, runs[shape][0], rounds)
            whole = statistics.median(ms[0])
            for bits, what in PARTS.items():
                med = statistics.median(ms[bits])
                row = dict(shape=shape, omit=bits, left_out=what, ms=med,
                           ms_all=ms[bits], share_saved=1.0 - med / whole,
                           ok=True, gpu=gpu)
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        build.PAGED_DECODE = product
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_query

    rounds = 2
    if "--rounds" in sys.argv[1:]:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
    gpu = gpu_query()
    rows = parts(rounds, gpu) if "--parts" in sys.argv[1:] else sweep(
        rounds, gpu)
    if "--json" in sys.argv[1:]:
        with open(sys.argv[sys.argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
