#!/usr/bin/env python3
"""Tiles and exponential of the bf16 forward kernel, swept on one CUDA card.

    python3 tools/torch_fwd_sweep.py [--json out.json] [--rounds N]

Writes one harness source under build/: the text of
``tpu_flash_torch/csrc/flash_fwd.cu`` followed by one C entry point for
each variant below (the tensor-core kernel is a template on its tiles
and on exp2). Builds it with nvcc and times each variant by CUDA events
around its launches inside ``flash_fwd``, in turns: every round runs the
variants of a shape in order and then in reverse, so none gains from its
place. Shapes: ``chip_smoke.py`` phase 3's main causal prompt (b 4, 32 q /
8 kv heads x 512, d 128) and history chunk (512 rows at offset 1024 over
1536), phase 6's training forward (b 4 x 2048), b 1 x 2048 at d 64, and
Gemma-2-9B's global layer (b 1, 16 / 8 heads x 8192, d 256, cap 50).
Each variant's output is held against the plain version at phase 3's
bar for each row. One JSON line a (shape, variant): the median ms over
the rounds, every reading, its largest error as a share of its row's
bar, and its registers and spill bytes; the variant the source builds
is marked ``built``. Exit 1 if
any variant misses its bar. Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (d, q rows a block, exp2, the option-free score path built): every
# block stages one 128-row softmax step.
VARIANTS = [(d, bq, exp2, True) for d in (128, 64, 256) for bq in (128, 64)
            for exp2 in (False, True)] + [(256, 128, True, False)]
BUILT = {64: (64, True, True), 128: (64, True, True),
         256: (128, True, True)}
# name: (d, b, hq, hkv, sq, skv, options, q std)
SHAPES = {
    "prompt_causal": (128, 4, 32, 8, 512, 512, dict(causal=True), 1.0),
    "chunk_q_offset": (128, 4, 32, 8, 512, 1536,
                       dict(causal=True, q_offset=1024), 1.0),
    "train_causal": (128, 4, 32, 8, 2048, 2048, dict(causal=True), 1.0),
    "d64_causal": (64, 1, 32, 8, 2048, 2048, dict(causal=True), 1.0),
    "gemma2_global": (256, 1, 16, 8, 8192, 8192,
                      dict(causal=True, softcap=50.0), 10.0),
}
def entry_name(variant) -> str:
    return "fwd_" + "_".join(str(int(x)) for x in variant)


HARNESS = "\n".join(
    f'extern "C" int {entry_name((d, bq, e, pl))}(FLASH_FWD_ARGS) {{\n'
    f"  return launch_bf16<tc::FwdTiles<{d}, {bq}, BK, BK>, "
    f"{str(e).lower()}, {str(pl).lower()}>(\n"
    f"      FLASH_FWD_PARAMS, batch, static_cast<cudaStream_t>(stream));\n}}"
    for d, bq, e, pl in VARIANTS) + "\n"


def registers(build_log):
    """{variant: (registers, spill store bytes, spill load bytes)} of
    the tensor-core instances (the builds for calls in which every row
    sees a key), from nvcc's -Xptxas -v log."""
    import re

    out, cur = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Function properties for \S*flash_fwd_tc_kernel\S*"
                      r"FwdTilesILi(\d+)ELi(\d+)E\S*?ELb(\d)ELb(\d)ELb0E",
                      ln)
        if m:
            cur = (int(m[1]), int(m[2]), bool(int(m[3])), bool(int(m[4])))
            out[cur] = [None, None, None]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[cur][1:] = [int(m[1]), int(m[2])]
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur][0] = int(m[1])
            cur = None
    return out


def harness_kernels():
    """{variant: CudaKernel} over one harness source, built once."""
    from tpu_flash_torch.ops import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "fwd_sweep.cu"
    path.write_text((build.CSRC_DIR / "flash_fwd.cu").read_text() + HARNESS)
    kernels = {}
    for variant in VARIANTS:
        name = entry_name(variant)
        k = build.CudaKernel(name, name, build.FLASH_FWD.argtypes,
                             replaces="-")
        k.source = path  # the harness, outside csrc/
        kernels[variant] = k
    first = kernels[VARIANTS[0]]
    first.finish_build(first.start_build())
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_query, kernel_ms, row_bars
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import forward as fw

    rounds = 3
    if "--rounds" in sys.argv[1:]:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = harness_kernels()
    regs = registers(kernels[VARIANTS[0]].build_log)
    gpu = gpu_query()
    rows = []
    for shape, (d, b, hq, hkv, sq, skv, kw, qstd) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(5)
        q = (qstd * torch.randn(b, hq, sq, d, generator=g,
                                device="cuda")).bfloat16()
        k, v = (torch.randn(b, hkv, skv, d, generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        scale = d ** -0.5
        ref = fw.flash_fwd_plain(q, k, v, sm_scale=scale, **kw)
        bars = row_bars(ref).clamp_min(1e-30)
        mine = [x for x in VARIANTS if x[0] == d]
        errs, ms = {}, {x: [] for x in mine}

        def run():
            return fw.flash_fwd(q, k, v, sm_scale=scale, **kw)

        saved = build.FLASH_FWD
        try:
            for x in mine:
                build.FLASH_FWD = kernels[x]
                out = run()
                torch.cuda.synchronize()
                errs[x] = float(((out.float() - ref.float()).abs().amax(-1)
                                 / bars).max())
            for _ in range(rounds):
                for x in mine + mine[::-1]:
                    build.FLASH_FWD = kernels[x]
                    ms[x].append(kernel_ms(kernels[x], run, 5))
        finally:
            build.FLASH_FWD = saved
        for x in mine:
            row = dict(shape=shape, d=d, block_q=x[1], exp2=x[2],
                       plain_path=x[3], built=BUILT[d] == x[1:],
                       registers_spill_stores_loads=regs.get(x),
                       dims=[b, hq, hkv, sq, skv],
                       options=kw, ms=statistics.median(ms[x]),
                       ms_all=ms[x], err_of_bar=errs[x],
                       ok=errs[x] <= 1.0, gpu=gpu)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if "--json" in sys.argv[1:]:
        with open(sys.argv[sys.argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
