#!/usr/bin/env python3
"""Tile shapes of the bf16 backward kernels, swept on one CUDA card.

    python3 tools/torch_bwd_sweep.py [--json out.json]

Writes one harness source under build/: the text of
``tpu_flash_torch/csrc/flash_bwd.cu`` followed by one C entry point for
each tile shape below (the kernels are templates on their tiles). Builds
it with nvcc and times each dK/dV and dQ variant inside ``flash_bwd``
(the other kernel as built), by CUDA events around its launches, at the
shapes ``chip_smoke.py`` phase 3 holds the backward at: b 4, 32 q / 8 kv
heads x 2048, d 128, causal; Gemma-2-9B's b 1, 16 / 8 heads x 2048 at
d 256 under its cap of 50; b 1, 32 / 8 heads x 2048 at d 64. Each
variant's outputs are held against the plain version with ``round_p``
at phase 3's bar for each row. One JSON line a variant: its ms and its
largest error as a share of its row's bar, the shape the source builds
marked
``built``; exit 1 if any variant misses its bar. Needs a CUDA card, nvcc
and PyTorch.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (kernel, d, rows the block owns, rows a step, warps sharing 16 rows)
# dkv: (D, BKV, BQ, DSPLIT); dq: (D, BQ, BKV). The first of each width
# is the one csrc/flash_bwd.cu builds (Tiles<D>).
VARIANTS = [
    ("dkv", 128, 64, 32, 1), ("dkv", 128, 64, 64, 1),
    ("dkv", 128, 128, 32, 1), ("dkv", 128, 64, 32, 2),
    ("dq", 128, 64, 32), ("dq", 128, 64, 64), ("dq", 128, 128, 32),
    ("dkv", 256, 32, 32, 2), ("dkv", 256, 64, 32, 2),
    ("dkv", 256, 64, 16, 2),
    ("dq", 256, 64, 16), ("dq", 256, 64, 32), ("dq", 256, 128, 32),
    ("dkv", 64, 64, 32, 1), ("dkv", 64, 64, 64, 1),
    ("dkv", 64, 128, 32, 1),
    ("dq", 64, 64, 32), ("dq", 64, 64, 64), ("dq", 64, 128, 32),
]
SHAPES = {128: (4, 32, 8, dict(causal=True)),
          256: (1, 16, 8, dict(causal=True, softcap=50.0)),
          64: (1, 32, 8, dict(causal=True))}
SEQ = 2048
HARNESS = """
namespace {
template <class G>
int sweep_dkv(const BwdParams& p, int batch, cudaStream_t s) {
  cudaFuncSetAttribute(tc::flash_bwd_dkv_kernel<G>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.skv + G::BKV - 1) / G::BKV, p.hq, batch);
  tc::flash_bwd_dkv_kernel<G><<<grid, G::THREADS, G::smem, s>>>(p);
  return (int)cudaGetLastError();
}
template <class G>
int sweep_dq(const BwdParams& p, int batch, cudaStream_t s) {
  cudaFuncSetAttribute(tc::flash_bwd_dq_kernel<G>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.sq + G::BQ - 1) / G::BQ, p.hq, batch);
  tc::flash_bwd_dq_kernel<G><<<grid, G::THREADS, G::smem, s>>>(p);
  return (int)cudaGetLastError();
}
}  // namespace
"""


def entry(v) -> str:
    name = "_".join(map(str, v))
    if v[0] == "dkv":
        tiles = f"tc::DkvTiles<{v[1]}, {v[2]}, {v[3]}, {v[4]}>"
    else:
        tiles = f"tc::DqTiles<{v[1]}, {v[2]}, {v[3]}>"
    return (f'extern "C" int {name}(FLASH_BWD_ARGS) {{\n'
            f"  return sweep_{v[0]}<{tiles}>(FLASH_BWD_PARAMS, batch,\n"
            f"      static_cast<cudaStream_t>(stream));\n}}\n")


def harness_kernels():
    """{variant: CudaKernel} over one harness source, built once."""
    from tpu_flash_torch.ops import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "bwd_sweep.cu"
    path.write_text((build.CSRC_DIR / "flash_bwd.cu").read_text() + HARNESS
                    + "".join(entry(v) for v in VARIANTS))
    kernels = {}
    for v in VARIANTS:
        name = "_".join(map(str, v))
        k = build.CudaKernel(name, name, build.FLASH_BWD_DKV.argtypes,
                             replaces="-")
        k.source = path  # the harness, outside csrc/
        kernels[v] = k
    first = kernels[VARIANTS[0]]
    first.finish_build(first.start_build())
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import bwd_row_bars, gpu_query, kernel_ms
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = harness_kernels()
    gpu = gpu_query()
    rows = []
    for d, (b, hq, hkv, kw) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(3)
        qstd = 4.0 if d == 256 else 1.0  # Gemma-2's cap bends the scores
        q = (qstd * torch.randn(b, hq, SEQ, d, generator=g,
                                device="cuda")).bfloat16()
        k, v = (torch.randn(b, hkv, SEQ, d, generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        do = torch.randn(b, hq, SEQ, d, generator=g, device="cuda").bfloat16()
        o, lse = flash_fwd_plain(q, k, v, sm_scale=d ** -0.5, save_lse=True,
                                 **kw)
        args = (q, k, v, o, do, lse)
        ref = bw.flash_bwd_plain(*args, sm_scale=d ** -0.5, round_p=True,
                                 **kw)
        for var in VARIANTS:
            if var[1] != d:
                continue
            which = var[0]
            attr = "FLASH_BWD_DKV" if which == "dkv" else "FLASH_BWD_DQ"
            saved = getattr(build, attr)
            kern = kernels[var]
            setattr(build, attr, kern)
            try:
                def run():
                    return bw.flash_bwd(*args, sm_scale=d ** -0.5, **kw)

                out = run()
                torch.cuda.synchronize()
                pick = (1, 2) if which == "dkv" else (0,)
                err = max(float(((out[i].float() - ref[i].float()).abs()
                                 .amax(-1) / bwd_row_bars(
                                     ref[i], ("dq", "dk", "dv")[i])[0]
                                 .clamp_min(1e-30)).max()) for i in pick)
                ms = kernel_ms(kern, run, 5)
            finally:
                setattr(build, attr, saved)
            row = dict(kernel=which, d=d, tiles=list(var[2:]),
                       built=var == next(x for x in VARIANTS
                                         if x[:2] == var[:2]),
                       shape=[b, hq, hkv, SEQ], options=kw, ms=ms,
                       err_of_bar=err, ok=err <= 1.0, gpu=gpu)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if "--json" in sys.argv[1:]:
        with open(sys.argv[sys.argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
