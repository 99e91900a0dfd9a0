#!/usr/bin/env python3
"""Tile shapes of the backward kernels, swept on one CUDA card.

    python3 tools/torch_bwd_sweep.py [--dtype bfloat16|float32]
                                     [--json out.json]
    python3 tools/torch_bwd_sweep.py --seeds N [--json out.json]

Writes one harness source under build/: the text of
``tpu_flash_torch/csrc/flash_bwd.cu`` followed by one C entry point for
each tile shape below (the kernels are templates on their tiles). Builds
it with nvcc and times each dK/dV and dQ variant inside ``flash_bwd``
(the other kernel as built), by CUDA events around its launches, at the
shapes ``chip_smoke.py`` phase 3 holds the backward at: b 4 (bf16) or b
2 (f32), 32 q / 8 kv heads x 2048, d 128, causal; Gemma-2-9B's b 1, 16 /
8 heads x 2048 at d 256 under its cap of 50; b 1, 32 / 8 heads x 2048 at
d 64. bf16 variants are the tensor-core kernels (``tc::``), f32 ones the
three-pass TF32 kernels (``tc::tf32::``). Each variant's outputs are
held against the plain version (with ``round_p`` in bf16) at phase 3's
bar for each row. One JSON line a variant: its ms and its largest error
as a share of its row's bar, the shape the source builds marked
``built``; exit 1 if any variant misses its bar. ``--dtype`` builds and
times one dtype's variants only.

``--seeds N`` instead holds the f32 kernels as built, and as built with
``FLASH_BWD_RETAKE_DP 0`` (dP never taken again in the plain version's
order where dP - di cancels), at phase 3's f32 backward cases (b 2, 32 /
8 heads x 2048, d 128, causal; b 1, 32 / 8 x 2048, d 64, causal;
Gemma-2-9B's b 1, 16 / 8 x 2048, d 256, q std 10, cap 50) and the card
test's ALiBi + segments case (b 2, 8 / 2 heads x 256, d 128), each with
inputs from seeds 1 .. N. One JSON line a (case, seed): for each build
the rows of dq, dk and dv past their bar (2^-12 of the row's max |ref|)
and the largest error as a share of its row's bar; a last line sums the
rows missed over the seeds. Exit 1 if the kernels as built miss a row.
Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (kernel, d, rows the block owns, rows a step, warps sharing 16 rows)
# dkv: (D, BKV, BQ, DSPLIT); dq: (D, BQ, BKV). The first of each width
# is the one
# csrc/flash_bwd.cu builds (Tiles<D>; F32_VARIANTS: the f32 kernels'
# tf32::Tiles<D>).
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
F32_VARIANTS = [
    ("dkv", 128, 64, 16, 1), ("dkv", 128, 64, 32, 1), ("dkv", 128, 32, 16, 1),
    ("dq", 128, 64, 32), ("dq", 128, 64, 16), ("dq", 128, 128, 16),
    ("dkv", 256, 64, 16, 2), ("dkv", 256, 32, 16, 2),
    ("dq", 256, 64, 32), ("dq", 256, 64, 16),
    ("dkv", 64, 64, 16, 1), ("dkv", 64, 64, 32, 1),
    ("dq", 64, 64, 32), ("dq", 64, 64, 16),
]
SHAPES = {128: (4, 32, 8, dict(causal=True)),
          256: (1, 16, 8, dict(causal=True, softcap=50.0)),
          64: (1, 32, 8, dict(causal=True))}
F32_BATCH = {128: 2}  # phase 3's f32 case; other widths as SHAPES
SEQ = 2048
HARNESS = """
namespace {
template <class G, class K>
int sweep_dkv(K kernel, const BwdParams& p, int batch, cudaStream_t s) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.skv + G::BKV - 1) / G::BKV, p.hq, batch);
  kernel<<<grid, G::THREADS, G::smem, s>>>(p);
  return (int)cudaGetLastError();
}
template <class G, class K>
int sweep_dq(K kernel, const BwdParams& p, int batch, cudaStream_t s) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)G::smem);
  dim3 grid((p.sq + G::BQ - 1) / G::BQ, p.hq, batch);
  kernel<<<grid, G::THREADS, G::smem, s>>>(p);
  return (int)cudaGetLastError();
}
}  // namespace
"""


def variant_name(dtype, v) -> str:
    return "_".join(map(str, (dtype, *v)))


def entry(dtype, v) -> str:
    ns = "tc::tf32" if dtype == "float32" else "tc"
    kind = "DkvTiles" if v[0] == "dkv" else "DqTiles"
    tiles = f"{ns}::{kind}<{', '.join(map(str, v[1:]))}>"
    return (f'extern "C" int {variant_name(dtype, v)}(FLASH_BWD_ARGS) {{\n'
            f"  using G = {tiles};\n"
            f"  return sweep_{v[0]}<G>({ns}::flash_bwd_{v[0]}_kernel<G>,\n"
            f"      FLASH_BWD_PARAMS, batch,\n"
            f"      static_cast<cudaStream_t>(stream));\n}}\n")


def all_variants():
    dtypes = ("bfloat16", "float32")
    if "--dtype" in sys.argv:
        dtypes = (sys.argv[sys.argv.index("--dtype") + 1],)
    return ([("bfloat16", v) for v in VARIANTS if "bfloat16" in dtypes]
            + [("float32", v) for v in F32_VARIANTS if "float32" in dtypes])


def harness_kernels():
    """{variant: CudaKernel} over one harness source, built once."""
    from tpu_flash_torch.ops import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "bwd_sweep.cu"
    path.write_text((build.CSRC_DIR / "flash_bwd.cu").read_text() + HARNESS
                    + "".join(entry(*dv) for dv in all_variants()))
    kernels = {}
    for dv in all_variants():
        name = variant_name(*dv)
        k = build.CudaKernel(name, name, build.FLASH_BWD_DKV.argtypes,
                             replaces="-")
        k.source = path  # the harness, outside csrc/
        kernels[dv] = k
    first = kernels[all_variants()[0]]
    first.finish_build(first.start_build())
    return kernels


def no_retake_kernels():
    """{ops.build attribute: CudaKernel} of flash_bwd.cu built with
    FLASH_BWD_RETAKE_DP 0, started and finished here."""
    from tpu_flash_torch.ops import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "flash_bwd_no_retake.cu"
    path.write_text("#define FLASH_BWD_RETAKE_DP 0\n"
                    + (build.CSRC_DIR / "flash_bwd.cu").read_text())
    kernels = {}
    for attr in ("FLASH_BWD_DKV", "FLASH_BWD_DQ"):
        base = getattr(build, attr)
        k = build.CudaKernel(base.name, base.symbol, base.argtypes,
                             replaces="-")
        k.source = path  # outside csrc/
        kernels[attr] = k
    first = kernels["FLASH_BWD_DKV"]
    first.finish_build(first.start_build())
    return kernels


# --seeds: (name, b, hq, hkv, s, d, q std, options; "alibi" and
# "segments" are made on the card as the card test makes them).
SEED_CASES = [
    ("f32_causal", 2, 32, 8, 2048, 128, 1.0, dict(causal=True)),
    ("f32_d64_causal", 1, 32, 8, 2048, 64, 1.0, dict(causal=True)),
    ("f32_gemma2_global", 1, 16, 8, 2048, 256, 10.0,
     dict(causal=True, softcap=50.0)),
    ("f32_alibi_segments", 2, 8, 2, 256, 128, 1.0,
     dict(causal=True, alibi=True, segments=3)),
]


def seed_sweep(n: int) -> int:
    import torch

    from chip_smoke import gpu_query
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"built": {}, "no_retake": no_retake_kernels()}
    gpu = gpu_query()
    rows, totals = [], {}
    for name, b, hq, hkv, s, d, qstd, opts in SEED_CASES:
        for seed in range(1, n + 1):
            g = torch.Generator(device="cuda").manual_seed(seed)
            q = qstd * torch.randn(b, hq, s, d, generator=g, device="cuda")
            k, v = (torch.randn(b, hkv, s, d, generator=g, device="cuda")
                    for _ in range(2))
            do = torch.randn(b, hq, s, d, generator=g, device="cuda")
            kw = {x: y for x, y in opts.items()
                  if x not in ("alibi", "segments")}
            if opts.get("alibi"):
                kw["alibi"] = torch.linspace(0.3, 0.01, hq, device="cuda")
            if opts.get("segments"):  # the card test's _segment_ids
                i = (torch.arange(s, device="cuda")[None, :]
                     + 7 * torch.arange(b, device="cuda")[:, None])
                kw["q_seg"] = kw["kv_seg"] = (
                    i * opts["segments"] // (s + 7 * b)).int()
            scale = d ** -0.5
            o, lse = flash_fwd_plain(q, k, v, sm_scale=scale, save_lse=True,
                                     **kw)
            args = (q, k, v, o, do, lse)
            ref = bw.flash_bwd_plain(*args, sm_scale=scale, **kw)
            row = dict(case=name, seed=seed, shape=[b, hq, hkv, s, d],
                       options=sorted(opts), gpu=gpu)
            for which, kernels in builds.items():
                saved = {a: getattr(build, a) for a in kernels}
                for a, kern in kernels.items():
                    setattr(build, a, kern)
                try:
                    out = bw.flash_bwd(*args, sm_scale=scale, **kw)
                    torch.cuda.synchronize()
                finally:
                    for a, kern in saved.items():
                        setattr(build, a, kern)
                missed, worst = {}, 0.0
                for gname, a_, r_ in zip(("dq", "dk", "dv"), out, ref):
                    err = (a_ - r_).abs().amax(-1)
                    bars = 2.0 ** -12 * r_.abs().amax(-1)
                    missed[gname] = int((err > bars).sum())
                    worst = max(worst, float((err / bars.clamp_min(1e-30))
                                             .max()))
                row[which] = dict(rows_missed=missed, err_of_bar=worst)
                t = totals.setdefault((name, which), {})
                for gname, m in missed.items():
                    t[gname] = t.get(gname, 0) + m
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = dict(seeds=n, rows_missed={f"{c}/{w}": t
                                         for (c, w), t in totals.items()},
                   gpu=gpu)
    print(json.dumps(summary), flush=True)
    if "--json" in sys.argv[1:]:
        with open(sys.argv[sys.argv.index("--json") + 1], "w") as f:
            json.dump(dict(rows=rows, summary=summary), f)
    return 0 if all(sum(r["built"]["rows_missed"].values()) == 0
                    for r in rows) else 1


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    if "--seeds" in sys.argv[1:]:
        return seed_sweep(int(sys.argv[sys.argv.index("--seeds") + 1]))
    from chip_smoke import bwd_row_bars, gpu_query, kernel_ms
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = harness_kernels()
    gpu = gpu_query()
    rows = []
    for (d, (b, hq, hkv, kw)), dtype in [
            (x, y) for y in sorted({dv[0] for dv in all_variants()})
            for x in SHAPES.items()]:
        g = torch.Generator(device="cuda").manual_seed(3)
        qstd = 4.0 if d == 256 else 1.0  # Gemma-2's cap bends the scores
        dt = getattr(torch, dtype)
        rp = dt == torch.bfloat16
        if not rp:
            b = F32_BATCH.get(d, b)
        q = (qstd * torch.randn(b, hq, SEQ, d, generator=g,
                                device="cuda")).to(dt)
        k, v = (torch.randn(b, hkv, SEQ, d, generator=g,
                            device="cuda").to(dt) for _ in range(2))
        do = torch.randn(b, hq, SEQ, d, generator=g, device="cuda").to(dt)
        o, lse = flash_fwd_plain(q, k, v, sm_scale=d ** -0.5, save_lse=True,
                                 **kw)
        args = (q, k, v, o, do, lse)
        ref = bw.flash_bwd_plain(*args, sm_scale=d ** -0.5, round_p=rp,
                                 **kw)
        variants = VARIANTS if rp else F32_VARIANTS
        for var in variants:
            if var[1] != d:
                continue
            which = var[0]
            attr = "FLASH_BWD_DKV" if which == "dkv" else "FLASH_BWD_DQ"
            saved = getattr(build, attr)
            kern = kernels[(dtype, var)]
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
            row = dict(kernel=which, dtype=dtype, d=d, tiles=list(var[2:]),
                       built=var == next(x for x in variants
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
