#!/usr/bin/env python3
"""Tile shapes of the order-exact prefill tile, swept on one CUDA card.

    python3 tools/torch_prefill_sweep.py [--json out.json] [--rounds N]
    python3 tools/torch_prefill_sweep.py --parts [--json out.json]

Writes two harness sources under build/: the text of
``tpu_flash_torch/csrc/ragged_prefill.cu`` (K6) and of
``paged_prefill.cu`` (K5), each followed by two C entry points a
variant below, its launch and its occupancy query (``prefill_tile.cuh``'s
tile is a template on its rows a block and its staged step). Builds
both with nvcc and times each variant by CUDA events around its launches
inside the product wrappers, in turns: every round runs the variants of
a shape in order and then in reverse, so none gains from its place.
Shapes (bf16, d 128, 32 q / 8 kv heads): ``chip_smoke.py`` phase 3's
ragged step (b 4 x 512 over history {0, 512, 1024, 1536} padded to
1536), paged chunk (b 4 x 512 over 1024 history tokens in 128-token
pages), paged mixed stages (history {0, 512, 1024, 1536}) and the
speculative verify (b 8 x 9 rows over 1100..1800 tokens). Each variant's
output is held against the plain version at phase 3's bar for each row
and compared with the built variant's bit for bit (the tile's chains do
not depend on its shape). One JSON line a (shape, variant): the median
ms over the rounds, every reading, its largest error as a share of its
row's bar, whether it equals the built variant, and its registers and
spill bytes; the variant the wrappers launch is marked ``built``. Exit 1
if any variant misses its bar.

``--parts`` times what each part of the tile costs K6 at the ragged
step instead: one build of ``ragged_prefill.cu`` a set of parts left out
(``PREFILL_OMIT``: the score FMAs, the P V FMAs, the K/V staging,
forming P), timed in turns with the whole kernel. Their outputs are
wrong, so no bar is held. One JSON line a build: the median ms, every
reading, and the share of the whole kernel's time it saves.

Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (rows a block, staged kv rows a step) of each kernel's variants; the
# first is the one the wrappers launch (the paged kernel's verify calls
# take 16 rows: marked built at that shape).
RAGGED = [(64, 64), (64, 32)]
PAGED = [(64, 64), (32, 64), (16, 64)]
# --parts: the PREFILL_OMIT bits of each build (prefill_tile.cuh) and
# what they leave out.
PARTS = {0: "nothing", 1: "score FMAs", 2: "P V FMAs", 4: "K/V staging",
         8: "forming P", 3: "both FMA loops", 15: "all four"}
GEO = "Geo<128, __nv_bfloat16, {0}, {1}>"


def entry(kernel, variant) -> str:
    return f"{kernel}_" + "_".join(str(int(x)) for x in variant)


def occupancy_body(kernel) -> str:
    return (f"  auto kernel = {kernel};\n"
            "  cudaFuncSetAttribute(kernel,\n"
            "      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);\n"
            "  *smem = G::SMEM;\n"
            "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,"
            "\n      THREADS, G::SMEM);\n"
            "  return (int)cudaGetLastError();\n}")


def ragged_harness() -> str:
    return "\n".join(
        f'extern "C" int {entry("ragged", v)}(RAGGED_PREFILL_ARGS) {{\n'
        "  RaggedParams rg;\n"
        "  const int rc = ragged_params(rg, RAGGED_PREFILL_PARAMS);\n"
        "  if (rc != 0) return rc;\n"
        "  if (dtype != 1 || head_dim != 128) return 1;\n"
        f"  return launch<{GEO.format(*v)}>(\n"
        "      rg, batch, scratch_floats, static_cast<cudaStream_t>(stream));"
        "\n}\n"
        f'extern "C" int {entry("ragged", v)}_occupancy(int dtype, '
        "int head_dim,\n    int* smem, int* blocks) {\n"
        "  if (dtype != 1 || head_dim != 128) return 1;\n"
        f"  using G = {GEO.format(*v)};\n"
        + occupancy_body("ragged_prefill_kernel<G>")
        for v in RAGGED) + "\n"


def paged_harness() -> str:
    # The wrapper passes the variant's rows (the sweep patches
    # tile_rows); paged_params validates the product's rows, so it sees
    # ROWS.
    return "\n".join(
        f'extern "C" int {entry("paged", v)}(PAGED_PREFILL_ARGS) {{\n'
        "  PagedParams pp;\n"
        "  const int want = rows;\n"
        "  rows = ROWS;\n"
        "  const int rc = paged_params(pp, PAGED_PREFILL_PARAMS);\n"
        "  if (rc != 0) return rc;\n"
        f"  if (want != {v[0]} || q_dtype != 1 || page_dtype != 1 ||\n"
        "      head_dim != 128) return 1;\n"
        f"  return launch_tile<{GEO.format(*v)}, __nv_bfloat16>(\n"
        "      pp, batch, scratch_floats, static_cast<cudaStream_t>(stream));"
        "\n}\n"
        f'extern "C" int {entry("paged", v)}_occupancy(int q_dtype, '
        "int page_dtype,\n    int head_dim, int rows, int* smem, "
        "int* blocks) {\n"
        f"  if (rows != {v[0]} || q_dtype != 1 || page_dtype != 1 ||\n"
        "      head_dim != 128) return 1;\n"
        f"  using G = {GEO.format(*v)};\n"
        + occupancy_body("paged_prefill_kernel<G, __nv_bfloat16>")
        for v in PAGED) + "\n"


def registers(build_log, kernel):
    """{variant: (registers, spill stores, spill loads)} of the bf16 d 128
    instances (bf16 pages for the paged kernel) in nvcc's -Xptxas -v
    log, read from the mangled Geo<128, bf16, R, BK> and what follows it
    (the ragged kernel's template list ends; the paged kernel's page
    type)."""
    geo = (r"GeoILi128E13__nv_bfloat16Li(\d+)ELi(\d+)EEE"
           r"(S\d*_|13__nv_bfloat16|E)")
    out, cur = {}, None
    for ln in build_log.splitlines():
        m = re.search(rf"Function properties for \S*{kernel}_kernel\S*",
                      ln)
        if m:
            cur = None
            g = re.search(geo, m[0])
            if g and (g[3] == "E") == kernel.startswith("ragged"):
                cur = (int(g[1]), int(g[2]))
                if cur in out:
                    cur = None
                else:
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


def build_all(specs):
    """Build [(name, symbol, product kernel, text)] together, each from
    build/<name>.cu; returns {name: CudaKernel} and {name: nvcc log}."""
    from tpu_flash_torch.ops import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name, symbol, product, text in specs:
        path = build.BUILD_DIR / f"{name}.cu"
        path.write_text(text)
        k = build.CudaKernel(name, symbol, product.argtypes, replaces="-")
        k.source = path  # the harness, outside csrc/
        kernels[name] = k
    procs = [(k, k.start_build()) for k in kernels.values()]
    for k, proc in procs:
        k.finish_build(proc)
    return kernels, {n: k.build_log for n, k in kernels.items()}


def harness_kernels():
    """{(kernel, variant): CudaKernel} over two harness sources, built
    together, and each source's nvcc log."""
    from tpu_flash_torch.ops import build

    specs = [(f"{kern}_prefill_sweep", entry(kern, variants[0]), product,
              product.source.read_text() + text)
             for kern, product, variants, text in (
                 ("ragged", build.RAGGED_PREFILL, RAGGED, ragged_harness()),
                 ("paged", build.PAGED_PREFILL, PAGED, paged_harness()))]
    libs, logs = build_all(specs)
    kernels = {}
    for kern, variants in (("ragged", RAGGED), ("paged", PAGED)):
        owner = libs[f"{kern}_prefill_sweep"]
        for v in variants:
            k = build.CudaKernel(entry(kern, v), entry(kern, v),
                                 owner.argtypes, replaces="-")
            k.source = owner.source
            kernels[kern, v] = k
    return kernels, {kern: logs[f"{kern}_prefill_sweep"]
                     for kern in ("ragged", "paged")}


def shapes(dev):
    """name: (kernel, run(), plain run()) at phase 3's shapes."""
    import torch

    from chip_smoke import paged_prefill_inputs, plain_versions
    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.flash import ragged

    g = torch.Generator(device=dev).manual_seed(9)
    offsets = [0, 512, 1024, 1536]
    q = torch.randn(4, 32, 512, 128, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(4, 8, 2048, 128, generator=g, device=dev).bfloat16()
            for _ in range(2))
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)

    def ragged_run():
        return ragged.flash_attention_ragged(q, k, v, offs, hist_cap=1536)

    out = {"ragged_mixed": ("ragged", ragged_run)}
    for name, b, q_len, hist_cap, lens in [
            ("paged_chunk", 4, 512, 1024, [1024] * 4),
            ("paged_mixed", 4, 512, 1536, [0, 512, 1024, 1536]),
            ("paged_verify", 8, 9, 2048, [1100 + 100 * i for i in range(8)])]:
        qp, ck, cv, kp, vp, table = paged_prefill_inputs(
            dev, b, q_len, hist_cap, "bfloat16")
        o = torch.tensor(lens, dtype=torch.int32, device=dev)

        def run(qp=qp, ck=ck, cv=cv, kp=kp, vp=vp, o=o, table=table,
                hist_cap=hist_cap):
            return pp.paged_prefill_attention(qp, ck, cv, kp, vp, o, table,
                                              hist_cap=hist_cap)

        out[name] = ("paged", run)
    with plain_versions():
        return {n: (kern, run, run()) for n, (kern, run) in out.items()}


def in_turns(variants, use, run, rounds):
    """{variant: [ms a round, twice a round]}: each round times the
    variants in order and then in reverse, ``use(variant)`` making it
    the one the wrapper launches (and returning its CudaKernel)."""
    from chip_smoke import kernel_ms

    ms = {x: [] for x in variants}
    for _ in range(rounds):
        for x in variants + variants[::-1]:
            ms[x].append(kernel_ms(use(x), run, 5))
    return ms


def sweep(rounds, gpu):
    """The tile shapes at every shape; their JSON rows."""
    import torch

    from chip_smoke import row_bars
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import paged_prefill as pp

    kernels, logs = harness_kernels()
    regs = {kern: registers(logs[kern], f"{kern}_prefill")
            for kern in ("ragged", "paged")}
    rows = []
    saved = {"ragged": build.RAGGED_PREFILL, "paged": build.PAGED_PREFILL}
    saved_rows = pp.tile_rows
    for shape, (kern, run, ref) in shapes("cuda").items():
        variants = RAGGED if kern == "ragged" else PAGED
        built = variants[-1] if shape == "paged_verify" else variants[0]
        bars = row_bars(ref).clamp_min(1e-30)
        outs, errs = {}, {}

        def use(x):
            k = kernels[kern, x]
            if kern == "ragged":
                build.RAGGED_PREFILL = k
            else:
                build.PAGED_PREFILL = k
                pp.tile_rows = lambda *a, **kw: x[0]
            return k

        try:
            for x in variants:
                use(x)
                outs[x] = run()
                torch.cuda.synchronize()
                errs[x] = float(((outs[x].float() - ref.float()).abs()
                                 .amax(-1) / bars).max())
            ms = in_turns(variants, use, run, rounds)
        finally:
            build.RAGGED_PREFILL = saved["ragged"]
            build.PAGED_PREFILL = saved["paged"]
            pp.tile_rows = saved_rows
        for x in variants:
            row = dict(shape=shape, kernel=kern, rows=x[0], step=x[1],
                       built=x == built,
                       registers_spill_stores_loads=regs[kern].get(x),
                       ms=statistics.median(ms[x]), ms_all=ms[x],
                       err_of_bar=errs[x], ok=errs[x] <= 1.0,
                       equals_built=bool(torch.equal(outs[x], outs[built])),
                       gpu=gpu)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def parts(rounds, gpu):
    """K6 at the ragged step with parts of the tile left out; their JSON
    rows (each with ok True: no bar is held)."""
    from tpu_flash_torch.ops import build

    product = build.RAGGED_PREFILL
    text = product.source.read_text()
    libs, _ = build_all([(f"ragged_prefill_omit{bits}", product.symbol,
                          product, f"#define PREFILL_OMIT {bits}\n{text}")
                         for bits in PARTS])
    _, run, _ = shapes("cuda")["ragged_mixed"]

    def use(bits):
        build.RAGGED_PREFILL = libs[f"ragged_prefill_omit{bits}"]
        return build.RAGGED_PREFILL

    try:
        ms = in_turns(list(PARTS), use, run, rounds)
    finally:
        build.RAGGED_PREFILL = product
    whole = statistics.median(ms[0])
    rows = []
    for bits, what in PARTS.items():
        med = statistics.median(ms[bits])
        row = dict(shape="ragged_mixed", kernel="ragged", omit=bits,
                   left_out=what, ms=med, ms_all=ms[bits],
                   share_saved=1.0 - med / whole, ok=True, gpu=gpu)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_prefill_sweep: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_query

    rounds = 3
    if "--rounds" in sys.argv[1:]:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_query()
    if "--parts" in sys.argv[1:]:
        rows = parts(rounds, gpu)
    else:
        rows = sweep(rounds, gpu)
    if "--json" in sys.argv[1:]:
        with open(sys.argv[sys.argv.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
