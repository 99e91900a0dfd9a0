#!/usr/bin/env python3
"""The quantized-input forward (K10) held against another checkout's on one
CUDA card.

    python3 tools/torch_quant_ab.py OTHER [--rounds N] [--json out.jsonl]

OTHER is a checkout unpacked under ``build/`` (``git archive <rev> | tar -x
-C build/parent``) whose ``quant_fwd`` takes the same 27-argument C entry.
The tool builds OTHER's ``quant_fwd.cu`` (with OTHER's headers) beside this
tree's, then prints one JSON line each for:

  1. every case of ``chip_smoke.py``'s phase-3 K10 check, on both kernels
     with the same inputs: the elements off the plain version for each
     kernel, the elements off each other, and the rows past their bar
     (``chip_smoke.row_bars``); a case at a head width OTHER does not
     build is run on this tree's kernel alone;
  2. config 4's three tiers (int8, fp8 native, fp8 software; b1, 32/8
     heads, s8192, d 128, causal, bf16 out) in turns (OTHER, this, this,
     OTHER; ``--rounds`` rounds, default 3): CUDA-event ms of 3 calls back
     to back, medians and every reading.

Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("torch_quant_ab: needs a CUDA device and OTHER",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import quantized as qz

    other_src = Path(sys.argv[1]).resolve() / "tpu_flash_torch" / "csrc"
    rounds = 3
    if "--rounds" in sys.argv:
        rounds = int(sys.argv[sys.argv.index("--rounds") + 1])
    out = None
    if "--json" in sys.argv:
        out = open(sys.argv[sys.argv.index("--json") + 1], "w")

    def emit(**row):
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "other_quant_fwd.so"
    proc = subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(other_src), "-o",
         str(lib_path), str(other_src / "quant_fwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    mine = build.QUANT_FWD
    mine.finish_build(mine.start_build())
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for OTHER's quant_fwd:\n{log}")
    other = build.CudaKernel(mine.name, mine.symbol, mine.argtypes,
                             replaces="-")
    other._lib = ctypes.CDLL(str(lib_path))
    fn = getattr(other._lib, mine.symbol)
    fn.argtypes, fn.restype = mine.argtypes, ctypes.c_int
    emit(phase="built", seconds=time.perf_counter() - t0, gpu=cs.gpu_query())

    def run(kernel, call, kw):
        build.QUANT_FWD = kernel
        try:
            return call(qz.quant_fwd, kw)
        except RuntimeError:
            return None  # a width OTHER does not build
        finally:
            build.QUANT_FWD = mine

    inputs = {}
    dev = "cuda"
    for name, dtype_name, s, kw, _, *geo in cs.quant_cases(dev):
        geo = geo[0] if geo else cs.QUANT_GEO
        key = (dtype_name, s, geo)
        if key not in inputs:
            inputs.clear()
            inputs[key] = cs.quant_inputs(dev, dtype_name, s, geo=geo)[3]
        qi = inputs[key]

        def call(f, opts, qi=qi, dtype_name=dtype_name, scale=geo[2] ** -0.5):
            return f(*qi[:6], dtype_name=dtype_name, sm_scale=scale,
                     **{"out_dtype": torch.bfloat16, **opts})

        got, theirs = run(mine, call, kw), run(other, call, kw)
        torch.cuda.synchronize()
        ref = call(qz.quant_fwd_plain, kw)
        bars = cs.row_bars(ref)
        row = dict(case=name, d=geo[2], n=ref.numel(),
                   differ_plain=cs.differing(got, ref),
                   rows_missed=int(cs.row_misses(got, ref, bars).sum()))
        if theirs is not None:
            row.update(other_differ_plain=cs.differing(theirs, ref),
                       other_rows_missed=int(
                           cs.row_misses(theirs, ref, bars).sum()),
                       differ_other=cs.differing(got, theirs))
        emit(phase="case", **row)
        del got, theirs, ref

    for tier, dtype_name, kw in (
            ("int8", "int8", dict(causal=True)),
            ("fp8_native", "fp8", dict(causal=True, fp8_native=True)),
            ("fp8_software", "fp8", dict(causal=True, fp8_native=False))):
        qi = cs.quant_inputs(dev, dtype_name, cs.QUANT_SEQ)[3]
        times = {"other": [], "this": []}
        for _ in range(rounds):
            for tag, kernel in (("other", other), ("this", mine),
                                ("this", mine), ("other", other)):
                build.QUANT_FWD = kernel
                times[tag].append(cs.time_ms(
                    lambda: qz.quant_fwd(*qi[:6], dtype_name=dtype_name,
                                         sm_scale=cs.SCALE, **kw), 3,
                    warmup=1))
                build.QUANT_FWD = mine
        emit(phase="in_turns", tier=tier, gpu=cs.gpu_query(),
             other_ms=statistics.median(times["other"]),
             this_ms=statistics.median(times["this"]), readings=times)
        del qi
    return 0


if __name__ == "__main__":
    sys.exit(main())
