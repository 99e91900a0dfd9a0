#!/usr/bin/env python3
"""K1's ``flash_fwd`` entry held against another checkout's on one CUDA
card, in turns.

    python3 tools/torch_fwd_tc_ab.py OTHER [--segments] [--rounds N]
        [--json out.jsonl]

OTHER is a checkout unpacked under ``build/`` (``git archive <rev> | tar -x
-C build/parent``) whose ``flash_fwd`` C entry takes this tree's arguments.
The tool builds OTHER's ``csrc/flash_fwd.cu`` with OTHER's headers beside
this tree's, and times OTHER's kernel through OTHER's own wrapper
(``ops/flash/forward.py``), so each side's call is what that checkout
runs. It prints one JSON line a case: by default ``chip_smoke.py`` phase
3's bf16 forward cases (``flash_cases``), Gemma-2-9B's sliding and global
layers and first chunk (``GEMMA_FLASH_CASES``) and the rows that see no
key at d 128 and 256 (``BLIND_GEO``); with ``--segments`` the calls with
segment ids alone, in bf16 (the tensor cores) and f32 (the order-exact
kernel): phase 3's ``segments`` case, whose every row sees a key, and
``check_flash_orphan``'s inputs, whose q segments no key carries in some
rows. Each line holds the output elements that differ between the two
sides and those off the plain version, and the CUDA-event ms of each
call in turns (OTHER, this, this, OTHER; ``--rounds`` rounds, default
5), medians and every reading, beside the case's bound and the card's
name and power limit.

Exit 1 if a case in which every row sees a key differs from OTHER's by
one element. Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def cases(cs):
    """(name, q, k, v, options, rows that see no key)."""
    import torch

    out = [(name, q, k, v, kw, False)
           for name, q, k, v, kw, _ in cs.flash_cases("cuda")]
    for name, b, sq, kw, _ in cs.GEMMA_FLASH_CASES:
        out.append((name, *cs.gemma_qkv("cuda", b, sq, sq, cs.SEED + 20),
                    kw, False))
    for d, hq, hkv in cs.BLIND_GEO:  # check_flash_blind's inputs
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + d)
        q = torch.randn(2, hq, 512, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(2, hkv, 512, d, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        out.append((f"blind_rows_d{d}", q, k, v, dict(cs.BLIND), True))
    return out


def segment_cases(cs):
    """The calls with segment ids, bf16 and f32: (name, q, k, v, options,
    rows that see no key)."""
    import torch

    out = []
    for dtype in ("bfloat16", "float32"):
        out += [(f"{name}_{dtype}", q, k, v, kw, False)
                for name, q, k, v, kw, _ in cs.flash_cases("cuda", dtype)
                if name == "segments"]
        q, k, v, kw = cs.orphan_inputs("cuda", getattr(torch, dtype))
        kw.pop("sm_scale")
        out.append((f"orphan_segment_{dtype}", q, k, v, kw, True))
    return out


def wrapper_of(root: Path):
    """OTHER's ``ops/flash/forward.py`` loaded as a module of its own (it
    imports this tree's other modules)."""
    spec = importlib.util.spec_from_file_location(
        "other_forward", root / "tpu_flash_torch" / "ops" / "flash"
        / "forward.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("torch_fwd_tc_ab: needs a CUDA device and OTHER",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import forward as fw

    root = Path(sys.argv[1]).resolve()
    other = root / "tpu_flash_torch" / "csrc"
    other_fw = wrapper_of(root)
    rounds = 5
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

    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / "other_flash_fwd_tc.so"
    proc = subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(other), "-o",
         str(lib), str(other / "flash_fwd.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    build.FLASH_FWD.finish_build(build.FLASH_FWD.start_build())
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for OTHER's flash_fwd:\n{log}")
    theirs = build.CudaKernel("flash_fwd", "flash_fwd",
                              build.FLASH_FWD.argtypes, replaces="-")
    theirs._lib = ctypes.CDLL(str(lib))
    fn = getattr(theirs._lib, "flash_fwd")
    fn.argtypes, fn.restype = theirs.argtypes, ctypes.c_int
    gpu = cs.gpu_query()
    emit(phase="built", seconds=time.perf_counter() - t0, gpu=gpu)

    same = True
    todo = segment_cases(cs) if "--segments" in sys.argv else cases(cs)
    for name, q, k, v, kw, blind in todo:
        kw = dict(kw, sm_scale=q.shape[-1] ** -0.5)
        fns = {"other": lambda: other_fw._flash_fwd_cuda(theirs, q, k, v,
                                                         **kw),
               "this": lambda: fw._flash_fwd_cuda(build.FLASH_FWD, q, k, v,
                                                  **kw)}
        mine, other_o = fns["this"](), fns["other"]()
        ref = fw.flash_fwd_plain(q, k, v, **kw)
        differ_other = cs.differing(mine, other_o)
        same = same and (blind or differ_other == 0)
        ms = {w: [] for w in fns}
        iters = 3 if q.shape[2] > 4096 else 10
        for _ in range(rounds):
            for who in ("other", "this", "this", "other"):
                ms[who].append(cs.time_ms(fns[who], iters))
        bound_ms, bound_by = (
            cs.blind_bound(q, k, kw) if blind
            else cs.flash_bound(q, k, kw))
        emit(phase="turns", case=name, shape=list(q.shape), kv=k.shape[2],
             options={a: (list(b.shape) if isinstance(b, torch.Tensor)
                          else b) for a, b in kw.items()
                      if a != "sm_scale"},
             rows_see_no_key=blind, differ_other=differ_other,
             differ_plain=cs.differing(mine, ref),
             other_differ_plain=cs.differing(other_o, ref),
             ms=statistics.median(ms["this"]),
             other_ms=statistics.median(ms["other"]),
             ms_all=ms["this"], other_ms_all=ms["other"],
             bound_ms=bound_ms, bound_by=bound_by, gpu=gpu)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
