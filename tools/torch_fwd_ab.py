#!/usr/bin/env python3
"""The order-exact forward and the prefill tile held against another checkout
on one CUDA card.

    python3 tools/torch_fwd_ab.py OTHER [--rounds N] [--json out.jsonl]

OTHER is a checkout unpacked under ``build/`` (``git archive <rev> | tar -x
-C build/parent``) whose ``flash_fwd_exact`` is the 24-argument C entry (no
score scratch: a checkout from before the order-exact forward ran on
``csrc/prefill_tile.cuh``). The tool builds OTHER's ``flash_fwd``,
``paged_prefill`` and ``ragged_prefill`` sources with OTHER's headers beside
this tree's kernels, then prints one JSON line each for:

  1. the row sum: how many rows of PyTorch's CUDA ``p.sum(-1)`` (the plain
     versions' l) each candidate order gives bit for bit, at block widths
     of 128 and less -- the order the forward's kernel takes
     (``prefill_tile.cuh``, ``torch_row_sum``) and the tile's four runs;
  2. every distinct call of ``chip_smoke.py``'s phase-3 forward and prefill
     checks, also run on OTHER's kernel with the same inputs: for the
     order-exact forward (and f32 ``flash_fwd``) the elements off the plain
     version for each kernel and off each other, for K5 and K6 the
     elements off each other;
  3. ``flash_fwd_exact`` against OTHER's in turns (OTHER, this, this,
     OTHER; ``--rounds`` rounds, default 5) at phase 3's main, chunk,
     config-1 and Gemma-2 shapes: CUDA-event ms back to back and device
     ms (``chip_smoke.device_ms``, L2 warm), medians and every reading.

Exit 1 if a K5 or K6 call differs from OTHER's. Needs a CUDA card, nvcc
and PyTorch.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# OTHER's order-exact entry: q k v o lse sinks alibi q_seg kv_seg, then
# dtype batch hq hkv sq skv kv_len head_dim, scale, causal q_offset window,
# softcap inv_softcap, stream.
OTHER_FWD_ARGS = ("P" * 9) + ("I" * 8) + "FIIIFFP"


def row_sum_orders(n_rows=2000):
    """Share of rows of ``p.sum(-1)`` on the card each candidate order
    reproduces (the scores are one causal block of phase 3's main case)."""
    import numpy as np
    import torch

    f32 = np.float32

    def tree(parts):
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [f32(parts[t] + parts[t + half]) for t in range(half)]
        return parts[0]

    def partials(row, col):
        out = []
        for t in range(32):
            xs = [row[c] if c < len(row) else f32(0)
                  for c in (col(t, i) for i in range(4))]
            out.append(f32(f32(f32(xs[0] + xs[1]) + xs[2]) + xs[3]))
        return out

    def torch_order(row):  # prefill_tile.cuh's torch_row_sum
        if len(row) >= 128:
            return tree(partials(row, lambda t, i: 4 * t + i))
        return tree(partials(row, lambda t, i: t + 32 * i))

    def four_runs(row):  # the tile's l for K5 and K6
        n = len(row) // 4
        r = []
        for k in range(4):
            acc = row[k * n]
            for x in row[k * n + 1:(k + 1) * n]:
                acc = f32(acc + x)
            r.append(acc)
        return f32(f32(r[0] + r[1]) + f32(r[2] + r[3]))

    g = torch.Generator(device="cuda").manual_seed(0)
    qs = (torch.randn(4, 8, 4, 512, 128, generator=g, device="cuda")
          .bfloat16().float() * 128 ** -0.5)
    rows = []
    for width in (128, 104, 64, 20, 7):
        kt = torch.randn(4, 8, width, 128, generator=g,
                         device="cuda").bfloat16().float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qs, kt)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        sums = p.sum(dim=-1).cpu().numpy().reshape(-1)
        pc = p.cpu().numpy().reshape(-1, width).astype(np.float32)
        row = dict(width=width, rows=n_rows, torch_order=sum(
            torch_order(pc[i]) == sums[i] for i in range(n_rows)) / n_rows)
        if width % 4 == 0:
            row["four_runs"] = sum(four_runs(pc[i]) == sums[i]
                                   for i in range(n_rows)) / n_rows
        rows.append(row)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("torch_fwd_ab: needs a CUDA device and OTHER", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import forward as fw
    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.flash import ragged

    other = Path(sys.argv[1]).resolve() / "tpu_flash_torch" / "csrc"
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("flash_fwd", "paged_prefill", "ragged_prefill"):
        lib = build.BUILD_DIR / f"other_{stem}.so"
        procs[stem] = (subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(other), "-o",
             str(lib), str(other / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    build.build_all()
    libs = {}
    for stem, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for OTHER's {stem}:\n{log}")
        libs[stem] = ctypes.CDLL(str(lib))
    emit(phase="built", seconds=time.perf_counter() - t0, gpu=cs.gpu_query())
    for row in row_sum_orders():
        emit(phase="row_sum_order", **row)

    types = {"P": build.P, "I": build.I, "F": build.F}
    other_exact = libs["flash_fwd"].flash_fwd_exact
    other_exact.argtypes = [types[c] for c in OTHER_FWD_ARGS]
    other_exact.restype = ctypes.c_int

    def other_fwd(q, k, v, *, causal, sm_scale, q_offset=0, kv_len=None,
                  window=None, softcap=None, sinks=None, alibi=None,
                  q_seg=None, kv_seg=None, save_lse=False):
        b, hq, sq, d = q.shape
        q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
        sinks = None if sinks is None else sinks.float().contiguous()
        alibi = None if alibi is None else alibi.float().contiguous()
        q_seg, kv_seg = fw.segment_ids_for_kernel(q_seg, kv_seg)
        o = torch.empty_like(q)
        lse = (torch.empty((b, hq, sq), dtype=torch.float32,
                           device=q.device) if save_lse else None)
        rc = other_exact(
            *(build.ptr(x) for x in (q, k, v, o, lse, sinks, alibi, q_seg,
                                     kv_seg)),
            fw.KERNEL_DTYPES[q.dtype], b, hq, k.shape[1], sq, k.shape[2],
            k.shape[2] if kv_len is None else int(kv_len), d,
            fw.rounded_scale(sm_scale, q.dtype), int(bool(causal)),
            int(q_offset), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            0.0 if softcap is None else float(1.0 / softcap),
            build.stream_handle(q))
        if rc != 0:
            raise RuntimeError(f"OTHER's flash_fwd_exact: CUDA error {rc}")
        return (o, lse) if save_lse else o

    def other_kernel(kernel, lib):
        k = build.CudaKernel(kernel.name, kernel.symbol, kernel.argtypes,
                             replaces="-")
        k._lib = lib
        fn = getattr(lib, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        return k

    others = {"PAGED_PREFILL": other_kernel(build.PAGED_PREFILL,
                                            libs["paged_prefill"]),
              "RAGGED_PREFILL": other_kernel(build.RAGGED_PREFILL,
                                             libs["ragged_prefill"])}

    def key(x):
        if isinstance(x, torch.Tensor):
            return (x.data_ptr(), tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return tuple(key(y) for y in x)
        return x

    def options(kw):
        return {a: (list(b.shape) if isinstance(b, torch.Tensor) else b)
                for a, b in kw.items() if a != "sm_scale"}

    seen, prefill_differ = set(), []
    real_fwd = fw._flash_fwd_cuda

    def shadow_fwd(kernel, q, k, v, **kw):
        o = real_fwd(kernel, q, k, v, **kw)
        exact = kernel is build.FLASH_FWD_EXACT or q.dtype == torch.float32
        sig = ("fwd", kernel.name, key([q, k, v]), key(sorted(kw.items())))
        if exact and sig not in seen:
            seen.add(sig)
            ref = fw.flash_fwd_plain(q, k, v, **kw)
            theirs = other_fwd(q, k, v, **kw)
            mine, ref, theirs = (x[0] if isinstance(x, tuple) else x
                                 for x in (o, ref, theirs))
            emit(phase="call", kernel=kernel.name, shape=list(q.shape),
                 kv=k.shape[2], dtype=str(q.dtype).removeprefix("torch."),
                 options=options(kw), elements=mine.numel(),
                 differ_plain=cs.differing(mine, ref),
                 other_differ_plain=cs.differing(theirs, ref),
                 differ_other=cs.differing(mine, theirs))
        return o

    def shadow(module, attr, kernel_attr):
        real = getattr(module, attr)

        def call(*args, **kw):
            o = real(*args, **kw)
            sig = (attr, key(list(args)), key(sorted(kw.items())))
            if sig not in seen:
                seen.add(sig)
                saved = getattr(build, kernel_attr)
                setattr(build, kernel_attr, others[kernel_attr])
                try:
                    theirs = real(*args, **kw)
                finally:
                    setattr(build, kernel_attr, saved)
                n = cs.differing(o, theirs)
                prefill_differ.append(n)
                emit(phase="call", kernel=kernel_attr.lower(),
                     shape=list(args[0].shape), options=options(kw),
                     elements=o.numel(), differ_other=n)
            return o
        return real, call

    real_pp, pp._paged_prefill_cuda = shadow(pp, "_paged_prefill_cuda",
                                             "PAGED_PREFILL")
    real_rg, ragged._ragged_prefill_cuda = shadow(
        ragged, "_ragged_prefill_cuda", "RAGGED_PREFILL")
    fw._flash_fwd_cuda = shadow_fwd
    try:
        for check in (cs.check_flash, cs.check_flash_d256,
                      cs.check_paged_prefill, cs.check_ragged,
                      cs.check_prefill_d256):
            with contextlib.redirect_stdout(io.StringIO()):
                check("cuda")
    finally:
        fw._flash_fwd_cuda = real_fwd
        pp._paged_prefill_cuda, ragged._ragged_prefill_cuda = real_pp, real_rg

    cases = [(case, q, k, v, kw) for case, q, k, v, kw, _ in
             cs.flash_cases("cuda")
             if case in ("prompt_causal", "chunk_q_offset")]
    cases.append(cs.config1_case("cuda")[:5])
    for case, b, sq, kw, _ in cs.GEMMA_FLASH_CASES:
        cases.append((case, *cs.gemma_qkv("cuda", b, sq, sq, cs.SEED + 20),
                      kw))
    for case, q, k, v, kw in cases:
        scale = q.shape[-1] ** -0.5
        fns = {"other": lambda: other_fwd(q, k, v, sm_scale=scale, **kw),
               "this": lambda: fw.flash_fwd_exact(q, k, v, sm_scale=scale,
                                                  **kw)}
        ms = {w: [] for w in fns}
        dev_ms = {w: [] for w in fns}
        iters = 3 if q.shape[2] > 4096 else 10
        for _ in range(rounds):
            for who in ("other", "this", "this", "other"):
                ms[who].append(cs.time_ms(fns[who], iters))
                dev_ms[who].append(cs.device_ms(fns[who], iters, cold=False))
        emit(phase="turns", case=case, shape=list(q.shape), kv=k.shape[2],
             dtype=str(q.dtype).removeprefix("torch."),
             ms=statistics.median(ms["this"]),
             other_ms=statistics.median(ms["other"]),
             device_ms=statistics.median(dev_ms["this"]),
             other_device_ms=statistics.median(dev_ms["other"]),
             ms_all=ms["this"], other_ms_all=ms["other"],
             fp32_bound_ms=cs.flash_fp32_bound(q, k, kw), gpu=cs.gpu_query())
    return 1 if any(prefill_differ) else 0


if __name__ == "__main__":
    sys.exit(main())
