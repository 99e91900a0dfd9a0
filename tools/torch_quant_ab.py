#!/usr/bin/env python3
"""A kernel held against another checkout's on one CUDA card: the
quantized-input forward (K10), the backward pair (K8/K9) or the
attention-weights kernel (K12).

    python3 tools/torch_quant_ab.py OTHER [--kernel K] [--rounds N]
                                          [--json out.jsonl]

OTHER is a checkout unpacked under ``build/`` (``git archive <rev> | tar -x
-C build/parent``) whose source for K takes the same C entry: ``quant_fwd``
(27 arguments, the default), ``flash_bwd`` (its two entries, 26 each) or
``attn_weights`` (20). The tool builds OTHER's source (with OTHER's
headers) beside this tree's, then prints one JSON line each for:

  1. every case of ``chip_smoke.py``'s phase-3 check of K, on both
     kernels with the same inputs: the elements off the plain version for
     each kernel, the elements off each other, and the rows past their bar
     (``chip_smoke.row_bars``); for K10 a case at a head width OTHER does
     not build is run on this tree's kernel alone; for the backward and
     K12 each distinct call of phase 3's checks (``check_flash_bwd``,
     ``check_flash_bwd_widths``, ``check_attn_weights``) is shadowed;
  2. times in turns (OTHER, this, this, OTHER; ``--rounds`` rounds,
     default 3), medians and every reading: K10 at config 4's three tiers
     (int8, fp8 native, fp8 software; b1, 32/8 heads, s8192, d 128,
     causal, bf16 out), CUDA-event ms of 3 calls back to back; the
     backward at phase 3's causal cases (f32 b 2 and bf16 b 4, 32/8
     heads, s 2048, d 128), each kernel's ms by events around its
     launches and the whole ``flash_bwd``'s; K12 at each phase-3 case.

Exit 1 if a bf16 backward call differs from OTHER's at all. Needs a CUDA
card, nvcc and PyTorch.
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

# K: (its source, the ops.build attributes of its entry points)
KERNELS = {"quant_fwd": ("quant_fwd", ("QUANT_FWD",)),
           "flash_bwd": ("flash_bwd", ("FLASH_BWD_DKV", "FLASH_BWD_DQ")),
           "attn_weights": ("attn_weights", ("ATTN_WEIGHTS",))}


def arg(name, default):
    return (sys.argv[sys.argv.index(name) + 1] if name in sys.argv
            else default)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("torch_quant_ab: needs a CUDA device and OTHER",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_flash_torch.ops import build

    other_src = Path(sys.argv[1]).resolve() / "tpu_flash_torch" / "csrc"
    which = arg("--kernel", "quant_fwd")
    rounds = int(arg("--rounds", 3))
    out = open(arg("--json", None), "w") if "--json" in sys.argv else None
    stdout = sys.stdout  # phase 3's checks run with their own lines hidden

    def emit(**row):
        line = json.dumps(row)
        print(line, file=stdout, flush=True)
        if out is not None:
            out.write(line + "\n")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stem, attrs = KERNELS[which]
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / f"other_{stem}.so"
    proc = subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(other_src), "-o",
         str(lib_path), str(other_src / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    mine = {a: getattr(build, a) for a in attrs}
    first = mine[attrs[0]]
    first.finish_build(first.start_build())
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for OTHER's {stem}:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    others = {}
    for a, k in mine.items():
        o = build.CudaKernel(k.name, k.symbol, k.argtypes, replaces="-")
        o._lib = lib
        fn = getattr(lib, k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        others[a] = o
    emit(phase="built", kernel=which, seconds=time.perf_counter() - t0,
         gpu=cs.gpu_query())

    @contextlib.contextmanager
    def using(kernels):
        for a, k in kernels.items():
            setattr(build, a, k)
        try:
            yield
        finally:
            for a, k in mine.items():
                setattr(build, a, k)

    run = {"quant_fwd": quant_ab, "flash_bwd": bwd_ab,
           "attn_weights": weights_ab}[which]
    return run(cs, emit, using, mine, others, rounds)


def quant_ab(cs, emit, using, mine, others, rounds) -> int:
    import torch

    from tpu_flash_torch.ops.flash import quantized as qz

    def run(kernels, call, kw):
        with using(kernels):
            try:
                return call(qz.quant_fwd, kw)
            except RuntimeError:
                return None  # a width OTHER does not build

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

        got, theirs = run(mine, call, kw), run(others, call, kw)
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
            for tag in ("other", "this", "this", "other"):
                with using(others if tag == "other" else mine):
                    times[tag].append(cs.time_ms(
                        lambda: qz.quant_fwd(*qi[:6], dtype_name=dtype_name,
                                             sm_scale=cs.SCALE, **kw), 3,
                        warmup=1))
        emit(phase="in_turns", tier=tier, gpu=cs.gpu_query(),
             other_ms=statistics.median(times["other"]),
             this_ms=statistics.median(times["this"]), readings=times)
        del qi
    return 0


def shadowed(cs, emit, using, others, module, attr, checks, compare):
    """Run phase 3's ``checks`` with ``module.attr`` (a wrapper's CUDA
    path) shadowed: each distinct call also runs on OTHER's kernels, and
    ``compare(args, kw, mine, theirs)`` gives its JSON line's fields."""
    import torch

    real = getattr(module, attr)
    seen = set()

    def key(x):
        if isinstance(x, torch.Tensor):
            return (x.data_ptr(), tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return tuple(key(y) for y in x)
        return x

    def call(*args, **kw):
        got = real(*args, **kw)
        sig = (key(list(args)), key(sorted(kw.items())))
        if sig not in seen:
            seen.add(sig)
            with using(others):
                theirs = real(*args, **kw)
            torch.cuda.synchronize()
            emit(phase="call", shape=list(args[0].shape),
                 dtype=str(args[0].dtype).removeprefix("torch."),
                 options={a: (list(b.shape) if torch.is_tensor(b) else b)
                          for a, b in kw.items()},
                 **compare(args, kw, got, theirs))
        return got

    setattr(module, attr, call)
    try:
        for check in checks:
            with contextlib.redirect_stdout(io.StringIO()):
                check("cuda")
    finally:
        setattr(module, attr, real)


def in_turns(emit, using, mine, others, rounds, fns, **fields):
    """Each of ``fns`` ({label: fn() -> ms}) on OTHER's kernels and this
    tree's in turns (OTHER, this, this, OTHER), ``rounds`` times."""
    import statistics as st

    times = {f"{tag}_{label}": [] for tag in ("other", "this")
             for label in fns}
    for _ in range(rounds):
        for tag in ("other", "this", "this", "other"):
            with using(others if tag == "other" else mine):
                for label, fn in fns.items():
                    times[f"{tag}_{label}"].append(fn())
    emit(phase="in_turns", **fields,
         **{f"{k}_ms": st.median(v) for k, v in times.items()},
         readings=times)


def bwd_ab(cs, emit, using, mine, others, rounds) -> int:
    import torch

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    bf16_differ = []

    def compare(args, kw, got, theirs):
        rp = args[0].dtype == torch.bfloat16
        plain = {x: y for x, y in kw.items()
                 if x in ("causal", "sm_scale", "q_offset", "kv_len",
                          "window", "softcap", "alibi", "q_seg", "kv_seg",
                          "dlse")}
        ref = bw.flash_bwd_plain(*args, round_p=rp, **plain)
        row = {}
        for n, a, t, r in zip(("dq", "dk", "dv"), got, theirs, ref):
            bars = cs.bwd_row_bars(r, n)[0]
            row[n] = dict(elements=a.numel(), differ_plain=cs.differing(a, r),
                          other_differ_plain=cs.differing(t, r),
                          differ_other=cs.differing(a, t),
                          rows_missed=int(cs.row_misses(a, r, bars).sum()),
                          other_rows_missed=int(
                              cs.row_misses(t, r, bars).sum()))
            if rp:
                bf16_differ.append(row[n]["differ_other"])
        return row

    shadowed(cs, emit, using, others, bw, "_flash_bwd_cuda",
             (cs.check_flash_bwd, cs.check_flash_bwd_widths), compare)

    for name, dt, b in (("f32_causal", torch.float32, 2),
                        ("causal", torch.bfloat16, cs.TRAIN_TOKENS[0])):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
        q = torch.randn(b, 32, 2048, 128, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(b, 8, 2048, 128, generator=g,
                            device="cuda").to(dt) for _ in range(2))
        do = torch.randn(b, 32, 2048, 128, generator=g, device="cuda").to(dt)
        o, lse = flash_fwd_plain(q, k, v, sm_scale=cs.SCALE, save_lse=True,
                                 causal=True)

        def whole(args=(q, k, v, o, do, lse)):
            return bw.flash_bwd(*args, sm_scale=cs.SCALE, causal=True)

        in_turns(emit, using, mine, others, rounds, {
            "dkv": lambda: cs.kernel_ms(build.FLASH_BWD_DKV, whole, 5),
            "dq": lambda: cs.kernel_ms(build.FLASH_BWD_DQ, whole, 5),
            "whole": lambda: cs.time_ms(whole, 5)},
            case=name, shape=list(q.shape), gpu=cs.gpu_query())
        del q, k, v, do, o, lse
    return 1 if any(bf16_differ) else 0


def weights_ab(cs, emit, using, mine, others, rounds) -> int:
    from tpu_flash_torch.ops.flash import debug

    calls = []

    def compare(args, kw, got, theirs):
        ref = debug.weights_plain(*args, **kw)
        bars = cs.row_bars(ref)
        calls.append((args, kw))
        return dict(elements=got.numel(), differ_plain=cs.differing(got, ref),
                    other_differ_plain=cs.differing(theirs, ref),
                    differ_other=cs.differing(got, theirs),
                    rows_missed=int(cs.row_misses(got, ref, bars).sum()),
                    other_rows_missed=int(
                        cs.row_misses(theirs, ref, bars).sum()))

    shadowed(cs, emit, using, others, debug, "_attn_weights_cuda",
             (cs.check_attn_weights,), compare)
    for args, kw in calls:
        in_turns(emit, using, mine, others, rounds, {
            "weights": lambda: cs.time_ms(
                lambda: debug._attn_weights_cuda(*args, **kw), 10)},
            shape=list(args[0].shape),
            dtype=str(args[0].dtype).removeprefix("torch."),
            options={a: b for a, b in kw.items() if a != "alibi"},
            gpu=cs.gpu_query())
    return 0


if __name__ == "__main__":
    sys.exit(main())
