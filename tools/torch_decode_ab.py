#!/usr/bin/env python3
"""This tree's paged decode (K4) against another checkout's, in turns, on
one CUDA card.

    python3 tools/torch_decode_ab.py DIR [--rounds N] [--json out.json]

DIR is a checkout of another commit (for example the parent, unpacked by
``git archive <rev> | tar -x -C build/parent``). Its K4 -- its
``tpu_flash_torch/ops/decode/paged.py`` launching its
``csrc/paged_decode.cu`` through its own ``ops/build.py`` -- is loaded
beside this tree's (the two K4 libraries build at once, with every other
kernel of this tree) and swapped in at the engine's one call site
(``engine.runner.paged_attention``). Everything else both sides run is
this tree's, so the two differ by K4's wrapper and kernel alone.

  * host: one K4 call's host time at phase 3's decode shape (b 8, 32 / 8
    heads, context 2048; int8 mxu pages with the 128-token ring, and bf16
    pages), the device held by a spin kernel so that the host clock reads
    the enqueue alone: each side's whole wrapper and its C entry alone
    (this tree's launches a cluster by ``cudaLaunchKernelEx``), and the
    parts this tree's wrapper adds (the slice plan, aligning the ring).
    ``--rounds`` rounds of (this, other, other, this), 200 calls a
    reading.
  * decode window: ``tools/torch_serve_profile.py``'s untraced decode
    window (phase 4's Llama-3-8B geometry, seeded weights, 8 prompts of
    100..1500 tokens, 32 new tokens each, the engine's default routing)
    on the int8 + 128-token ring and bf16 caches, each window on a new
    engine (built and warmed as phase 4's): one untimed window,
    then ``--rounds`` rounds of (this, other, other, this), alternating
    with (other, this, this, other): 2 * rounds pairs, each side first
    in half of them. The two windows of a pair must give the same greedy
    tokens, and each window launch only its side's K4.

One JSON line a (measurement, shape or cache): the median, the quartiles
and every reading of each side (the windows also the pairs this tree
won), and the card from nvidia-smi. Exit 1 if a pair's tokens differ or
a side's K4 was not the one launched. Needs a CUDA card, nvcc and PyTorch.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HOST_CALLS = 200
NEW_TOKENS = 32
# (tier tag, decode_inputs' kv dtype and ring, paged_attention options)
HOST_SHAPES = (("int8_mxu_ring128", "int8", 128, dict(int8_mxu=True)),
               ("bf16", "bfloat16", 0, {}))


def load_other(root: Path):
    """(build module, paged module) of the checkout at ``root``: its
    ``ops/build.py`` (its own sources and build directory) and its
    ``ops/decode/paged.py`` launching through that build module."""
    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    pkg = root / "tpu_flash_torch"
    other_build = load("k4_other_build", pkg / "ops" / "build.py")
    other_paged = load("k4_other_paged", pkg / "ops" / "decode" / "paged.py")
    other_paged.build = other_build
    return other_build, other_paged


def spread(xs):
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return dict(median=med, q1=q1, q3=q3, all=xs)


def turns(r):
    """Round r's order of the two sides (0 this tree, 1 the other)."""
    return (0, 1, 1, 0) if r % 2 == 0 else (1, 0, 0, 1)


def host_us(fn, calls=HOST_CALLS):
    """Host microseconds a call of fn(), the device spinning meanwhile."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * calls * 500e-6))  # 500 us a call at 2 GHz
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def captured_entry(kernel, call):
    """A call of ``kernel``'s C entry with the arguments ``call()`` hands
    it (the wrapper run once with the launch recorded instead of made)."""
    seen = []
    kernel.launch = lambda *a, tag=None: seen.append(a)
    try:
        out = call()  # the output the captured pointers write to
    finally:
        del kernel.launch
    (args,) = seen
    fn = kernel.function()
    return lambda out=out: fn(*args)


def host_rows(rounds, sides, gpu):
    from chip_smoke import decode_inputs
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.decode import paged as dp

    rows = []
    for tag, kv_dtype, ring, kw in HOST_SHAPES:
        q, kp, vp, lengths, table, rkw = decode_inputs("cuda", kv_dtype,
                                                        ring)
        kw = dict(kw, **rkw)
        k_tier, v_tier = (dp.side_tier(x, int8_mxu=True, fp8_native=True)[0]
                          for x in (kp, vp))
        ps, pps = 128, table.shape[1]  # decode_inputs' default pages
        bk = dp.pages_per_block(ps, pps, True) * ps

        def wrapper(paged):
            return lambda: paged.paged_attention(q, kp, vp, lengths, table,
                                                 **kw)

        fns = {"wrapper": [wrapper(p) for _, p in sides],
               "c_entry": [captured_entry(b.PAGED_DECODE, wrapper(p))
                           for b, p in sides]}
        parts = {"launch_slices": lambda: dp.launch_slices(
            q, k_tier, v_tier, 8, ps, pps, bk, ring)}
        if ring:
            parts["aligned_ring"] = lambda: (build.aligned(rkw["recent_k"]),
                                             build.aligned(rkw["recent_v"]))
        for what, pair in fns.items():
            us = ([], [])
            for f in pair:
                f()
            for r in range(rounds):
                for side in turns(r):
                    us[side].append(host_us(pair[side]))
            row = dict(measure=f"host_us_{what}", shape=tag,
                       this=spread(us[0]), other=spread(us[1]), gpu=gpu)
            rows.append(row)
            print(json.dumps(row), flush=True)
        for what, f in parts.items():
            f()
            us = [host_us(f) for _ in range(rounds)]
            row = dict(measure=f"host_us_{what}", shape=tag, this=spread(us),
                       gpu=gpu)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def window_rows(rounds, sides, gpu):
    import torch

    from chip_smoke import (MAIN_TIERS, main_path_engine, main_path_model,
                            main_path_prompts)
    from torch_serve_profile import fill_to_decode
    from tpu_flash_torch.engine import runner
    from tpu_flash_torch.models import LLAMA3_8B

    model, params = main_path_model("cuda")
    prompts = main_path_prompts(LLAMA3_8B.vocab_size)
    own = runner.paged_attention
    rows = []
    with torch.no_grad():
        for kv_dtype, ring in MAIN_TIERS:
            def window(side):
                """(wall s, greedy tokens, K4 launches of each side) on a
                new engine, so that every window starts from one state."""
                eng = main_path_engine(model, params, kv_dtype, ring,
                                       prompts)
                runner.paged_attention = (own, sides[1][1].paged_attention
                                          )[side]
                old = set(eng.outputs)
                fill_to_decode(eng, prompts, NEW_TOKENS)
                before = [b.PAGED_DECODE.launches for b, _ in sides]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                runner.paged_attention = own
                tokens = [eng.outputs[i] for i in sorted(set(eng.outputs)
                                                          - old)]
                eng.close()
                return wall, tokens, [b.PAGED_DECODE.launches - n
                                      for (b, _), n in zip(sides, before)]

            window(0)  # untimed
            walls, toks, launched = ([], []), ([], []), [[0, 0], [0, 0]]
            for r in range(rounds):
                for side in turns(r):
                    wall, tokens, launches = window(side)
                    walls[side].append(wall)
                    toks[side].append(tokens)
                    launched[side] = [a + b for a, b in
                                      zip(launched[side], launches)]
            # Pair i is this tree's and the other's i-th window (turns()
            # puts them next to each other, each side first in half).
            same = sum(a == b for a, b in zip(*toks))
            row = dict(measure="decode_window_wall_s", cache=kv_dtype,
                       ring=ring, tokens=len(prompts) * NEW_TOKENS,
                       this=spread(walls[0]), other=spread(walls[1]),
                       change_over_other=statistics.median(walls[0])
                       / statistics.median(walls[1]) - 1.0,
                       pairs=len(walls[0]),
                       pairs_won=sum(a < b for a, b in zip(*walls)),
                       pairs_same_tokens=same,
                       windows_alike=all(t == toks[0][0]
                                         for t in toks[0] + toks[1]),
                       k4_launches=dict(this=launched[0],
                                        other=launched[1]),
                       gpu=gpu)
            row["ok"] = (same == len(walls[0]) and launched[0][1] == 0
                         and launched[1][0] == 0
                         and min(launched[0][0], launched[1][1]) > 0)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if not args or args[0].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    from chip_smoke import gpu_query
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.decode import paged as dp

    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args \
        else 5
    other_build, other_paged = load_other(Path(args[0]).resolve())
    proc = other_build.PAGED_DECODE.start_build()
    build.build_all()
    other_build.PAGED_DECODE.finish_build(proc)
    sides = ((build, dp), (other_build, other_paged))
    gpu = gpu_query()
    rows = host_rows(rounds, sides, gpu) + window_rows(rounds, sides, gpu)
    if "--json" in args:
        with open(args[args.index("--json") + 1], "w") as f:
            json.dump(rows, f)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
