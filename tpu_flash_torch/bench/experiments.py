"""Kernel-variant experiments for the causal prefill hot path, on the card.

The port of ``tpu_flash/bench/experiments.py::main``: every built variant
of the ``variant_fwd`` kernel (``ops/flash/variant.py``: block shapes x
mask mode x exp2) at b1 h32 s2048 d128 bf16 causal, each first held to a
parity gate against the exact oracle, then timed. Run:

    python -m tpu_flash_torch.bench.experiments [--json out.json]
        [--device cuda|cpu] [--iters N]

One line a variant on stderr and one JSON row a variant on stdout (the
bench CLI's style); ``--json`` also writes the rows to a file. A variant
whose max |out - oracle| exceeds ``PARITY_TOL`` prints ``PARITY FAIL`` and
is not timed; the command then exits 1.
On ``--device cpu`` the plain version runs every variant (block shapes
need not be built there), and the times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

PARITY_TOL = 2.5e-2  # the JAX harness's gate


def variants(tiles=None):
    """(blocks, mask_mode, use_exp2) of every variant, the JAX sweep's
    order: each block shape with both mask modes, exp2 off then on."""
    from tpu_flash_torch.ops.flash.variant import KERNEL_TILES, MASK_MODES

    return [(blocks, mask_mode, use_exp2)
            for blocks in (tiles or KERNEL_TILES)
            for mask_mode in MASK_MODES for use_exp2 in (False, True)]


def sweep(*, heads=32, seq=2048, device="cuda", iters=32, tiles=None):
    """Rows of the variant sweep at b1 ``heads`` ``seq`` d128 (``tiles``:
    the block shapes, by default every built one): the parity gate first,
    then the time of each variant that passes it."""
    from tpu_flash_torch.bench.suite import attention_flops, time_per_call
    from tpu_flash_torch.core.reference import reference_gqa_attention
    from tpu_flash_torch.ops.flash.variant import variant_attention

    batch, head_dim = 1, 128
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(batch, heads, seq, head_dim, generator=g,
                           device=device).bfloat16() for _ in range(3))
    flops = attention_flops(batch, heads, seq, seq, head_dim, True)
    sm = head_dim ** -0.5
    with torch.no_grad():
        ref = reference_gqa_attention(q, k, v, causal=True).float()
    rows = []
    for (bq, bkvm, bkv), mask_mode, use_exp2 in variants(tiles):
        def step(bq=bq, bkvm=bkvm, bkv=bkv, mask_mode=mask_mode,
                 use_exp2=use_exp2):
            return variant_attention(
                q, k, v, sm_scale=sm, block_q=bq, block_kv_major=bkvm,
                block_kv=bkv, mask_mode=mask_mode, use_exp2=use_exp2)

        label = (f"blocks={bq}/{bkvm}/{bkv} mask={mask_mode:6s} "
                 f"exp2={int(use_exp2)}")
        with torch.no_grad():
            err = float((step().float() - ref).abs().max())
        row = {"name": f"variant b{batch} h{heads} s{seq} d{head_dim} "
                       f"bfloat16 causal {bq}/{bkvm}/{bkv} {mask_mode}"
                       f"{' exp2' if use_exp2 else ''}",
               "block_q": bq, "block_kv_major": bkvm, "block_kv": bkv,
               "mask_mode": mask_mode, "use_exp2": use_exp2,
               "max_abs_err": err, "target": PARITY_TOL,
               "pass": err <= PARITY_TOL,
               "backend": torch.device(device).type}
        if not row["pass"]:
            print(f"{label}: PARITY FAIL err={err:.3e}", file=sys.stderr,
                  flush=True)
            rows.append(row)
            continue
        with torch.no_grad():
            secs = time_per_call(step, device=device, inner=iters)
        row.update(metric="ms", value=secs * 1e3,
                   tflops=flops / secs / 1e12)
        print(f"{label}: {secs * 1e3:7.3f} ms {row['tflops']:6.1f} TFLOP/s "
              f"(err {err:.1e})", file=sys.stderr, flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="A/B sweep of the causal-forward variant kernel")
    ap.add_argument("--json", default=None, help="write rows as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA card (use --device cpu for the "
                 "plain version)")
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    rows = sweep(device=args.device, iters=args.iters)
    for r in rows:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    failed = [r["name"] for r in rows if not r["pass"]]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
