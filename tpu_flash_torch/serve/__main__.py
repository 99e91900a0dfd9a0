"""Serve a model over HTTP:  python -m tpu_flash_torch.serve [options]

Without --hf-dir this serves a small randomly initialised demo model
(the JAX package's demo geometry; the full stack is real: continuous
batching, paged quantized KV cache, prefix cache, streaming), useful for
smoke tests and client development. Point --hf-dir at a HuggingFace
checkpoint directory for real weights (tpu_flash_torch.checkpoint).

The engine runs on --device (default cuda, the hand-written kernels);
with no CUDA device the command exits non-zero unless --device cpu is
given, which serves on the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

# The demo model: the JAX package's (tpu_flash/serve/__main__.py).
DEMO = dict(
    name="demo", vocab_size=512, hidden_size=256, num_layers=2,
    num_q_heads=8, num_kv_heads=4, head_dim=128, intermediate_size=512,
    dtype="bfloat16",
)
DEMO_SEED = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8", "int4",
                             "int4g32", "k8v4", "fp8"])
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per page; default: the engine's "
                    "regime-aware auto policy (utils/tuning.py)")
    ap.add_argument("--hf-dir", default=None,
                    help="HF checkpoint dir (config.json + weights)")
    ap.add_argument("--byte-tokenizer", action="store_true",
                    help="accept text prompts via the byte-level codec")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (cpu: the plain "
                    "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("tpu_flash_torch.serve: no CUDA device; pass --device cpu "
              "to serve on the CPU", file=sys.stderr)
        return 2

    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine
    from tpu_flash_torch.models import FlashTransformer, ModelConfig
    from tpu_flash_torch.serve import ByteTokenizer, serve

    if args.hf_dir:
        from tpu_flash_torch.checkpoint import load_hf_dir

        model, params = load_hf_dir(args.hf_dir, device=args.device)
    else:
        model = FlashTransformer(ModelConfig(**DEMO), device=args.device)
        params = model.init(
            torch.Generator(device=args.device).manual_seed(DEMO_SEED))

    if args.page_size is None:  # auto layout (resolved at engine init)
        cache = CacheConfig(kv_dtype=args.kv_dtype)
    else:
        pps = -(-args.max_seq_len // args.page_size)
        cache = CacheConfig(
            page_size=args.page_size,
            num_pages=args.max_batch_size * pps + 8,
            max_pages_per_seq=pps,
            kv_dtype=args.kv_dtype,
        )
    engine = InferenceEngine(
        model, params,
        EngineConfig(
            max_batch_size=args.max_batch_size,
            max_seq_len=args.max_seq_len,
            cache=cache,
        ),
    )
    tok = ByteTokenizer(offset=0) if args.byte_tokenizer else None
    print(f"serving {model.config.name} on http://{args.host}:{args.port} "
          f"({args.device})", flush=True)
    serve(engine, host=args.host, port=args.port, tokenizer=tok,
          model_name=model.config.name, block=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
