"""End-to-end quantized-cache quality gate: the port of
``tpu_flash/bench/quality.py``.

Run the same prompts through the serving engine with a bf16 KV cache and
with each quantized cache dtype, greedy decoding both, and score how many
tokens the quantized engine reproduces. Greedy decode is deterministic,
so a divergence comes from the cache's quantization error.

Two rates per dtype:
- prefix_match: fraction of generated tokens before the first divergence
  (averaged over prompts), the strict serving-quality metric: after one
  wrong token the trajectories legitimately differ;
- positionwise_match: fraction of positions where tokens agree anyway
  (loose; trajectories can meet again).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from tpu_flash_torch.core.config import CacheConfig, EngineConfig


def generate_greedy(
    model,
    params,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int,
    kv_dtype: str = "bfloat16",
    *,
    page_size: int = 8,
    max_seq_len: int = 256,
    prefill_chunk: int = 64,
    max_batch_size: int = 4,
    device=None,
    recent_window: Optional[int] = None,  # None = CacheConfig default
) -> List[List[int]]:
    """Greedy-decode ``prompts`` through the paged engine with the given KV
    cache dtype. Returns one token list per prompt, in prompt order.

    The engine runs on the model's device; ``device``, when given, must
    name that device."""
    from tpu_flash_torch.engine import InferenceEngine

    if device is not None and torch.device(device) != model.device:
        raise ValueError(
            f"the engine runs on the model's device {model.device}, not "
            f"{device}"
        )
    n_pages_seq = -(-max_seq_len // page_size)
    cfg = EngineConfig(
        max_batch_size=max_batch_size,
        max_seq_len=max_seq_len,
        prefill_chunk=prefill_chunk,
        cache=CacheConfig(
            page_size=page_size,
            num_pages=n_pages_seq * max_batch_size + 8,
            max_pages_per_seq=n_pages_seq,
            kv_dtype=kv_dtype,
            **(
                {}
                if recent_window is None
                else {"recent_window": recent_window}
            ),
        ),
    )
    engine = InferenceEngine(model, params, cfg)
    rids = [
        engine.submit(list(p), max_new_tokens=max_new_tokens)
        for p in prompts
    ]
    outputs = engine.run()
    engine.close()
    return [outputs[r] for r in rids]


def _rates(ref: List[int], got: List[int]) -> Dict[str, float]:
    n = max(len(ref), len(got), 1)
    prefix = 0
    for a, b in zip(ref, got):
        if a != b:
            break
        prefix += 1
    pos = sum(1 for a, b in zip(ref, got) if a == b)
    return {"prefix": prefix / n, "position": pos / n}


def quant_quality_report(
    model,
    params,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int = 32,
    kv_dtypes: Sequence[str] = ("int8", "int4", "fp8"),
    baseline_dtype: str = "bfloat16",
    **gen_kwargs,
) -> Dict[str, Dict[str, float]]:
    """Token-match rates of each quantized cache dtype against the bf16
    engine.

    Returns {dtype: {"prefix_match": r, "positionwise_match": r,
    "n_tokens": n}}. Rates are averaged over prompts.
    """
    ref = generate_greedy(
        model, params, prompts, max_new_tokens, baseline_dtype, **gen_kwargs
    )
    report: Dict[str, Dict[str, float]] = {}
    for dt in kv_dtypes:
        got = generate_greedy(
            model, params, prompts, max_new_tokens, dt, **gen_kwargs
        )
        per = [_rates(r, g) for r, g in zip(ref, got)]
        report[dt] = {
            "prefix_match": sum(p["prefix"] for p in per) / len(per),
            "positionwise_match": sum(p["position"] for p in per) / len(per),
            "n_tokens": float(sum(len(r) for r in ref)),
        }
    return report
