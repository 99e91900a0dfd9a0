from tpu_flash_torch.bench.suite import (
    BenchResult,
    attention_flops,
    attention_hbm_bytes,
    bench_decode_tokens_per_s,
    bench_flash_prefill,
    time_per_call,
)

__all__ = [
    "BenchResult",
    "attention_flops",
    "attention_hbm_bytes",
    "bench_decode_tokens_per_s",
    "bench_flash_prefill",
    "time_per_call",
]
