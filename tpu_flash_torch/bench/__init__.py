from tpu_flash_torch.bench.suite import (
    BenchResult,
    attention_flops,
    attention_hbm_bytes,
    bench_decode_tokens_per_s,
    bench_flash_prefill,
    time_per_call,
)
from tpu_flash_torch.utils.profiling import (
    KernelProfile,
    profile_step,
    roofline_report,
    trace,
)

__all__ = [
    "BenchResult",
    "KernelProfile",
    "attention_flops",
    "attention_hbm_bytes",
    "bench_decode_tokens_per_s",
    "bench_flash_prefill",
    "profile_step",
    "roofline_report",
    "time_per_call",
    "trace",
]
