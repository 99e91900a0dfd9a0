from tpu_flash_torch.engine.cache import PagedKVCache, side_dtypes
from tpu_flash_torch.engine.dp import DataParallelEngine
from tpu_flash_torch.engine.health import HealthConfig
from tpu_flash_torch.engine.lora import LORA_PROJS, LoRAStore, apply_lora
from tpu_flash_torch.engine.runner import InferenceEngine
from tpu_flash_torch.engine.sampling import (
    GREEDY,
    SamplingParams,
    filtered_logits,
    sample_tokens,
)
from tpu_flash_torch.engine.scheduler import Request, Scheduler, StepPlan

__all__ = [
    "PagedKVCache", "side_dtypes", "DataParallelEngine", "HealthConfig",
    "InferenceEngine",
    "LORA_PROJS", "LoRAStore", "apply_lora",
    "GREEDY", "SamplingParams", "filtered_logits", "sample_tokens",
    "Request", "Scheduler", "StepPlan",
]
