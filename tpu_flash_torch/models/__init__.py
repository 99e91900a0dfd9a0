from tpu_flash_torch.models.configs import (
    BLOOM_7B,
    GEMMA2_9B,
    LLAMA2_7B,
    LLAMA3_8B,
    LLAMA31_8B,
    MISTRAL_7B,
    QWEN2_7B,
    TINY_TEST,
    ModelConfig,
)
from tpu_flash_torch.models.transformer import FlashTransformer, shard_params

__all__ = [
    "BLOOM_7B", "GEMMA2_9B", "LLAMA2_7B", "LLAMA3_8B", "LLAMA31_8B",
    "MISTRAL_7B", "QWEN2_7B", "TINY_TEST", "ModelConfig",
    "FlashTransformer", "shard_params",
]
