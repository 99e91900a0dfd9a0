from tpu_flash_torch.core.config import (
    AttentionConfig,
    CacheConfig,
    EngineConfig,
    MeshConfig,
    TileSizes,
)
from tpu_flash_torch.core.reference import (
    DEFAULT_MASK_VALUE,
    SegmentIds,
    alibi_slopes,
    gather_pages_to_dense,
    reference_attention,
    reference_decode_attention,
    reference_gqa_attention,
)

__all__ = [
    "AttentionConfig", "CacheConfig", "EngineConfig", "MeshConfig",
    "TileSizes",
    "DEFAULT_MASK_VALUE", "SegmentIds", "alibi_slopes",
    "gather_pages_to_dense", "reference_attention",
    "reference_decode_attention", "reference_gqa_attention",
]
