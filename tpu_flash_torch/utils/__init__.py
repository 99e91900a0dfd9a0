from tpu_flash_torch.utils.tuning import (
    resolve_cache_config,
    select_cache_policy,
)

__all__ = ["resolve_cache_config", "select_cache_policy"]
