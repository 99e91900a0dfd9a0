from tpu_flash_torch.utils.device import DeviceInfo, device_info
from tpu_flash_torch.utils.tuning import (
    resolve_cache_config,
    select_cache_policy,
)

__all__ = ["DeviceInfo", "device_info", "resolve_cache_config",
           "select_cache_policy"]
