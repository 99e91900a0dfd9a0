from tpu_flash_torch.core.reference import SegmentIds
from tpu_flash_torch.ops.flash.api import flash_attention
from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain

__all__ = ["SegmentIds", "flash_attention", "flash_fwd", "flash_fwd_plain"]
