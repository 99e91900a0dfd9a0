from tpu_flash_torch.core.reference import SegmentIds
from tpu_flash_torch.ops.flash.api import flash_attention
from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain
from tpu_flash_torch.ops.flash.paged_prefill import (
    paged_prefill_attention,
    paged_prefill_plain,
)
from tpu_flash_torch.ops.flash.ragged import (
    flash_attention_ragged,
    ragged_prefill_plain,
)

__all__ = [
    "SegmentIds", "flash_attention", "flash_attention_ragged", "flash_fwd",
    "flash_fwd_plain", "paged_prefill_attention", "paged_prefill_plain",
    "ragged_prefill_plain",
]
