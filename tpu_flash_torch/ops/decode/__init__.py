from tpu_flash_torch.ops.decode.paged import (
    paged_attention,
    paged_decode_plain,
)
from tpu_flash_torch.ops.decode.tail import (
    merge_attention_states,
    recent_tail_state,
)

__all__ = [
    "paged_attention", "paged_decode_plain", "merge_attention_states",
    "recent_tail_state",
]
