from tpu_flash_torch.core.reference import SegmentIds
from tpu_flash_torch.ops.flash.api import FlashAttentionFn, flash_attention
from tpu_flash_torch.ops.flash.backward import flash_bwd, flash_bwd_plain
from tpu_flash_torch.ops.flash.debug import attention_weights, weights_plain
from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain
from tpu_flash_torch.ops.flash.paged_prefill import (
    paged_prefill_attention,
    paged_prefill_plain,
)
from tpu_flash_torch.ops.flash.quantized import (
    QuantizedAttentionInputs,
    dequantize_attention_inputs,
    flash_attention_quantized,
    quant_fwd_plain,
    quantize_attention_inputs,
)
from tpu_flash_torch.ops.flash.ragged import (
    flash_attention_ragged,
    ragged_prefill_plain,
)
from tpu_flash_torch.ops.flash.variant import (
    variant_attention,
    variant_attention_plain,
)

__all__ = [
    "FlashAttentionFn", "QuantizedAttentionInputs",
    "SegmentIds", "attention_weights", "dequantize_attention_inputs",
    "flash_attention", "flash_attention_quantized",
    "flash_attention_ragged", "flash_bwd", "flash_bwd_plain", "flash_fwd",
    "flash_fwd_plain", "paged_prefill_attention", "paged_prefill_plain",
    "quant_fwd_plain", "quantize_attention_inputs", "ragged_prefill_plain",
    "variant_attention", "variant_attention_plain", "weights_plain",
]
