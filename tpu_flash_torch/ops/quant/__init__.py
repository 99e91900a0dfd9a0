from tpu_flash_torch.ops.quant.quantize import (
    INT8_MAX,
    QuantizedTensor,
    dequantize,
    quantize,
    quantize_int8_rows,
)

__all__ = [
    "INT8_MAX", "QuantizedTensor", "dequantize", "quantize",
    "quantize_int8_rows",
]
