"""Device probing: the port of ``tpu_flash/utils/device.py``.

The counterpart of the reference's ``check_gpu_props`` probe (SM count,
memory sizes): :func:`device_info` reads ``torch.cuda.get_device_properties``
and adds the data-sheet figures the bench's rooflines need (memory rate,
dense tensor-core rates), looked up by the card's name. On the CPU it
reports ``platform="cpu"`` and no rates a roofline could use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_flash_torch.ops.decode.paged import fp8_native_default

# Data-sheet figures by name substring (NVIDIA's H100 SXM data sheet, dense
# rates without sparsity): (memory GB/s, bf16 TFLOP/s, int8 and fp8
# TFLOP/s, shared memory a block can use in bytes). Memory size and SM
# count come from the card's properties.
_CARD_TABLE = {
    "h100": (3350, 989, 1979, 232448),
}


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    kind: str
    platform: str  # "gpu" | "cpu"
    num_devices: int
    hbm_bytes: int
    hbm_bandwidth_gbps: float
    peak_bf16_tflops: float
    peak_int8_tflops: float
    smem_per_block_bytes: int
    num_sms: int
    compute_capability: tuple = (0, 0)
    # e4m3 operands feed the tensor cores directly (the fp8 kernels'
    # default tier, ops/decode/paged.py::fp8_native_default).
    native_fp8_matmul: bool = False

    def roofline_attention_tflops(
        self, flops: float, hbm_bytes: float
    ) -> float:
        """Achievable bf16 TFLOP/s for a kernel with this FLOP:byte
        ratio."""
        intensity = flops / max(hbm_bytes, 1.0)
        bw = self.hbm_bandwidth_gbps * 1e9
        return min(self.peak_bf16_tflops * 1e12, intensity * bw) / 1e12


def device_info(device=None) -> DeviceInfo:
    """The card's properties (the first CUDA device unless ``device``
    names one), or a CPU record when ``device`` is the CPU or there is no
    card."""
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return DeviceInfo(
            kind="cpu", platform="cpu", num_devices=1, hbm_bytes=0,
            hbm_bandwidth_gbps=0.0, peak_bf16_tflops=0.0,
            peak_int8_tflops=0.0, smem_per_block_bytes=0, num_sms=0,
        )
    props = torch.cuda.get_device_properties(dev)
    row: Optional[tuple] = None
    for key, vals in _CARD_TABLE.items():
        if key in props.name.lower():
            row = vals
            break
    if row is None:
        raise ValueError(
            f"no data-sheet figures for {props.name!r}; known cards: "
            f"{sorted(_CARD_TABLE)}"
        )
    gbps, bf16, int8, smem = row
    cc = (props.major, props.minor)
    return DeviceInfo(
        kind=props.name, platform="gpu",
        num_devices=torch.cuda.device_count(),
        hbm_bytes=props.total_memory, hbm_bandwidth_gbps=float(gbps),
        peak_bf16_tflops=float(bf16), peak_int8_tflops=float(int8),
        smem_per_block_bytes=smem, num_sms=props.multi_processor_count,
        compute_capability=cc, native_fp8_matmul=fp8_native_default(dev),
    )

