"""Symmetric per-row int8 quantization for activations and the KV cache.

The port of the int8 tier of ``tpu_flash/ops/quant/quantize.py``: the last
axis of a tensor shares one absmax scale, so dequantization is a rank-1
rescale of scores and outputs. Rounding is half to even (``torch.round``,
as ``jnp.round``), so payloads and scales are byte-identical to the JAX
package's. The int4, int4g32 and fp8 tiers are ROADMAP queue 1, item 9.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT8_MAX = 127.0

_LATER_TIERS = (
    "int4, int4g32 and fp8 quantization are not ported yet "
    "(ROADMAP queue 1, item 9: the other cache tiers)"
)


class QuantizedTensor(NamedTuple):
    """Payload + per-row scales (the last axis reduced to 1)."""

    values: torch.Tensor
    scales: torch.Tensor
    dtype_name: str  # "int8" in this port so far


def quantize_int8_rows(x: torch.Tensor):
    """(int8 payload, f32 scales [..., 1]) of x by per-row absmax.

    Computed in f32: scale = absmax / 127 (1 where the row is all zero),
    q = clip(round_half_even(x / scale), -127, 127)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(
        absmax == 0, torch.ones_like(absmax), absmax / INT8_MAX
    )
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def quantize(x: torch.Tensor, dtype_name: str = "int8") -> QuantizedTensor:
    """Symmetric per-row (last-axis) absmax quantization."""
    if dtype_name != "int8":
        raise NotImplementedError(_LATER_TIERS)
    q, scale = quantize_int8_rows(x)
    return QuantizedTensor(values=q, scales=scale, dtype_name=dtype_name)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    if qt.dtype_name != "int8":
        raise NotImplementedError(_LATER_TIERS)
    return (qt.values.float() * qt.scales).to(dtype)
