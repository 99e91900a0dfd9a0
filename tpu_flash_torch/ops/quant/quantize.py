"""Quantization for activations and the KV cache: every cache tier.

The port of ``tpu_flash/ops/quant/quantize.py``. The symmetric tiers
share one absmax scale along the last axis, so dequantization is a rank-1
rescale of scores and outputs:

  * int8: ``clip(round(x / (absmax / 127)), -127, 127)``;
  * int4: ``clip(round(x / (absmax / 7)), -7, 7)``, two values a byte;
  * fp8: ``e4m3(x / (absmax / 448))``.

int4g32 is asymmetric per (row, 32-channel group): ``x ~ q * scale +
zero`` with unsigned nibbles ``q`` in [0, 15].

int4 packs two nibbles into an int8 carrier. "lanes" packing puts element
j in the low nibble and j + d/2 in the high one; "tokens" packing (the
KV-page layout) does the same along the rows: payload row j holds token
j low and token j + rows/2 high, both sign-extended (int4g32's nibbles
are unsigned).

Rounding is half to even (``torch.round``, as ``jnp.round``) and the e4m3
cast rounds to nearest even as ``jnp.astype`` does, so payloads and
scales are byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

INT8_MAX = 127.0
INT4_MAX = 7.0
FP8_MAX = 448.0  # e4m3fn
INT4_GROUP = 32  # channels per (scale, zero) group of the int4g32 tier
INT4_LEVELS = 15.0  # unsigned asymmetric nibbles span [0, 15]


def int4g32_num_groups(head_dim: int) -> int:
    """Groups per row of the int4g32 tier: d/32 when 32 divides d, else
    one whole-row group."""
    if head_dim >= INT4_GROUP and head_dim % INT4_GROUP == 0:
        return head_dim // INT4_GROUP
    return 1


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with IEEE division on every device: PyTorch's CUDA divide by
    a Python (CPU) scalar multiplies by its reciprocal, which can round
    one ulp off and move a later quantization level."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


class QuantizedTensor(NamedTuple):
    """Payload + per-row scales (the last axis reduced to 1), except
    int4g32, whose ``scales`` hold each row's ``2 * d/32`` group (scale...,
    zero...) pairs. ``packing`` says where int4 nibbles live ("lanes" or
    "tokens", see the module docstring)."""

    values: torch.Tensor
    scales: torch.Tensor
    dtype_name: str  # "int8" | "int4" | "int4g32" | "fp8"
    packing: str = "lanes"

    @property
    def logical_shape(self):
        shape = tuple(self.values.shape)
        if self.dtype_name in ("int4", "int4g32"):
            if self.packing == "tokens":
                return (*shape[:-2], shape[-2] * 2, shape[-1])
            return (*shape[:-1], shape[-1] * 2)
        return shape


def _nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int8 bytes of two int nibble tensors (low, high)."""
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def pack_int4(x_int: torch.Tensor) -> torch.Tensor:
    """Lane packing: element j low, element j + d/2 high."""
    d = x_int.shape[-1]
    return _nibbles(x_int[..., : d // 2].int(), x_int[..., d // 2:].int())


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`, sign-extending each nibble (int32)."""
    p = packed.int()
    return torch.cat([(p << 28) >> 28, (p << 24) >> 28], dim=-1)


def pack_int4_tokens(x_int: torch.Tensor) -> torch.Tensor:
    """Token packing: row j low, row j + rows/2 high."""
    rows = x_int.shape[-2]
    return _nibbles(x_int[..., : rows // 2, :].int(),
                    x_int[..., rows // 2:, :].int())


def unpack_int4_tokens(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_tokens`, sign-extended (int32)."""
    p = packed.int()
    return torch.cat([(p << 28) >> 28, (p << 24) >> 28], dim=-2)


def unpack_uint4_tokens(packed: torch.Tensor) -> torch.Tensor:
    """Token-packed unsigned nibbles (the int4g32 payload), int32."""
    p = packed.int()
    return torch.cat([p & 0xF, (p >> 4) & 0xF], dim=-2)


def quantize_group_asym(x: torch.Tensor, group: Optional[int] = None):
    """Group-wise asymmetric int4: per (row, ``group``-channel group)
    ``x ~ q * scale + zero``, q in [0, 15]. Returns (q [..., rows, d]
    int32 nibble values, scales [..., rows, 2 * d/group] = per row
    [scale..., zero...])."""
    xf = x.float()
    *lead, rows, d = xf.shape
    if group is None:
        group = d // int4g32_num_groups(d)
    if d % group:
        raise ValueError(f"head_dim {d} must divide group {group}")
    ng = d // group
    xg = xf.reshape(*lead, rows, ng, group)
    lo = xg.amin(dim=-1)
    hi = xg.amax(dim=-1)
    span = hi - lo
    scale = torch.where(span == 0, torch.ones_like(span),
                        div_exact(span, INT4_LEVELS))
    q = torch.clamp(torch.round((xg - lo[..., None]) / scale[..., None]),
                    0.0, INT4_LEVELS).int()
    return q.reshape(*lead, rows, d), torch.cat([scale, lo], dim=-1)


def dequantize_group_asym(q: torch.Tensor, scales: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_group_asym` (q unpacked, [..., rows,
    d]); the group count comes from the scales' trailing dim."""
    *lead, rows, d = q.shape
    ng = scales.shape[-1] // 2
    xg = (q.reshape(*lead, rows, ng, d // ng).float()
          * scales[..., :ng, None] + scales[..., ng:, None])
    return xg.reshape(*lead, rows, d).to(dtype)


def _absmax_scale(xf: torch.Tensor, top: float) -> torch.Tensor:
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    return torch.where(absmax == 0, torch.ones_like(absmax),
                       div_exact(absmax, top))


def quantize_int8_rows(x: torch.Tensor):
    """(int8 payload, f32 scales [..., 1]) of x by per-row absmax."""
    xf = x.float()
    scale = _absmax_scale(xf, INT8_MAX)
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def quantize_int4_rows(x: torch.Tensor):
    """(int32 values in [-7, 7], f32 scales [..., 1]) by per-row absmax."""
    xf = x.float()
    scale = _absmax_scale(xf, INT4_MAX)
    q = torch.clamp(torch.round(xf / scale), -INT4_MAX, INT4_MAX)
    return q.int(), scale


def quantize_fp8_rows(x: torch.Tensor):
    """(e4m3 payload, f32 scales [..., 1]) by per-row absmax."""
    xf = x.float()
    scale = _absmax_scale(xf, FP8_MAX)
    return (xf / scale).to(torch.float8_e4m3fn), scale


def quantize(x: torch.Tensor, dtype_name: str = "int8",
             packing: str = "lanes") -> QuantizedTensor:
    """Symmetric per-row (last-axis) absmax quantization."""
    if dtype_name == "int8":
        q, scale = quantize_int8_rows(x)
    elif dtype_name == "int4":
        qi, scale = quantize_int4_rows(x)
        if packing == "tokens":
            if x.shape[-2] % 2:
                raise ValueError("token packing needs an even row count")
            q = pack_int4_tokens(qi)
        else:
            if x.shape[-1] % 2:
                raise ValueError("lane packing needs an even last dimension")
            q = pack_int4(qi)
    elif dtype_name == "fp8":
        q, scale = quantize_fp8_rows(x)
    else:
        raise ValueError(f"unsupported quant dtype {dtype_name!r}")
    return QuantizedTensor(values=q, scales=scale, dtype_name=dtype_name,
                           packing=packing)


def quantize_pages(pages: torch.Tensor, dtype_name: str) -> QuantizedTensor:
    """Quantize KV pages [..., page_size, head_dim] in the cache layout:
    int8 and fp8 keep the page shape; int4 and int4g32 token-pack to
    [..., page_size/2, d]; int4g32 carries its group (scale, zero) rows
    transposed, [..., 2 * d/32, page_size]."""
    if dtype_name == "int4g32":
        q, scales = quantize_group_asym(pages)
        return QuantizedTensor(values=pack_int4_tokens(q),
                               scales=scales.transpose(-1, -2).contiguous(),
                               dtype_name="int4g32", packing="tokens")
    packing = "tokens" if dtype_name == "int4" else "lanes"
    return quantize(pages, dtype_name, packing=packing)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    if qt.dtype_name == "int4g32":
        if qt.packing != "tokens":
            raise ValueError("int4g32 is a token-packed page format")
        return dequantize_group_asym(unpack_uint4_tokens(qt.values),
                                     qt.scales.transpose(-1, -2), dtype)
    if qt.dtype_name == "int4":
        unpack = unpack_int4_tokens if qt.packing == "tokens" else unpack_int4
        vals = unpack(qt.values).float()
    elif qt.dtype_name in ("int8", "fp8"):
        vals = qt.values.float()
    else:
        raise ValueError(f"unsupported quant dtype {qt.dtype_name!r}")
    return (vals * qt.scales).to(dtype)
