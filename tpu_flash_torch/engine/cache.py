"""Paged KV cache: device-side page tensors and the append path.

The port of ``tpu_flash/engine/cache.py``, every tier. Layout per layer
(matching ``ops/decode/paged.py``):
  k_pages, v_pages: [num_layers, num_kv_heads, num_pages, rows, d]; rows
      is page_size, or page_size / 2 for token-packed int4 and int4g32
      nibbles (payload row j holds token j low, token j + ps/2 high);
      payloads are the model-facing dtype (bf16, f32), int8 (int8, int4,
      int4g32) or e4m3 (fp8). k8v4 stores K as int8 and V as int4.
  k_scales, v_scales (quantized): [num_layers, num_kv_heads, num_pages,
      page_size] f32 per token, or for int4g32 the group (scale, zero)
      rows transposed, [num_layers, num_kv_heads, num_pages, 2 * d/32,
      page_size].
  k_recent, v_recent (quantized, recent_window > 0): a bf16 ring
      [num_layers, num_slots, num_kv_heads, W, d]; position p of a slot
      lives at ring row p % W.

Unlike the JAX cache, whose appends are pure functions, this cache owns
its buffers and writes them in place (``index_put_``): ``append``
mutates and returns ``self``. ``index_put_`` with repeated indices keeps
an arbitrary writer on CUDA, so every writer of one element writes the
same bytes: where one append carries several tokens for the same page
row or ring row (prefill padding, which goes to the trash page and trash
slot; a prefill chunk longer than the ring), each writes the LAST
writer's bytes, the JAX last-writer-wins result. A packed nibble byte
may have two writers that carry different halves (any chunk that spans
a half-page boundary); each then writes the merged byte of both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_flash_torch.core.config import CacheConfig
from tpu_flash_torch.ops.quant.quantize import (
    QuantizedTensor,
    int4g32_num_groups,
    quantize_fp8_rows,
    quantize_group_asym,
    quantize_int4_rows,
    quantize_int8_rows,
)

PACKED = ("int4", "int4g32")


def side_dtypes(kv_dtype: str):
    """(k_dtype, v_dtype) of a cache tier: "k8v4" mixes int8 K with int4
    V, every other tier uses one dtype for both sides."""
    if kv_dtype == "k8v4":
        return "int8", "int4"
    return kv_dtype, kv_dtype


def _quantize_rows(x: torch.Tensor, kv_dtype: str):
    """Per-row quantization of new tokens [tok, hkv, d]: (payload,
    scales [tok, hkv]); int4 gives unpacked values in [-7, 7], int4g32
    unsigned nibbles and scales [tok, hkv, 2 * d/32]; identity (x, None)
    for the float tiers."""
    if kv_dtype == "int8":
        q, scale = quantize_int8_rows(x)
    elif kv_dtype == "int4":
        q, scale = quantize_int4_rows(x)
    elif kv_dtype == "fp8":
        q, scale = quantize_fp8_rows(x)
    elif kv_dtype == "int4g32":
        return quantize_group_asym(x)
    elif kv_dtype in ("bfloat16", "float32"):
        return x, None
    else:
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    return q, scale[..., 0]


def _last_writer(keys: torch.Tensor, num_keys: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """For each token, the index of the last token with the same key
    (among those where ``mask`` holds; -1 where none does)."""
    idx = torch.arange(keys.numel(), device=keys.device)
    if mask is not None:
        idx = torch.where(mask, idx, -1)
    last = torch.full((num_keys,), -1, dtype=idx.dtype, device=keys.device)
    last.scatter_reduce_(0, keys, idx, reduce="amax")
    return last[keys]


def _side_layout(dtype_name: str, page_size: int):
    """(payload dtype, payload rows a page) of one cache side."""
    if dtype_name in PACKED:
        if page_size % 2:
            raise ValueError("int4 cache requires an even page_size")
        return torch.int8, page_size // 2
    if dtype_name == "int8":
        return torch.int8, page_size
    if dtype_name == "fp8":
        return torch.float8_e4m3fn, page_size
    return getattr(torch, dtype_name), page_size


@dataclasses.dataclass
class PagedKVCache:
    """Device tensors of one model's KV pages across layers."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]
    v_scales: Optional[torch.Tensor]
    page_size: int
    kv_dtype: str  # bfloat16|float32|int8|int4|int4g32|k8v4|fp8
    k_recent: Optional[torch.Tensor] = None
    v_recent: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        config: CacheConfig,
        num_slots: int = 0,
        device=None,
    ) -> "PagedKVCache":
        device = device if device is not None else "cuda"
        quant = config.quantized
        ps = config.page_size

        def pages(side):
            dt, rows = _side_layout(side, ps)
            return torch.zeros((num_layers, num_kv_heads, config.num_pages,
                                rows, head_dim), dtype=dt, device=device)

        if config.kv_dtype == "int4g32":
            scale_shape = (num_layers, num_kv_heads, config.num_pages,
                           2 * int4g32_num_groups(head_dim), ps)
        else:
            scale_shape = (num_layers, num_kv_heads, config.num_pages, ps)

        def scales():
            if not quant:
                return None
            return torch.ones(scale_shape, dtype=torch.float32,
                              device=device)

        k_recent = v_recent = None
        if quant and config.recent_window and num_slots:
            ring = (num_layers, num_slots, num_kv_heads,
                    config.recent_window, head_dim)
            k_recent = torch.zeros(ring, dtype=torch.bfloat16, device=device)
            v_recent = torch.zeros(ring, dtype=torch.bfloat16, device=device)
        k_dt, v_dt = side_dtypes(config.kv_dtype)
        return cls(
            k_pages=pages(k_dt), v_pages=pages(v_dt),
            k_scales=scales(), v_scales=scales(),
            page_size=ps, kv_dtype=config.kv_dtype,
            k_recent=k_recent, v_recent=v_recent,
        )

    @property
    def quantized(self) -> bool:
        return self.kv_dtype in ("int8", "int4", "int4g32", "k8v4", "fp8")

    @property
    def recent_window(self) -> int:
        return 0 if self.k_recent is None else self.k_recent.shape[3]

    def layer_view(self, layer: int):
        """(k, v) for ``paged_attention``: QuantizedTensor when quantized
        (per-token scales as [hkv, pages, ps, 1]; int4g32's group rows as
        stored, [hkv, pages, 2 * d/32, ps])."""
        if not self.quantized:
            return self.k_pages[layer], self.v_pages[layer]

        def view(vals, scales, side):
            packing = "tokens" if side in PACKED else "lanes"
            if side != "int4g32":
                scales = scales[..., None]
            return QuantizedTensor(vals, scales, side, packing)

        k_dt, v_dt = side_dtypes(self.kv_dtype)
        return (view(self.k_pages[layer], self.k_scales[layer], k_dt),
                view(self.v_pages[layer], self.v_scales[layer], v_dt))

    @staticmethod
    def _write_packed(pages: torch.Tensor, page_ids, offsets, q):
        """Token-packed nibbles: token at in-page offset o lives in byte
        row o % rows, low nibble for o < rows, high for the rest. Each
        byte takes the last in-call writer of each half, or keeps the
        stored half where no token of the call writes it; every writer of
        a byte writes that same merged byte."""
        rows = pages.shape[2]
        prow = offsets % rows
        is_high = offsets >= rows
        key = page_ids * rows + prow
        n_keys = pages.shape[1] * rows
        lo_src = _last_writer(key, n_keys, ~is_high)
        hi_src = _last_writer(key, n_keys, is_high)
        nib = (q.int() & 0xF).transpose(0, 1)  # [hkv, tok, d]
        old = pages[:, page_ids, prow].int() & 0xFF  # [hkv, tok, d]

        def half(src, stored):
            return torch.where((src >= 0)[None, :, None],
                               nib[:, src.clamp(min=0)], stored)

        new = half(lo_src, old & 0xF) | (half(hi_src, old >> 4) << 4)
        pages[:, page_ids, prow] = new.to(torch.uint8).view(torch.int8)

    def append(
        self,
        layer: int,
        new_k: torch.Tensor,  # [num_tokens, num_kv_heads, head_dim]
        new_v: torch.Tensor,
        page_ids: torch.Tensor,  # [num_tokens] physical page per token
        offsets: torch.Tensor,  # [num_tokens] row within the page
        slots: Optional[torch.Tensor] = None,  # [num_tokens] batch slot
        positions: Optional[torch.Tensor] = None,  # [num_tokens] position
    ) -> "PagedKVCache":
        """Write new tokens' K/V into their pages (quantizing each side
        per row for its tier), in place. With a ring and (slots,
        positions) given, also write the exact K/V into each slot's ring
        at row position % W."""
        page_ids = page_ids.long()
        offsets = offsets.long()
        num_rows = self.k_pages.shape[2] * self.page_size
        src = _last_writer(page_ids * self.page_size + offsets, num_rows)
        k_dt, v_dt = side_dtypes(self.kv_dtype)
        for side, x, pages, scales in (
                (k_dt, new_k, self.k_pages, self.k_scales),
                (v_dt, new_v, self.v_pages, self.v_scales)):
            q, s = _quantize_rows(x, side)
            if side in PACKED:
                self._write_packed(pages[layer], page_ids, offsets, q)
            else:
                pages[layer][:, page_ids, offsets] = (
                    q[src].to(pages.dtype).transpose(0, 1))
            if side == "int4g32":
                # Group rows are stored transposed: token t scatters its
                # [2 * ng] column at lane offsets[t].
                scales[layer][:, page_ids, :, offsets] = s[src]
            elif s is not None:
                scales[layer][:, page_ids, offsets] = s[src].transpose(0, 1)
        if self.k_recent is not None and slots is not None:
            self.write_recent(layer, new_k, new_v, slots, positions)
        return self

    def write_recent(
        self,
        layer: int,
        new_k: torch.Tensor,  # [num_tokens, num_kv_heads, head_dim]
        new_v: torch.Tensor,
        slots: torch.Tensor,  # [num_tokens] (trash slot for discards)
        positions: torch.Tensor,  # [num_tokens]
    ) -> "PagedKVCache":
        """Ring-only write, in place."""
        if self.k_recent is None:
            return self
        w = self.recent_window
        slots = slots.long()
        rows = positions.long() % w
        src = _last_writer(slots * w + rows, self.k_recent.shape[1] * w)
        kr, vr = self.k_recent[layer], self.v_recent[layer]
        kr[slots, :, rows] = new_k[src].to(kr.dtype)
        vr[slots, :, rows] = new_v[src].to(vr.dtype)
        return self
