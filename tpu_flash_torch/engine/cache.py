"""Paged KV cache: device-side page tensors and the append path.

The port of ``tpu_flash/engine/cache.py`` for the bf16, f32 and int8
tiers. Layout per layer (matching ``ops/decode/paged.py``):
  k_pages, v_pages: [num_layers, num_kv_heads, num_pages, page_size, d]
  k_scales, v_scales (int8): [num_layers, num_kv_heads, num_pages,
                              page_size] f32
  k_recent, v_recent (quantized, recent_window > 0): a bf16 ring
      [num_layers, num_slots, num_kv_heads, W, d]; position p of a slot
      lives at ring row p % W.

Unlike the JAX cache, whose appends are pure functions, this cache owns
its buffers and writes them in place (``index_put_``): ``append``
mutates and returns ``self``. Where one append carries several tokens for
the same page row or ring row (prefill padding, which goes to the trash
page and trash slot; a prefill chunk longer than the ring), every writer
of a row writes the LAST writer's bytes, so the result is the JAX
last-writer-wins result on any device, whatever order the scatter runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_flash_torch.core.config import CacheConfig
from tpu_flash_torch.ops.quant.quantize import (
    QuantizedTensor,
    quantize_int8_rows,
)

_PORTED_TIERS = ("bfloat16", "float32", "int8")


def side_dtypes(kv_dtype: str):
    """(k_dtype, v_dtype) of a cache tier ("k8v4" mixes int8 K with int4
    V; every tier of this port uses one dtype for both sides)."""
    if kv_dtype == "k8v4":
        return "int8", "int4"
    return kv_dtype, kv_dtype


def _quantize_rows(x: torch.Tensor, kv_dtype: str):
    """Per-row symmetric quantization of new tokens (payload, scales
    [..]); identity (x, None) for the float tiers."""
    if kv_dtype == "int8":
        q, scale = quantize_int8_rows(x)
        return q, scale[..., 0]
    if kv_dtype in ("bfloat16", "float32"):
        return x, None
    raise NotImplementedError(
        f"kv_dtype {kv_dtype!r} is not ported yet (ROADMAP queue 1, item 9)"
    )


def _last_writer(keys: torch.Tensor, num_keys: int) -> torch.Tensor:
    """For each token, the index of the last token with the same key."""
    idx = torch.arange(keys.numel(), device=keys.device)
    last = torch.full((num_keys,), -1, dtype=idx.dtype, device=keys.device)
    last.scatter_reduce_(0, keys, idx, reduce="amax")
    return last[keys]


@dataclasses.dataclass
class PagedKVCache:
    """Device tensors of one model's KV pages across layers."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]
    v_scales: Optional[torch.Tensor]
    page_size: int
    kv_dtype: str
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
        if config.kv_dtype not in _PORTED_TIERS:
            raise NotImplementedError(
                f"kv_dtype {config.kv_dtype!r} is not ported yet (ROADMAP "
                "queue 1, item 9)"
            )
        device = device if device is not None else "cuda"
        quant = config.quantized
        payload = torch.int8 if quant else getattr(torch, config.kv_dtype)
        shape = (num_layers, num_kv_heads, config.num_pages,
                 config.page_size, head_dim)
        scale_shape = shape[:-1]

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=device)

        k_recent = v_recent = None
        if quant and config.recent_window and num_slots:
            ring = (num_layers, num_slots, num_kv_heads,
                    config.recent_window, head_dim)
            k_recent = zeros(ring, torch.bfloat16)
            v_recent = zeros(ring, torch.bfloat16)
        return cls(
            k_pages=zeros(shape, payload),
            v_pages=zeros(shape, payload),
            k_scales=(torch.ones(scale_shape, dtype=torch.float32,
                                 device=device) if quant else None),
            v_scales=(torch.ones(scale_shape, dtype=torch.float32,
                                 device=device) if quant else None),
            page_size=config.page_size,
            kv_dtype=config.kv_dtype,
            k_recent=k_recent,
            v_recent=v_recent,
        )

    @property
    def quantized(self) -> bool:
        return self.kv_dtype in ("int8", "int4", "int4g32", "k8v4", "fp8")

    @property
    def recent_window(self) -> int:
        return 0 if self.k_recent is None else self.k_recent.shape[3]

    def layer_view(self, layer: int):
        """(k, v) for ``paged_attention``: QuantizedTensor when quantized
        (scales as [hkv, pages, ps, 1])."""
        if not self.quantized:
            return self.k_pages[layer], self.v_pages[layer]
        k = QuantizedTensor(self.k_pages[layer],
                            self.k_scales[layer][..., None], self.kv_dtype)
        v = QuantizedTensor(self.v_pages[layer],
                            self.v_scales[layer][..., None], self.kv_dtype)
        return k, v

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
        """Write new tokens' K/V into their pages (quantizing int8 tiers
        per row), in place. With a ring and (slots, positions) given, also
        write the exact K/V into each slot's ring at row position % W."""
        page_ids = page_ids.long()
        offsets = offsets.long()
        num_rows = self.k_pages.shape[2] * self.page_size
        src = _last_writer(page_ids * self.page_size + offsets, num_rows)
        kq, ks = _quantize_rows(new_k[src], self.kv_dtype)
        vq, vs = _quantize_rows(new_v[src], self.kv_dtype)
        kp, vp = self.k_pages[layer], self.v_pages[layer]
        kp[:, page_ids, offsets] = kq.to(kp.dtype).transpose(0, 1)
        vp[:, page_ids, offsets] = vq.to(vp.dtype).transpose(0, 1)
        if self.quantized:
            self.k_scales[layer][:, page_ids, offsets] = ks.transpose(0, 1)
            self.v_scales[layer][:, page_ids, offsets] = vs.transpose(0, 1)
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
