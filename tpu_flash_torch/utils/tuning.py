"""The paged KV cache's auto layout: page size, capacity, recent ring.

The port of ``select_cache_policy`` and ``resolve_cache_config`` from
``tpu_flash/utils/tuning.py``. The rules are the JAX package's policy,
kept as they are so that both engines resolve the same layout from the
same ``CacheConfig``; they were chosen on a TPU and are not yet measured
on the GPU (ROADMAP queue 1, items 16 and 17). The rules:

  * page_size: 512 tokens for quantized tiers, 1024 for bf16/f32, never
    more than the context rounded down to a power of two (at least 128);
  * max_pages_per_seq: the context in pages, rounded up;
  * num_pages: reserve admission (batch x pages a sequence) + 25% for
    prefix-cache reuse + the trash page;
  * recent_window: a 128-token exact ring for int4, int4g32, k8v4 and
    fp8 (clamped to the context), 128 for int8 from a 2048-token context
    up, none otherwise.
"""

from __future__ import annotations

import dataclasses

from tpu_flash_torch.core.config import CacheConfig

_QUANTIZED = ("int8", "int4", "int4g32", "k8v4", "fp8")
_RING_TIERS = ("int4", "int4g32", "k8v4", "fp8")


def _pow2_at_most(x: int, lo: int = 128) -> int:
    p = lo
    while p * 2 <= x:
        p *= 2
    return p


def _num_pages(max_batch_size: int, max_pages_per_seq: int) -> int:
    reserve = max_batch_size * max_pages_per_seq
    return reserve + max(1, reserve // 4) + 1


def select_cache_policy(kv_dtype: str, max_seq_len: int,
                        max_batch_size: int) -> dict:
    """The auto layout of a cache tier at a serving regime: {"page_size",
    "num_pages", "max_pages_per_seq", "recent_window"}, every value
    concrete."""
    cap = 512 if kv_dtype in _QUANTIZED else 1024
    page_size = min(cap, _pow2_at_most(max(max_seq_len, 128)))
    max_pages_per_seq = -(-max_seq_len // page_size)
    if kv_dtype in _RING_TIERS:
        recent_window = min(128, _pow2_at_most(max(max_seq_len, 128)))
    elif kv_dtype == "int8" and max_seq_len >= 2048:
        recent_window = 128
    else:
        recent_window = 0
    return {
        "page_size": page_size,
        "num_pages": _num_pages(max_batch_size, max_pages_per_seq),
        "max_pages_per_seq": max_pages_per_seq,
        "recent_window": recent_window,
    }


def resolve_cache_config(cache: CacheConfig, *, max_seq_len: int,
                         max_batch_size: int) -> CacheConfig:
    """``cache`` with its auto (None) fields filled from the policy.
    Explicit fields win; the auto pages-per-sequence and capacity follow
    an explicit page size. A resolved config comes back as it is."""
    if cache.resolved:
        return cache
    policy = select_cache_policy(cache.kv_dtype, max_seq_len,
                                 max_batch_size)
    page_size = cache.page_size
    if page_size is None:
        page_size = policy["page_size"]
        if cache.kv_dtype in ("int4", "int4g32", "k8v4") and page_size % 2:
            page_size += 1  # token-packed nibbles need even pages
    max_pages_per_seq = cache.max_pages_per_seq
    if max_pages_per_seq is None:
        max_pages_per_seq = -(-max_seq_len // page_size)
    num_pages = cache.num_pages
    if num_pages is None:
        num_pages = _num_pages(max_batch_size, max_pages_per_seq)
    recent_window = cache.recent_window
    if recent_window is None:
        recent_window = min(policy["recent_window"], max_seq_len)
    return dataclasses.replace(
        cache, page_size=page_size, num_pages=num_pages,
        max_pages_per_seq=max_pages_per_seq, recent_window=recent_window,
    )
