"""Exact-attention oracles in plain PyTorch.

The numerical contract of every attention kernel in this package, and the
port of ``tpu_flash/core/reference.py``: all math in float32 whatever the
input dtype, masking by a large negative additive value that stays
NaN-free (``DEFAULT_MASK_VALUE``). Matmuls run in full float32 (on the
card this relies on TF32 being off for matmuls, PyTorch's default).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

# -0.7 * float32 max: large enough to zero out after exp, small enough that
# (mask + mask) does not overflow to -inf and produce NaN in exp(x - m).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


class SegmentIds(NamedTuple):
    """Per-token segment ids for packed attention: ``q`` [batch, q_len],
    ``kv`` [batch, kv_len]; attention is masked where they differ."""

    q: torch.Tensor
    kv: torch.Tensor


def _softmax_with_sinks(scores, sinks, head_axis_shape):
    if sinks is None:
        return torch.softmax(scores, dim=-1)
    sink_col = sinks.float().reshape(head_axis_shape).expand(
        *scores.shape[:-1], 1
    )
    full = torch.cat([scores, sink_col], dim=-1)
    return torch.softmax(full, dim=-1)[..., :-1]


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    return_weights: bool = False,
):
    """Exact multi-head attention: softmax(scale * Q K^T + mask) V.

    q/k/v are [batch, heads, len, head_dim]; the options are those of
    ``tpu_flash.core.reference.reference_attention`` (causal with
    ``q_offset``, ``window`` counting attended positions including self,
    ``softcap`` before masking, per-head ``sinks`` in the denominator,
    per-head ``alibi`` slopes on absolute positions, ``q_segment_ids``
    [batch, q_len] / ``kv_segment_ids`` [batch, kv_len] masking every
    score whose ids differ). Returns the output in q.dtype, or
    ``(output, weights)``.
    """
    orig_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    dev = q.device
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if bias is not None:
        scores = scores + bias.float()
    q_pos = torch.arange(q.shape[2], device=dev)[:, None] + q_offset
    kv_pos = torch.arange(k.shape[2], device=dev)[None, :]
    if alibi is not None:
        scores = scores + alibi.float()[None, :, None, None] * (
            (kv_pos - q_pos).float()[None, None]
        )
    mask = None
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if causal:
        mask = kv_pos <= q_pos
        if window is not None:
            mask = mask & (kv_pos > q_pos - window)
        mask = mask[None, None]
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])[
            :, None
        ]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        scores = torch.where(
            mask, scores, torch.full_like(scores, DEFAULT_MASK_VALUE)
        )
    weights = _softmax_with_sinks(scores, sinks, (1, -1, 1, 1))
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
    if return_weights:
        return out.to(orig_dtype), weights
    return out.to(orig_dtype)


def reference_gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact grouped-query attention: k/v [batch, hkv, kv_len, d] with hkv
    dividing q's head count; segment ids as in :func:`reference_attention`.
    Plain differentiable torch: its autograd gradient is the port's own
    gradient oracle."""
    num_q_heads, num_kv_heads = q.shape[1], k.shape[1]
    if num_q_heads % num_kv_heads != 0:
        raise ValueError(f"{num_q_heads=} not a multiple of {num_kv_heads=}")
    rep = num_q_heads // num_kv_heads
    return reference_attention(
        q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1),
        causal=causal, sm_scale=sm_scale, q_offset=q_offset, window=window,
        softcap=softcap, sinks=sinks, alibi=alibi,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
    )


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Standard ALiBi per-head slopes (positive, descending): the geometric
    sequence ``2^(-8(h+1)/n)`` for power-of-two head counts, else the
    next power's odd entries interleaved (the published recipe)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(num_heads).is_integer():
        vals = pow2_slopes(num_heads)
    else:
        m = 2 ** int(math.floor(math.log2(num_heads)))
        vals = pow2_slopes(m) + pow2_slopes(2 * m)[0::2][: num_heads - m]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def reference_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact single-token GQA decode against a ragged dense cache.

    q [batch, hq, d]; k_cache/v_cache [batch, hkv, max_len, d]; lengths
    [batch]. The token at position lengths-1 attends to cache positions
    < lengths (and > lengths - 1 - window with a sliding window)."""
    max_len = k_cache.shape[2]
    rep = q.shape[1] // k_cache.shape[1]
    k = k_cache.repeat_interleave(rep, dim=1).float()
    v = v_cache.repeat_interleave(rep, dim=1).float()
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(max_len, device=q.device)[None, None, :]
    ln = lengths.to(q.device)[:, None, None]
    valid = pos < ln
    if window is not None:
        valid = valid & (pos > ln - 1 - window)
    if alibi is not None:
        scores = scores + alibi.float()[None, :, None] * (
            (pos - (ln - 1)).float()
        )
    scores = torch.where(
        valid, scores, torch.full_like(scores, DEFAULT_MASK_VALUE)
    )
    weights = _softmax_with_sinks(scores, sinks, (1, -1, 1))
    out = torch.einsum("bhk,bhkd->bhd", weights, v)
    return out.to(q.dtype)


def gather_pages_to_dense(
    pages: torch.Tensor,  # [num_kv_heads, num_pages, page_size, head_dim]
    page_indices: torch.Tensor,  # [batch, pages_per_seq]
) -> torch.Tensor:
    """A paged cache as dense [batch, hkv, pages_per_seq * page_size, d]:
    the oracle-side inverse of the page table."""
    gathered = pages[:, page_indices.long()]  # [hkv, b, pps, ps, d]
    hkv, batch, pps, ps, d = gathered.shape
    return gathered.permute(1, 0, 2, 3, 4).reshape(batch, hkv, pps * ps, d)
