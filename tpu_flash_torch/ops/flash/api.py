"""Public flash-attention API (forward only in this slice).

The port of ``tpu_flash/ops/flash/api.py::flash_attention``: the same
arguments and validation, on PyTorch tensors. The CUDA kernel masks its
own ragged edges, so there is no padding layer; ``kv_len`` exposes the
kv-tail mask for callers that hand over padded k/v buckets. Gradients
(``tpu_flash/ops/flash/backward.py``) and segment ids come with the
training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.ops.flash.forward import flash_fwd


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    save_residuals: bool = False,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    segment_ids=None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
):
    """Multi-head / grouped-query flash attention forward.

    Args:
      q: [batch, num_q_heads, q_len, head_dim].
      k, v: [batch, num_kv_heads, kv_len, head_dim]; num_kv_heads divides
        num_q_heads (GQA by index, no repeat).
      causal: query row i sits at position ``i + q_offset`` and attends
        to kv positions ``<= i + q_offset``.
      sm_scale: score scale, default ``1/sqrt(head_dim)``.
      q_offset: position of the first query row (chunked prefill).
      kv_len: attend only the first ``kv_len`` kv rows (a padded tail).
      save_residuals: also return lse [batch, num_q_heads, q_len] f32.
      window: sliding window (causal only): position p attends
        ``[p - window + 1, p]``.
      softcap: scores become ``softcap * tanh(scores / softcap)`` after
        scaling, before masking.
      segment_ids: not supported until the training slice.
      sinks: [num_q_heads] per-head sink logits in the denominator.
      alibi: [num_q_heads] ALiBi slopes (causal only), added after
        softcap: ``slope * (kv_pos - q_pos)``.

    Returns o [batch, num_q_heads, q_len, head_dim] in q.dtype, or
    ``(o, lse)``.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q/k/v must be rank-4 [b, h, s, d]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(
            f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}"
        )
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"num_q_heads ({q.shape[1]}) must be a multiple of num_kv_heads "
            f"({k.shape[1]})"
        )
    if q.shape[-1] != k.shape[-1]:
        raise ValueError(
            f"head_dim mismatch: {q.shape[-1]} vs {k.shape[-1]}"
        )
    if kv_len is not None and not 0 < kv_len <= k.shape[2]:
        raise ValueError(f"kv_len must be in [1, {k.shape[2]}], got {kv_len}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        window = int(window)
        if window >= q.shape[2] + q_offset:
            window = None  # reaches position 0 for every row: plain causal
    if softcap is not None:
        if softcap <= 0:
            raise ValueError(f"softcap must be > 0, got {softcap}")
        softcap = float(softcap)
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids (packed training) come with the training slice: "
            "ROADMAP queue 1, item 10"
        )
    if sinks is not None and tuple(sinks.shape) != (q.shape[1],):
        raise ValueError(
            f"sinks must be [num_q_heads] = ({q.shape[1]},), got "
            f"{tuple(sinks.shape)}"
        )
    if alibi is not None:
        if not causal:
            raise ValueError("alibi requires causal=True")
        if tuple(alibi.shape) != (q.shape[1],):
            raise ValueError(
                f"alibi must be [num_q_heads] = ({q.shape[1]},), got "
                f"{tuple(alibi.shape)}"
            )
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return flash_fwd(
        q, k, v, causal=causal, sm_scale=float(sm_scale),
        q_offset=int(q_offset), kv_len=kv_len, window=window,
        softcap=softcap, sinks=sinks, alibi=alibi, save_lse=save_residuals,
    )
