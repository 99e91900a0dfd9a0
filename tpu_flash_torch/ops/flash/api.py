"""Public flash-attention API, differentiable.

The port of ``tpu_flash/ops/flash/api.py::flash_attention``: the same
arguments and validation, on PyTorch tensors. The CUDA kernels mask
their own ragged edges, so there is no padding layer; ``kv_len`` exposes
the kv-tail mask for callers that hand over padded k/v buckets.

Gradients: :class:`FlashAttentionFn` (a ``torch.autograd.Function``)
stands in for the JAX package's two ``custom_vjp`` cores (``_flash_core``
and ``_flash_core_res``, ``tpu_flash/ops/flash/api.py:113-275``). Its
forward runs ``flash_fwd`` with lse and saves q, k, v, o and lse; its
backward runs ``flash_bwd`` (with the lse cotangent folded into di when
the caller used lse), sums the per-q-head dK/dV over each GQA group, and
gives the sink logits their closed-form gradient (``_sink_grad``).
Segment ids and ALiBi slopes get none. Without autograd (no input
requires grad, or grad mode off) the forward kernel runs alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.ops.flash.backward import flash_bwd, softmax_di
from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_exact


def sink_grad(sinks: torch.Tensor, lse: torch.Tensor,
              di_eff: torch.Tensor) -> torch.Tensor:
    """dL/dsinks[h] = -sum_{b,q} exp(sinks[h] - lse[b,h,q]) di_eff[b,h,q]:
    the sink is a softmax column with no value row, so its gradient is
    p_sink (dlse - di) and needs no kernel pass (``_sink_grad``,
    ``tpu_flash/ops/flash/api.py:103``)."""
    p_sink = torch.exp(sinks.float()[None, :, None] - lse.float())
    return (-(p_sink * di_eff).sum(dim=(0, 2))).to(sinks.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """(o, lse) = attention(q, k, v); differentiable in q, k, v, sinks and
    through lse. ``opts`` holds the forward's non-tensor options."""

    @staticmethod
    def forward(ctx, q, k, v, sinks, alibi, q_seg, kv_seg, opts,
                order_exact=False):
        fwd = flash_fwd_exact if order_exact else flash_fwd
        o, lse = fwd(q, k, v, sinks=sinks, alibi=alibi, q_seg=q_seg,
                     kv_seg=kv_seg, save_lse=True, **opts)
        ctx.save_for_backward(q, k, v, o, lse, sinks, alibi, q_seg, kv_seg)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, sinks, alibi, q_seg, kv_seg = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_bwd(q, k, v, o, do, lse, alibi=alibi,
                               q_seg=q_seg, kv_seg=kv_seg, dlse=dlse,
                               **ctx.opts)
        b, hq, skv, d = dk.shape
        hkv = k.shape[1]
        if hq != hkv:
            # Per-q-head partials, each already rounded to k's dtype,
            # summed over each GQA group (as the JAX backward does).
            dk = dk.reshape(b, hkv, hq // hkv, skv, d).sum(2)
            dv = dv.reshape(b, hkv, hq // hkv, skv, d).sum(2)
        dsinks = None
        if sinks is not None and ctx.needs_input_grad[3]:
            dsinks = sink_grad(sinks, lse, softmax_di(o, do, dlse))
        return dq, dk, dv, dsinks, None, None, None, None, None


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
    order_exact: bool = False,
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
      segment_ids: ``SegmentIds(q=[batch, q_len], kv=[batch, kv_len])``
        int ids (or a 2-tuple) for packed multi-document attention:
        positions with differing ids never attend each other. No
        gradient flows to the ids.
      sinks: [num_q_heads] per-head sink logits in the denominator.
      alibi: [num_q_heads] ALiBi slopes (causal only), added after
        softcap: ``slope * (kv_pos - q_pos)``.
      order_exact: on CUDA, the forward kernel's order-exact entry
        (``flash_fwd_exact``: its sums run in the plain version's order;
        the serving engine's choice) instead of the tensor cores. Not in
        the JAX API.

    Returns o [batch, num_q_heads, q_len, head_dim] in q.dtype, or
    ``(o, lse)``; differentiable in q, k, v, sinks and (with
    ``save_residuals``) through lse.
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
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids  # SegmentIds NamedTuple or 2-tuple
        if tuple(q_seg.shape) != (q.shape[0], q.shape[2]):
            raise ValueError(
                f"q segment ids must be [batch, q_len] = "
                f"{(q.shape[0], q.shape[2])}, got {tuple(q_seg.shape)}"
            )
        if tuple(kv_seg.shape) != (k.shape[0], k.shape[2]):
            raise ValueError(
                f"kv segment ids must be [batch, kv_len] = "
                f"{(k.shape[0], k.shape[2])}, got {tuple(kv_seg.shape)}"
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
    opts = dict(causal=causal, sm_scale=float(sm_scale),
                q_offset=int(q_offset), kv_len=kv_len, window=window,
                softcap=softcap)
    grads = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, sinks))
    if not grads:
        fwd = flash_fwd_exact if order_exact else flash_fwd
        return fwd(q, k, v, sinks=sinks, alibi=alibi, q_seg=q_seg,
                   kv_seg=kv_seg, save_lse=save_residuals, **opts)
    o, lse = FlashAttentionFn.apply(q, k, v, sinks, alibi, q_seg, kv_seg,
                                    opts, order_exact)
    return (o, lse) if save_residuals else o
