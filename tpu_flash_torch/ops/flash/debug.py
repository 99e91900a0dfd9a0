"""Attention-probability debug surface: the port of
``tpu_flash/ops/flash/debug.py``.

The flash kernels never materialise P. :func:`attention_weights` extracts
it from the forward's own state in two passes: the forward runs with
``save_residuals=True`` (its lse, sink-inclusive), then the
``attn_weights`` kernel (``csrc/attn_weights.cu``; :func:`weights_plain`
on CPU tensors) re-walks the scores with the forward's scale, softcap,
ALiBi and masks and writes ``P = exp(s - lse)`` (scores on the tensor
cores: bf16 in one pass, f32 in three TF32 passes; tiles the masks hide
written as zeros). Against the oracle's
weights (``reference_attention(..., return_weights=True)``) a wrong P
points at the score path, a right P with a wrong output at the
accumulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.flash.api import flash_attention
from tpu_flash_torch.ops.flash.forward import KERNEL_DTYPES, rounded_scale

# What csrc/attn_weights.cu instantiates.
KERNEL_HEAD_DIMS = (64, 128, 256)


def weights_plain(q, k, lse, *, causal: bool, sm_scale: float,
                  q_offset: int = 0, kv_len: Optional[int] = None,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the ``attn_weights`` kernel (same
    arguments as :func:`attention_weights_from_lse`): P [b, hq, sq,
    kv_len] f32."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kv_len = k.shape[2] if kv_len is None else kv_len
    dev = q.device
    scale = torch.tensor(rounded_scale(sm_scale, q.dtype), dtype=torch.float32)
    qs = (q.float() * scale).to(q.dtype).float().reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k[:, :, :kv_len].float())
    if softcap is not None:
        s = softcap * torch.tanh(
            s * torch.tensor(1.0 / softcap, dtype=torch.float32))
    qpos = torch.arange(sq, device=dev)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=dev)[None, :]
    if alibi is not None:
        s = s + alibi.float().reshape(1, hkv, g, 1, 1) * (kpos - qpos).float()
    if causal:
        valid = kpos <= qpos
        if window is not None:
            valid = valid & (kpos > qpos - window)
        s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    lse = lse.float().reshape(b, hkv, g, sq, 1)
    w = torch.where(lse == -torch.inf, torch.zeros_like(s),
                    torch.exp(s - lse))
    return w.reshape(b, hq, sq, kv_len)


def attention_weights_from_lse(q, k, lse, *, causal: bool, sm_scale: float,
                               q_offset: int = 0,
                               kv_len: Optional[int] = None,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               alibi: Optional[torch.Tensor] = None):
    """P = exp(s - lse) [b, hq, sq, kv_len] f32 over q [b, hq, sq, d] and
    k [b, hkv, skv, d] with the forward's options. CPU tensors take
    :func:`weights_plain`; CUDA tensors launch the kernel."""
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              kv_len=kv_len, window=window, softcap=softcap, alibi=alibi)
    if q.device.type == "cpu":
        return weights_plain(q, k, lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"attn_weights: unsupported device {q.device}")
    return _attn_weights_cuda(q, k, lse, **kw)


def _attn_weights_cuda(q, k, lse, *, causal, sm_scale, q_offset, kv_len,
                       window, softcap, alibi):
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype:
        raise ValueError(
            f"attn_weights kernel takes f32 or bf16 q/k of one dtype, got "
            f"{q.dtype}/{k.dtype}"
        )
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attn_weights kernel is built for head_dim {KERNEL_HEAD_DIMS}, "
            f"got {d}"
        )
    for t in (k, lse, alibi):
        if t is not None and t.device != q.device:
            raise ValueError("attn_weights: all tensors must share q's device")
    kv_len = skv if kv_len is None else int(kv_len)
    q, k = q.contiguous(), k.contiguous()
    lse = lse.float().contiguous()
    alibi = None if alibi is None else alibi.float().contiguous()
    w = torch.empty((b, hq, sq, kv_len), dtype=torch.float32, device=q.device)
    build.ATTN_WEIGHTS.launch(
        build.ptr(q), build.ptr(k), build.ptr(lse), build.ptr(alibi),
        build.ptr(w), KERNEL_DTYPES[q.dtype], b, hq, hkv, sq, skv, kv_len, d,
        rounded_scale(sm_scale, q.dtype), int(bool(causal)), int(q_offset),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        0.0 if softcap is None else float(1.0 / softcap),
        build.stream_handle(q),
    )
    return w


def attention_weights(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
):
    """(output, P): P [batch, hq, q_len, kv_len] f32 are the forward's
    attention probabilities, normalised by the forward's own lse. Debug
    only: P takes O(q_len * kv_len) memory. With ``sinks`` the rows sum
    to less than 1 (the sink takes the rest), as served. Options and
    validation are :func:`~tpu_flash_torch.ops.flash.api.flash_attention`'s.
    """
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    o, lse = flash_attention(
        q, k, v, causal=causal, sm_scale=scale, q_offset=q_offset,
        kv_len=kv_len, save_residuals=True, window=window, softcap=softcap,
        sinks=sinks, alibi=alibi,
    )
    w = attention_weights_from_lse(
        q, k, lse, causal=causal, sm_scale=float(scale), q_offset=q_offset,
        kv_len=kv_len, window=window,
        softcap=None if softcap is None else float(softcap), alibi=alibi,
    )
    return o, w
