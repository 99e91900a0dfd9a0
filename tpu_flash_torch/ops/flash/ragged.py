"""Ragged (mixed-stage) prefill attention: the ``ragged_prefill`` CUDA
kernel (K6) and its plain PyTorch version.

The port of ``tpu_flash/ops/flash/ragged.py``. Row ``b`` of a batch holds
a chunk of queries at positions ``[q_offsets[b], q_offsets[b] + q_len)``
of its own sequence, and its K/V buffer is

    [ history (valid cols 0..q_offsets[b]) | chunk keys ]
      ^-- padded to hist_cap ----------^   ^- at hist_cap

Query row ``i`` attends history columns ``j < q_offsets[b]`` and chunk
columns ``j - hist_cap <= i``; history columns in ``[q_offsets[b],
hist_cap)`` may hold garbage and never reach a sum. Both versions here
walk the buffer in kv tiles of ``block_kv`` columns from column 0
(``TileSizes.ragged_block_kv``; the JAX kernel takes its tile from a TPU
tuning table) with the TPU kernel's roundings, so they agree with each
other to summation order, and with the JAX kernel wherever it uses the
same tile.

:func:`flash_attention_ragged` takes the plain version for CPU tensors
only; a CUDA tensor launches the kernel (``csrc/ragged_prefill.cu``) or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.flash.forward import rounded_scale
from tpu_flash_torch.ops.flash.paged_prefill import (
    KERNEL_DTYPES,
    KERNEL_HEAD_DIM,
    KERNEL_MAX_Q_PER_KV,
    TILES,
    BlockSoftmax,
    scaled_queries,
)


def ragged_prefill_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offsets: torch.Tensor,
    *,
    hist_cap: int,
    sm_scale: float,
    block_kv: int,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the ``ragged_prefill`` kernel (arguments
    as :func:`flash_attention_ragged`), stepping its kv tiles. A tile no
    row of the batch can see is skipped; a tile some rows cannot see is
    wholly masked for them, which leaves their result bit-equal."""
    b, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    state = BlockSoftmax(scaled_queries(q, hkv, sm_scale), softcap)
    offs = q_offsets.to(dev).long()[:, None, None]  # [b, 1, 1]
    i_pos = torch.arange(q_len, device=dev)[None, :, None]  # [1, q, 1]
    slopes = None if alibi is None else alibi.float().reshape(1, hkv, g, 1, 1)
    last = min(kv_len, hist_cap + q_len)
    for t0 in range(0, last, block_kv):
        t1 = min(t0 + block_kv, kv_len)
        if t1 <= hist_cap and not bool((offs > t0).any()):
            continue  # history no row reaches
        j = torch.arange(t0, t1, device=dev)[None, None, :]  # [1, 1, w]
        hist = j < hist_cap
        c = j - hist_cap
        real = torch.where(hist, j < offs, c < q_len)[:, 0]  # [b, w]
        zero = ~real[:, None, :, None]
        kt = k[:, :, t0:t1].float().masked_fill(zero, 0.0)
        vt = v[:, :, t0:t1].float().masked_fill(zero, 0.0)
        s = state.scores(kt)
        vis_hist = hist & (j < offs)
        vis_chunk = ~hist & (c <= i_pos)
        if window is not None:
            vis_hist = vis_hist & (j > offs + i_pos - window)
            vis_chunk = vis_chunk & (c > i_pos - window)
        if slopes is not None:
            dist = torch.where(hist, j - offs - i_pos, c - i_pos)
            s = s + slopes * dist.float()[:, None, None]
        s = torch.where((vis_hist | vis_chunk)[:, None, None], s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
        state.step(s, vt, v.dtype)
    return state.finish(sinks, q.dtype)


def flash_attention_ragged(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offsets: torch.Tensor,
    *,
    hist_cap: int,
    sm_scale: Optional[float] = None,
    block_kv: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mixed-stage chunk attention over [history | chunk] K/V buffers.

    Args:
      q: [B, hq, q_len, d] chunk queries.
      k, v: [B, hkv, hist_cap + q_len, d] in the layout above.
      q_offsets: [B] per-row history length (<= hist_cap).
      block_kv: the kv tile (default ``TileSizes().ragged_block_kv``; the
        JAX function's ``block_sizes.block_kv_major``).
      window / softcap / sinks / alibi: as ``flash_attention``; query i of
        row b sits at position q_offsets[b] + i.

    Returns [B, hq, q_len, d] in q's dtype: per row b, causal attention
    of the chunk at q_offset q_offsets[b] over its first q_offsets[b]
    history tokens plus the chunk itself.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    if kv_len != hist_cap + q_len:
        raise ValueError(
            f"kv length {kv_len} != hist_cap {hist_cap} + q_len {q_len}"
        )
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be a multiple of "
            f"num_kv_heads ({num_kv_heads})"
        )
    args = dict(
        hist_cap=int(hist_cap),
        sm_scale=float(sm_scale if sm_scale is not None
                       else head_dim ** -0.5),
        block_kv=int(block_kv or TILES.ragged_block_kv),
        window=None if window is None else int(window),
        softcap=None if softcap is None else float(softcap),
        sinks=sinks, alibi=alibi,
    )
    if q.device.type == "cpu":
        return ragged_prefill_plain(q, k, v, q_offsets, **args)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_ragged: unsupported device "
                         f"{q.device}")
    return _ragged_prefill_cuda(q, k, v, q_offsets, **args)


def _ragged_prefill_cuda(q, k, v, q_offsets, *, hist_cap, sm_scale,
                         block_kv, window, softcap, sinks, alibi):
    b, hq, q_len, d = q.shape
    hkv = k.shape[1]
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(
            f"ragged_prefill kernel takes f32 or bf16 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d != KERNEL_HEAD_DIM or hq // hkv > KERNEL_MAX_Q_PER_KV:
        raise ValueError(
            f"ragged_prefill kernel is built for head_dim {KERNEL_HEAD_DIM} "
            f"and <= {KERNEL_MAX_Q_PER_KV} q heads per kv head; got "
            f"head_dim {d}, {hq // hkv}"
        )
    for t in (k, v, q_offsets, sinks, alibi):
        if t is not None and t.device != q.device:
            raise ValueError(
                "flash_attention_ragged: all tensors must share q's device"
            )
    q, k, v = q.contiguous(), build.aligned(k), build.aligned(v)
    q_offsets = q_offsets.to(torch.int32).contiguous()
    sinks = None if sinks is None else sinks.float().contiguous()
    alibi = None if alibi is None else alibi.float().contiguous()
    o = torch.empty_like(q)
    build.RAGGED_PREFILL.launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(q_offsets),
        build.ptr(sinks), build.ptr(alibi), build.ptr(o),
        KERNEL_DTYPES[q.dtype], b, hq, hkv, q_len, hist_cap, block_kv, d,
        rounded_scale(sm_scale, q.dtype),
        0 if window is None else window,
        0.0 if softcap is None else softcap,
        0.0 if softcap is None else float(1.0 / softcap),
        build.stream_handle(q),
    )
    return o
