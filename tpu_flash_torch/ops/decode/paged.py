"""Paged GQA decode attention: the ``paged_decode`` CUDA kernel and its
plain PyTorch version.

The port of ``tpu_flash/ops/decode/paged.py::paged_attention`` for bf16,
f32 and int8 pages. Both versions here reproduce the TPU kernel's
arithmetic (``_paged_attn_kernel``): kv blocks of ``bk`` tokens walked in
order with online softmax; per-token int8 scales folded rank-1 into the
scores and into P; with ``int8_mxu`` the scaled q rows and each block's
P rows quantized to int8 (P over the whole ``bk`` extent, as the TPU
kernel does, so both versions pick the same ``bk``); bf16 pages take
bf16 q and P; an exact recent ring as a final block of the same softmax
state. Integer dots run in float64 in the plain version, exact like the
kernel's int32 sums.

:func:`paged_attention` takes the plain version for CPU tensors only; a
CUDA tensor launches the kernel (``csrc/paged_decode.cu``) or raises.
The int4, int4g32, k8v4 and fp8 tiers are ROADMAP queue 2 (K4 tiers).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.core.config import TileSizes
from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.quant.quantize import QuantizedTensor

# Page tiers, numbered as csrc/paged_decode.cu takes them.
TIER_F32, TIER_BF16, TIER_INT8, TIER_INT8_MXU = 0, 1, 2, 3
KERNEL_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 128
KERNEL_MAX_Q_PER_KV = 8


def pages_per_block(page_size: int, pages_per_seq: int, small_payload: bool,
                    tiles: TileSizes = TileSizes()) -> int:
    """Pages per kv block: the JAX kernel's default (~4096 tokens for
    bf16/int8 pages, ~2048 for f32), reduced until it divides
    pages_per_seq."""
    target = (
        tiles.decode_block_tokens if small_payload
        else tiles.decode_block_tokens_f32
    )
    ppb = max(1, min(target // page_size, pages_per_seq))
    while pages_per_seq % ppb:
        ppb -= 1
    return ppb


def _blocks(pages: torch.Tensor, pidx: torch.Tensor) -> torch.Tensor:
    """[hkv, P, ps, ...] pages of a block's page ids [b, ppb] as
    [b, hkv, ppb * ps, ...]."""
    x = pages[:, pidx.long()]  # [hkv, b, ppb, ps, ...]
    x = x.transpose(0, 1)
    return x.reshape(x.shape[0], x.shape[1], -1, *x.shape[4:])


def paged_decode_plain(
    q: torch.Tensor,
    k_vals: torch.Tensor,
    v_vals: torch.Tensor,
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    tier: int,
    sm_scale: float,
    pages_per_compute_block: int,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    recent_k: Optional[torch.Tensor] = None,
    recent_v: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Plain PyTorch version of the ``paged_decode`` kernel: q [b, hq, d];
    pages [hkv, P, ps, d]; scales [hkv, P, ps] (int8 tiers) or None."""
    b, hq, d = q.shape
    hkv, _, ps, _ = k_vals.shape
    g = hq // hkv
    pps = page_indices.shape[1]
    ppb = pages_per_compute_block
    bk = ppb * ps
    dev = q.device
    w_ring = 0 if recent_k is None else recent_k.shape[2]
    f32 = torch.float32
    qs = q.float().reshape(b, hkv, g, d) * torch.tensor(sm_scale, dtype=f32)
    L = lengths.to(dev).long()
    # With a ring the pages own [0, max(L - W, 0)); the walk keeps at
    # least one (then fully masked) block, as the TPU kernel does.
    eff = (L - w_ring).clamp(min=1) if w_ring else L
    page_limit = (L - w_ring).clamp(min=0) if w_ring else L
    num_active = (eff + bk - 1) // bk
    first = (
        torch.div(eff - window, bk, rounding_mode="floor").clamp(min=0)
        if window is not None else torch.zeros_like(eff)
    )
    if tier == TIER_INT8_MXU:
        q_abs = qs.abs().amax(dim=-1, keepdim=True)
        q_scale = torch.where(q_abs == 0.0, torch.ones_like(q_abs),
                              q_abs / 127.0)
        q_op = torch.clamp(torch.round(qs / q_scale), -127, 127)
    elif tier == TIER_BF16:
        q_op = qs.to(torch.bfloat16).float()
    else:
        q_op = qs
    slopes = None if alibi is None else alibi.float().reshape(1, hkv, g, 1)
    inv_cap = None if softcap is None else torch.tensor(
        1.0 / softcap, dtype=f32
    )

    def capped(s):
        return s if softcap is None else softcap * torch.tanh(s * inv_cap)

    m = torch.full((b, hkv, g, 1), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, g, 1), device=dev)
    acc = torch.zeros((b, hkv, g, d), device=dev)

    def update(s, pv_fn, active):
        nonlocal m, l, acc
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l_next = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_next = acc * alpha + pv_fn(p)
        sel = active.reshape(b, 1, 1, 1)
        m = torch.where(sel, m_next, m)
        l = torch.where(sel, l_next, l)
        acc = torch.where(sel, acc_next, acc)

    for i in range(pps // ppb):
        active = (i >= first) & (i < num_active)
        if not bool(active.any()):
            continue
        pidx = page_indices[:, i * ppb:(i + 1) * ppb].to(dev)
        kb = _blocks(k_vals, pidx)  # [b, hkv, bk, d]
        vb = _blocks(v_vals, pidx)
        if tier == TIER_INT8_MXU:
            s = torch.einsum(
                "bhgd,bhkd->bhgk", q_op.double(), kb.double()
            ).float() * q_scale
        else:
            s = torch.einsum("bhgd,bhkd->bhgk", q_op, kb.float())
        vsc = None
        if tier in (TIER_INT8, TIER_INT8_MXU):
            s = s * _blocks(k_scales, pidx)[:, :, None, :]
            vsc = _blocks(v_scales, pidx)[:, :, None, :]
        s = capped(s)
        pos = i * bk + torch.arange(bk, device=dev)[None, :]  # [1, bk]
        valid = pos < page_limit[:, None]
        if window is not None:
            valid = valid & (pos >= (eff - window)[:, None])
        if slopes is not None:
            s = s + slopes * (pos - (eff[:, None] - 1)).float()[:, None, None]
        s = torch.where(valid[:, None, None], s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))

        def pv_fn(p, vb=vb, vsc=vsc):
            if tier == TIER_INT8_MXU:
                pv = p * vsc
                p_abs = pv.amax(dim=-1, keepdim=True)
                p_scale = torch.where(p_abs == 0.0, torch.ones_like(p_abs),
                                      p_abs / 127.0)
                p8 = torch.clamp(torch.round(pv / p_scale), 0, 127)
                return torch.einsum(
                    "bhgk,bhkd->bhgd", p8.double(), vb.double()
                ).float() * p_scale
            if tier == TIER_INT8:
                p = p * vsc
            elif tier == TIER_BF16:
                p = p.to(torch.bfloat16).float()
            return torch.einsum("bhgk,bhkd->bhgd", p, vb.float())

        update(s, pv_fn, active)

    if w_ring:
        q_r = qs.to(torch.bfloat16).float()
        s = capped(torch.einsum("bhgd,bhwd->bhgw", q_r, recent_k.float()))
        last = (L - 1)[:, None]
        j = torch.arange(w_ring, device=dev)[None, :]
        p_j = last - torch.fmod(last - j, w_ring)  # lax.rem semantics
        valid = (p_j >= page_limit[:, None]) & (p_j <= last)
        if slopes is not None:
            s = s + slopes * (p_j - last).float()[:, None, None]
        s = torch.where(valid[:, None, None], s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
        update(
            s,
            lambda p: torch.einsum(
                "bhgw,bhwd->bhgd", p.to(torch.bfloat16).float(),
                recent_v.float(),
            ),
            torch.ones((b,), dtype=torch.bool, device=dev),
        )

    if sinks is None:
        o = acc * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    else:
        sk = sinks.float().reshape(1, hkv, g, 1)
        m2 = torch.maximum(m, sk)
        scale_m = torch.exp(m - m2)
        o = acc * (scale_m / (l * scale_m + torch.exp(sk - m2)))
    o = o.to(q.dtype).reshape(b, hq, d)
    if return_state:
        return o, m.reshape(b, hq), l.reshape(b, hq)
    return o


def paged_attention(
    q: torch.Tensor,
    k_pages,
    v_pages,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    pages_per_compute_block: Optional[int] = None,
    int8_mxu: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    return_state: bool = False,
    recent_k: Optional[torch.Tensor] = None,
    recent_v: Optional[torch.Tensor] = None,
):
    """Single-token GQA decode attention over a paged KV cache.

    Args:
      q: [batch, num_q_heads, head_dim] current-token queries.
      k_pages / v_pages: dense [num_kv_heads, num_pages, page_size, d]
        (bf16 or f32), or int8 ``QuantizedTensor`` with per-token scales
        [num_kv_heads, num_pages, page_size, 1].
      lengths: [batch] int32 context lengths (>= 1).
      page_indices: [batch, pages_per_seq] int32 page table.
      int8_mxu: int8 pages only -- quantize q and P rows to int8 and take
        integer dots (the JAX default); False is the exact dequant path.
      pages_per_compute_block: pages per kv block (default as JAX).
      window / softcap / sinks / alibi: as ``flash_attention``; the
        decoding token sits at position lengths - 1.
      recent_k / recent_v: [batch, num_kv_heads, W, d] exact bf16 ring:
        pages cover [0, max(L - W, 1)), the ring the rest. Incompatible
        with window and return_state.
      return_state: also return (m, l) [batch, num_q_heads] f32 for an
        external merge; requires sinks=None.

    Returns [batch, num_q_heads, head_dim] in q.dtype, or (o, m, l).
    """
    if recent_k is not None:
        if window is not None:
            raise ValueError("recent_k is incompatible with window")
        if return_state:
            raise ValueError("recent_k is incompatible with return_state")
        if recent_v is None or recent_k.shape != recent_v.shape:
            raise ValueError("recent rings must both be given, same shape")
    if return_state and sinks is not None:
        raise ValueError(
            "return_state=True requires sinks=None (fold the sink at the "
            "external merge)"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if isinstance(k_pages, QuantizedTensor) != isinstance(
        v_pages, QuantizedTensor
    ):
        raise ValueError("K and V pages must both be quantized or both dense")
    k_scales = v_scales = None
    if isinstance(k_pages, QuantizedTensor):
        for qt in (k_pages, v_pages):
            if qt.dtype_name != "int8":
                raise NotImplementedError(
                    f"{qt.dtype_name} pages are not ported yet (ROADMAP "
                    "queue 2, K4 tiers)"
                )
        tier = TIER_INT8_MXU if int8_mxu else TIER_INT8
        k_vals, v_vals = k_pages.values, v_pages.values
        k_scales = k_pages.scales.squeeze(-1)
        v_scales = v_pages.scales.squeeze(-1)
    else:
        k_vals, v_vals = k_pages, v_pages
        if k_vals.dtype == torch.bfloat16:
            tier = TIER_BF16
        elif k_vals.dtype == torch.float32:
            tier = TIER_F32
        else:
            raise ValueError(f"unsupported page dtype {k_vals.dtype}")
        if v_vals.dtype != k_vals.dtype:
            raise ValueError("K and V pages must share a dtype")
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads, _, page_size, _ = k_vals.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be a multiple of "
            f"num_kv_heads ({num_kv_heads})"
        )
    pps = page_indices.shape[1]
    if pages_per_compute_block is None:
        ppb = pages_per_block(page_size, pps, tier != TIER_F32)
    else:
        ppb = min(pages_per_compute_block, pps)
    if pps % ppb:
        raise ValueError(
            f"pages_per_seq ({pps}) must be a multiple of "
            f"pages_per_compute_block ({ppb})"
        )
    scale = float(sm_scale if sm_scale is not None else head_dim ** -0.5)
    args = dict(
        tier=tier, sm_scale=scale, pages_per_compute_block=ppb,
        window=None if window is None else int(window),
        softcap=None if softcap is None else float(softcap),
        sinks=sinks, alibi=alibi, recent_k=recent_k, recent_v=recent_v,
        return_state=return_state,
    )
    if q.device.type == "cpu":
        return paged_decode_plain(
            q, k_vals, v_vals, k_scales, v_scales, lengths, page_indices,
            **args,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _paged_decode_cuda(
        q, k_vals, v_vals, k_scales, v_scales, lengths, page_indices, **args
    )


def _paged_decode_cuda(q, k_vals, v_vals, k_scales, v_scales, lengths,
                       page_indices, *, tier, sm_scale,
                       pages_per_compute_block, window, softcap, sinks,
                       alibi, recent_k, recent_v, return_state):
    b, hq, d = q.shape
    hkv, num_pages, ps, _ = k_vals.shape
    if q.dtype not in KERNEL_Q_DTYPES:
        raise ValueError(f"paged_decode kernel takes f32/bf16 q, got {q.dtype}")
    if d != KERNEL_HEAD_DIM or hq // hkv > KERNEL_MAX_Q_PER_KV:
        raise ValueError(
            f"paged_decode kernel is built for head_dim {KERNEL_HEAD_DIM} "
            f"and <= {KERNEL_MAX_Q_PER_KV} q heads per kv head; got "
            f"head_dim {d}, {hq // hkv}"
        )
    tensors = [k_vals, v_vals, k_scales, v_scales, lengths, page_indices,
               recent_k, recent_v, sinks, alibi]
    for t in tensors:
        if t is not None and t.device != q.device:
            raise ValueError(
                "paged_attention: all tensors must share q's device"
            )
    if recent_k is not None and recent_k.dtype != torch.bfloat16:
        raise ValueError("the recent ring must be bf16")
    q = q.contiguous()
    k_vals, v_vals = k_vals.contiguous(), v_vals.contiguous()
    if k_scales is not None:
        k_scales = k_scales.float().contiguous()
        v_scales = v_scales.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32).contiguous()
    if recent_k is not None:
        recent_k, recent_v = recent_k.contiguous(), recent_v.contiguous()
    sinks = None if sinks is None else sinks.float().contiguous()
    alibi = None if alibi is None else alibi.float().contiguous()
    o = torch.empty_like(q)
    m_out = l_out = None
    if return_state:
        m_out = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        l_out = torch.empty_like(m_out)
    build.PAGED_DECODE.launch(
        build.ptr(q), build.ptr(k_vals), build.ptr(v_vals),
        build.ptr(k_scales), build.ptr(v_scales), build.ptr(lengths),
        build.ptr(page_indices), build.ptr(recent_k), build.ptr(recent_v),
        build.ptr(sinks), build.ptr(alibi), build.ptr(o), build.ptr(m_out),
        build.ptr(l_out),
        KERNEL_Q_DTYPES[q.dtype], tier, b, hq, hkv, num_pages, ps,
        page_indices.shape[1], pages_per_compute_block * ps,
        0 if recent_k is None else recent_k.shape[2], d,
        sm_scale, 0 if window is None else window,
        0.0 if softcap is None else softcap,
        0.0 if softcap is None else float(1.0 / softcap),
        build.stream_handle(q),
    )
    if return_state:
        return o, m_out, l_out
    return o
