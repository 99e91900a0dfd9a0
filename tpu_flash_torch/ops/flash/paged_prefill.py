"""Prefill attention over the paged KV cache: the ``paged_prefill`` CUDA
kernel (K5) and its plain PyTorch version.

The port of ``tpu_flash/ops/flash/paged_prefill.py``. A chunk's queries
attend [its sequence's cached history | the chunk itself]: history is read
from the pages through the row's page table, only up to ``q_offsets[b]``
tokens (per row, so one call serves same-stage and mixed-stage batches),
and the chunk's own K/V come in dense. Both versions here take the TPU
kernel's blocks in its order -- history blocks of ``pages_per_block *
page_size`` tokens, then chunk blocks of ``block_q`` rows (``TileSizes``)
-- and its roundings: quantized pages (int8, token-packed int4 with
sign-extended nibbles, e4m3) dequantize as ``value * scale`` in f32
rounded to q's dtype, bit for bit the engine's gather path (f32 models
over bf16 pages promote them), q is
scaled in its own dtype, P is rounded to the value dtype after each
block's running max, masked scores take ``DEFAULT_MASK_VALUE``, a row
that sees nothing divides by 1, sinks join the denominator once.

:func:`paged_prefill_attention` takes the plain version for CPU tensors
only; a CUDA tensor launches the kernel (``csrc/paged_prefill.cu``) or
raises. int4g32 and k8v4 pages never reach it: the engine gathers their
history, as the JAX engine does.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.core.config import TileSizes
from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.flash.forward import rounded_scale
from tpu_flash_torch.ops.quant.quantize import (
    QuantizedTensor,
    unpack_int4_tokens,
)

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Page payloads, numbered as csrc/paged_prefill.cu takes them.
PAGE_KINDS = {"float32": 0, "bfloat16": 1, "int8": 2, "int4": 3, "fp8": 4}
KERNEL_HEAD_DIM = 128
KERNEL_MAX_Q_PER_KV = 64  # one block stacks q_per_kv heads in 64 rows
TILES = TileSizes()


class BlockSoftmax:
    """Online softmax over kv blocks, one step per block, with the TPU
    kernels' roundings: scaled q [b, hkv, g, q_len, d] in f32 (already
    rounded to q's dtype), P rounded to the value dtype before P V,
    deferred normalisation with optional sinks [hq]."""

    def __init__(self, qs: torch.Tensor, softcap: Optional[float]):
        shape = qs.shape[:-1] + (1,)
        self.qs = qs
        self.m = torch.full(shape, -torch.inf, device=qs.device)
        self.l = torch.zeros(shape, device=qs.device)
        self.acc = torch.zeros_like(qs)
        self.softcap = softcap
        self.inv_cap = None if softcap is None else torch.tensor(
            1.0 / softcap, dtype=torch.float32
        )

    def scores(self, k: torch.Tensor) -> torch.Tensor:
        """Softcapped scores of k [b, hkv, w, d] (f32 values)."""
        s = torch.einsum("bhgqd,bhkd->bhgqk", self.qs, k)
        if self.softcap is not None:
            s = self.softcap * torch.tanh(s * self.inv_cap)
        return s

    def step(self, s: torch.Tensor, v: torch.Tensor, p_dtype) -> None:
        """One block: masked scores s [b, hkv, g, q_len, w], values v
        [b, hkv, w, d] in f32, P rounded to ``p_dtype``."""
        m_next = torch.maximum(self.m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(self.m - m_next)
        p = torch.exp(s - m_next)
        self.l = self.l * alpha + p.sum(dim=-1, keepdim=True)
        self.m = m_next
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(p_dtype).float(), v)
        self.acc = self.acc * alpha + pv

    def finish(self, sinks: Optional[torch.Tensor], dtype) -> torch.Tensor:
        """o [b, hq, q_len, d] in ``dtype``."""
        b, hkv, g, q_len, d = self.acc.shape
        l, m = self.l, self.m
        if sinks is None:
            mult = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
        else:
            sk = sinks.float().reshape(1, hkv, g, 1, 1)
            m2 = torch.maximum(m, sk)
            scale_m = torch.exp(m - m2)
            mult = scale_m / (l * scale_m + torch.exp(sk - m2))
        return (self.acc * mult).to(dtype).reshape(b, hkv * g, q_len, d)


def scaled_queries(q: torch.Tensor, num_kv_heads: int,
                   sm_scale: float) -> torch.Tensor:
    """q * sm_scale in q's own dtype, as f32 [b, hkv, g, q_len, d]."""
    b, hq, q_len, d = q.shape
    scale = torch.tensor(rounded_scale(sm_scale, q.dtype), dtype=torch.float32)
    return (q.float() * scale).to(q.dtype).float().reshape(
        b, num_kv_heads, hq // num_kv_heads, q_len, d
    )


def paged_prefill_plain(
    q: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    k_vals: torch.Tensor,
    v_vals: torch.Tensor,
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
    q_offsets: torch.Tensor,
    page_tables: torch.Tensor,
    *,
    hist_cap: int,
    sm_scale: float,
    block_q: int,
    pages_per_block: int,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    page_kind: str = "bfloat16",
) -> torch.Tensor:
    """Plain PyTorch version of the ``paged_prefill`` kernel: pages
    [hkv, P, ps, d], or token-packed int4 [hkv, P, ps / 2, d]
    (``page_kind`` "int4"); scales [hkv, P, ps] (quantized pages) or
    None. Every history block some row needs is stepped for all rows:
    for a row it does not reach, the block is wholly masked, which leaves
    its result bit-equal
    (P is exactly 0 after a real block, and a masked block before the
    first real one is wiped by that block's alpha = 0)."""
    b, hq, q_len, d = q.shape
    hkv = chunk_k.shape[1]
    g = hq // hkv
    packed = page_kind == "int4"
    ps = k_vals.shape[2] * (2 if packed else 1)
    ppb = pages_per_block
    bk = ppb * ps
    dt, dev = q.dtype, q.device
    state = BlockSoftmax(scaled_queries(q, hkv, sm_scale), softcap)
    offs = q_offsets.to(dev).long()
    i_pos = torch.arange(q_len, device=dev)
    slopes = None if alibi is None else alibi.float().reshape(1, hkv, g, 1, 1)
    tables = page_tables.to(dev).long()

    def pages(vals, scales, pidx):
        # [hkv, P, rows, d] pages of page ids [b, ppb] -> [b, hkv, bk, d],
        # dequantized in f32 and rounded to q's dtype (the TPU `dequant`).
        x = vals[:, pidx]
        x = (unpack_int4_tokens(x) if packed else x).float()
        if scales is not None:
            x = x * scales[:, pidx][..., None]
        x = x.to(dt).float().transpose(0, 1)
        return x.reshape(b, hkv, bk, d)

    for blk in range(hist_cap // bk):
        if not bool((offs > blk * bk).any()):
            break
        j = blk * bk + torch.arange(bk, device=dev)
        live = j[None, :] < offs[:, None]  # [b, bk]: garbage past offs
        zero = ~live[:, None, :, None]
        pidx = tables[:, blk * ppb:(blk + 1) * ppb]
        kb = pages(k_vals, k_scales, pidx).masked_fill(zero, 0.0)
        vb = pages(v_vals, v_scales, pidx).masked_fill(zero, 0.0)
        s = state.scores(kb)
        abs_q = (offs[:, None] + i_pos[None, :])[:, :, None]  # [b, q, 1]
        valid = live[:, None, :].expand(b, q_len, bk)
        if window is not None:
            valid = valid & (j[None, None, :] > abs_q - window)
        if slopes is not None:
            s = s + slopes * (j[None, None, :] - abs_q).float()[:, None, None]
        s = torch.where(valid[:, None, None], s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
        state.step(s, vb, dt)

    for c0 in range(0, q_len, block_q):
        c1 = min(c0 + block_q, q_len)
        s = state.scores(chunk_k[:, :, c0:c1].float())
        rel = torch.arange(c0, c1, device=dev)[None, :] - i_pos[:, None]
        valid = rel <= 0
        if window is not None:
            valid = valid & (rel > -window)
        if slopes is not None:
            s = s + slopes * rel.float()
        s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        state.step(s, chunk_v[:, :, c0:c1].float(), chunk_v.dtype)
    return state.finish(sinks, dt)


def paged_prefill_attention(
    q: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    k_pages,
    v_pages,
    q_offsets: torch.Tensor,
    page_tables: torch.Tensor,
    *,
    hist_cap: int,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    pages_per_compute_block: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunk attention over [paged history | dense chunk].

    Args:
      q: [B, hq, q_len, d] chunk queries.
      chunk_k, chunk_v: [B, hkv, q_len, d] the chunk's own K/V.
      k_pages / v_pages: one layer's pages [hkv, num_pages, ps, d] (bf16
        or f32), or int8 / fp8 ``QuantizedTensor`` with scales
        [hkv, num_pages, ps, 1], or token-packed int4 (payload
        [hkv, num_pages, ps / 2, d], the same scales).
      q_offsets: [B] per-row history length (<= hist_cap).
      page_tables: [B, pages_per_seq] int32.
      hist_cap: bound of the history sweep, a multiple of page_size.
      block_q / pages_per_compute_block: the blocks (default as JAX).
      window / softcap / sinks / alibi: as ``flash_attention``; row i of
        batch row b sits at position q_offsets[b] + i.

    Equivalent, per row b, to causal attention of the chunk at q_offset
    q_offsets[b] over that row's first q_offsets[b] cached tokens
    (dequantized) plus the chunk itself. Returns [B, hq, q_len, d] in
    q's dtype.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if isinstance(k_pages, QuantizedTensor) != isinstance(
        v_pages, QuantizedTensor
    ):
        raise ValueError("K and V pages must both be quantized or both dense")
    k_scales = v_scales = None
    kind = None
    if isinstance(k_pages, QuantizedTensor):
        kind = k_pages.dtype_name
        if kind not in ("int8", "int4", "fp8") or v_pages.dtype_name != kind:
            raise ValueError(
                f"unsupported KV quant {kind!r}/{v_pages.dtype_name!r} "
                "(paged prefill takes int8, int4 or fp8 pages of one tier)"
            )
        if kind == "int4" and not (k_pages.packing == v_pages.packing
                                   == "tokens"):
            raise ValueError("int4 KV pages must be token-packed")
        k_vals, v_vals = k_pages.values, v_pages.values
        k_scales = k_pages.scales.squeeze(-1)
        v_scales = v_pages.scales.squeeze(-1)
    else:
        k_vals, v_vals = k_pages, v_pages
    batch, num_q_heads, q_len, head_dim = q.shape
    num_kv_heads = chunk_k.shape[1]
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be a multiple of "
            f"num_kv_heads ({num_kv_heads})"
        )
    page_size = k_vals.shape[2] * (2 if kind == "int4" else 1)
    pps = page_tables.shape[1]
    if hist_cap % page_size:
        raise ValueError(f"hist_cap {hist_cap} % page_size {page_size} != 0")
    hist_pages = hist_cap // page_size
    if hist_pages > pps:
        raise ValueError("hist_cap exceeds the page table")
    bq, ppb = TILES.prefill_blocks(num_q_heads // num_kv_heads, q_len,
                                   page_size, hist_pages, block_q,
                                   pages_per_compute_block)
    args = dict(
        hist_cap=int(hist_cap),
        sm_scale=float(sm_scale if sm_scale is not None
                       else head_dim ** -0.5),
        block_q=bq, pages_per_block=ppb,
        window=None if window is None else int(window),
        softcap=None if softcap is None else float(softcap),
        sinks=sinks, alibi=alibi,
        page_kind=kind or str(k_vals.dtype).removeprefix("torch."),
    )
    if q.device.type == "cpu":
        return paged_prefill_plain(
            q, chunk_k, chunk_v, k_vals, v_vals, k_scales, v_scales,
            q_offsets, page_tables, **args,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_prefill_attention: unsupported device {q.device}"
        )
    return _paged_prefill_cuda(
        q, chunk_k, chunk_v, k_vals, v_vals, k_scales, v_scales, q_offsets,
        page_tables, **args,
    )


def _paged_prefill_cuda(q, chunk_k, chunk_v, k_vals, v_vals, k_scales,
                        v_scales, q_offsets, page_tables, *, hist_cap,
                        sm_scale, block_q, pages_per_block, window, softcap,
                        sinks, alibi, page_kind):
    b, hq, q_len, d = q.shape
    hkv, num_pages = k_vals.shape[:2]
    ps = k_vals.shape[2] * (2 if page_kind == "int4" else 1)
    if q.dtype not in KERNEL_DTYPES or chunk_k.dtype != q.dtype or \
            chunk_v.dtype != q.dtype:
        raise ValueError(
            f"paged_prefill kernel takes f32 or bf16 q with chunk K/V of "
            f"the same dtype, got {q.dtype}/{chunk_k.dtype}/{chunk_v.dtype}"
        )
    if page_kind not in PAGE_KINDS or v_vals.dtype != k_vals.dtype:
        raise ValueError(
            f"paged_prefill kernel takes f32, bf16, int8, int4 or fp8 "
            f"pages of one dtype, got {page_kind} "
            f"({k_vals.dtype}/{v_vals.dtype})"
        )
    if d != KERNEL_HEAD_DIM or hq // hkv > KERNEL_MAX_Q_PER_KV:
        raise ValueError(
            f"paged_prefill kernel is built for head_dim {KERNEL_HEAD_DIM} "
            f"and <= {KERNEL_MAX_Q_PER_KV} q heads per kv head; got "
            f"head_dim {d}, {hq // hkv}"
        )
    for t in (chunk_k, chunk_v, k_vals, v_vals, k_scales, v_scales,
              q_offsets, page_tables, sinks, alibi):
        if t is not None and t.device != q.device:
            raise ValueError(
                "paged_prefill_attention: all tensors must share q's device"
            )
    q = q.contiguous()
    chunk_k, chunk_v, k_vals, v_vals = (
        build.aligned(t) for t in (chunk_k, chunk_v, k_vals, v_vals)
    )
    if k_scales is not None:
        k_scales = k_scales.float().contiguous()
        v_scales = v_scales.float().contiguous()
    q_offsets = q_offsets.to(torch.int32).contiguous()
    page_tables = page_tables.to(torch.int32).contiguous()
    sinks = None if sinks is None else sinks.float().contiguous()
    alibi = None if alibi is None else alibi.float().contiguous()
    o = torch.empty_like(q)
    build.PAGED_PREFILL.launch(
        build.ptr(q), build.ptr(chunk_k), build.ptr(chunk_v),
        build.ptr(k_vals), build.ptr(v_vals), build.ptr(k_scales),
        build.ptr(v_scales), build.ptr(q_offsets), build.ptr(page_tables),
        build.ptr(sinks), build.ptr(alibi), build.ptr(o),
        KERNEL_DTYPES[q.dtype], PAGE_KINDS[page_kind], b, hq, hkv,
        q_len, num_pages, ps, page_tables.shape[1], pages_per_block * ps,
        block_q, d, rounded_scale(sm_scale, q.dtype),
        0 if window is None else window,
        0.0 if softcap is None else softcap,
        0.0 if softcap is None else float(1.0 / softcap),
        build.stream_handle(q), tag=page_kind,
    )
    return o
