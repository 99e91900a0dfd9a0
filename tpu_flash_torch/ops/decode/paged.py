"""Paged GQA decode attention: the ``paged_decode`` CUDA kernel and its
plain PyTorch version.

The port of ``tpu_flash/ops/decode/paged.py::paged_attention``, every
page tier. Both versions here reproduce the TPU kernel's arithmetic
(``_paged_attn_kernel``) at the JAX engine's settings: kv blocks of
``bk`` tokens walked in order with online softmax; an exact recent ring
as a final block of the same softmax state. Each side (K, V) has its own
tier (k8v4 pairs int8 K with int4 V):

  * float32 / bfloat16 pages: f32 dots; bf16 pages take bf16 q and P.
  * int8, int4 (token-packed, sign-extended nibbles), fp8 (e4m3) with
    per-token scales, exact: f32 dots on the stored values, the K scale
    on the score columns, the V scale folded into P.
  * "_mxu" (int8 and int4 with ``int8_mxu``): the scaled q rows
    quantized per row to +-127, integer dots, times q_scale and the K
    scale; P * v_scale quantized per row over the whole ``bk`` extent to
    [0, 127], integer dots, times p_scale.
  * fp8_native (``fp8_native``): q rows and P * v_scale rows
    renormalized into e4m3 (by absmax / 448) and dotted with the e4m3
    pages, times their row scales.
  * int4g32 (unsigned nibbles, per-32-channel affine (scale, zero) per
    token): scores sum over groups g = 0.. of ``(bf16(q_g) . k4_g) *
    s_g + sum(q_g) * z_g`` (q in f32 for the sum); PV per channel group
    ``bf16(p * s_g) . v4_g + sum(p * z_g)``.

Integer and e4m3 dots run in float64 in the plain version, exact like the
kernel's int32 sums and f32 sums of exact e4m3 products up to their
order.

:func:`paged_attention` takes the plain version for CPU tensors only; a
CUDA tensor launches the kernel (``csrc/paged_decode.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from tpu_flash_torch.core.config import TileSizes
from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.quant.quantize import (
    FP8_MAX,
    QuantizedTensor,
    div_exact,
    unpack_int4_tokens,
    unpack_uint4_tokens,
)

# Page tiers of one side, numbered as csrc/paged_decode.cu takes them.
TIERS = {"float32": 0, "bfloat16": 1, "int8": 2, "int8_mxu": 3, "int4": 4,
         "int4_mxu": 5, "int4g32": 6, "fp8": 7, "fp8_native": 8}
# The (K tier, V tier) pairs the kernel is built for.
KERNEL_TIER_PAIRS = {(t, t) for t in TIERS} | {("int8", "int4"),
                                               ("int8_mxu", "int4_mxu")}
PACKED_TIERS = ("int4", "int4_mxu", "int4g32")
MXU_TIERS = ("int8_mxu", "int4_mxu")
EXACT_SCALED_TIERS = ("int8", "int4", "fp8")
KERNEL_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (128, 256)  # what csrc/paged_decode.cu instantiates
# q heads a kv head one kernel launch holds in its shared rows; a wider
# group launches once per chunk of at most this many (in_q_head_chunks).
KERNEL_MAX_Q_PER_KV = 8
# The kernel splits each (batch row, kv head) over a cluster of `slices`
# thread blocks, at most the portable cluster size. SLICES None:
# decode_slices() picks; tests and tools/torch_decode_sweep.py set it to
# run other splits.
KERNEL_MAX_SLICES = 8
SLICES: Optional[int] = None
# Tokens a slice takes at most before the wrapper adds another.
TOKENS_PER_SLICE = 256


def decode_slices(tokens_per_seq: int, clusters_needed: int = 0,
                  clusters_held: Optional[Callable[[int], int]] = None
                  ) -> int:
    """Thread blocks a (batch row, kv head) for a page table holding
    ``tokens_per_seq`` tokens: one for each TOKENS_PER_SLICE, from 1 to
    KERNEL_MAX_SLICES; and, where ``clusters_held(s)`` says how many
    clusters of s blocks the card runs at once, the most for which all
    ``clusters_needed`` (batch rows x kv heads) run in one wave (a second
    wave costs a whole block's time again for a few clusters), as long as
    the smaller split's blocks still fit the card (``clusters_held`` 0:
    a block's share of a wide kv block is over its shared memory)."""
    want = max(1, min(KERNEL_MAX_SLICES,
                      -(-tokens_per_seq // TOKENS_PER_SLICE)))
    if clusters_held is not None:
        while (want > 1 and clusters_held(want) < clusters_needed
               and clusters_held(want - 1) > 0):
            want -= 1
    return want


@functools.lru_cache(maxsize=None)
def _clusters_held(device_index: int, args: Tuple[int, ...]) -> int:
    # What the card holds at once does not depend on the grid: the query
    # takes one batch row.
    with torch.cuda.device(device_index):
        return decode_occupancy(*args, 1)[2]


def launch_slices(q: torch.Tensor, k_tier: str, v_tier: str, hkv: int,
                  page_size: int, pages_per_seq: int, block_tokens: int,
                  ring_w: int) -> int:
    """The slices a call on ``q`` launches with: SLICES, or decode_slices
    of its page table and of its kernel instance's cluster occupancy at
    its shape (queried once a shape, planned once a batch)."""
    b, hq, d = q.shape
    return SLICES or _plan(
        (KERNEL_Q_DTYPES[q.dtype], TIERS[k_tier], TIERS[v_tier], hq, hkv,
         page_size, pages_per_seq, block_tokens, ring_w, d), b,
        q.device.index)


@functools.lru_cache(maxsize=None)
def _plan(shape, batch, device_index) -> int:
    return decode_slices(
        shape[5] * shape[6], batch * shape[4],
        lambda s: _clusters_held(device_index, shape + (s,)))


def decode_occupancy(q_dtype: int, k_tier: int, v_tier: int, hq: int,
                     hkv: int, page_size: int, pages_per_seq: int,
                     block_tokens: int, ring_w: int, head_dim: int,
                     slices: int, batch: int) -> Tuple[int, int, int]:
    """(shared bytes a block, blocks an SM, clusters the card holds at
    once) of the kernel instance a call of this shape launches: the
    library's ``paged_decode_occupancy`` query (the CUDA occupancy
    calculator); (0, 0, 0) where one block would need more shared
    memory than the card gives it."""
    args = (q_dtype, k_tier, v_tier, hq, hkv, page_size, pages_per_seq,
            block_tokens, ring_w, head_dim, slices, batch)
    query = build.PAGED_DECODE.entry("paged_decode_occupancy",
                                     [build.I] * len(args) + [build.P])
    out = (ctypes.c_int * 3)()
    rc = query(*args, out)
    if rc == build.ERR_SHARED_MEMORY:
        return 0, 0, 0
    if rc != 0:
        raise RuntimeError(f"paged_decode occupancy query {args}: CUDA "
                           f"error {rc}")
    return out[0], out[1], out[2]


def pages_per_block(page_size: int, pages_per_seq: int, small_payload: bool,
                    tiles: TileSizes = TileSizes()) -> int:
    """Pages per kv block: the JAX kernel's default (~4096 tokens for
    bf16 and quantized pages, ~2048 for f32), reduced until it divides
    pages_per_seq."""
    target = (
        tiles.decode_block_tokens if small_payload
        else tiles.decode_block_tokens_f32
    )
    ppb = max(1, min(target // page_size, pages_per_seq))
    while pages_per_seq % ppb:
        ppb -= 1
    return ppb


def _gather(x: torch.Tensor, pidx: torch.Tensor) -> torch.Tensor:
    """[hkv, P, ...] rows of a block's page ids [b, ppb] as
    [b, hkv, ppb, ...]."""
    return x[:, pidx.long()].transpose(0, 1)


def _block_values(vals: torch.Tensor, pidx: torch.Tensor,
                  tier: str) -> torch.Tensor:
    """A block's stored values as f32 [b, hkv, bk, d] (nibbles unpacked
    to their integer values, e4m3 widened)."""
    x = _gather(vals, pidx)  # [b, hkv, ppb, rows, d]
    if tier == "int4g32":
        x = unpack_uint4_tokens(x)
    elif tier in PACKED_TIERS:
        x = unpack_int4_tokens(x)
    x = x.float()
    return x.reshape(x.shape[0], x.shape[1], -1, x.shape[-1])


def _block_scales(scales: torch.Tensor, pidx: torch.Tensor,
                  tier: str) -> torch.Tensor:
    """A block's scales: [b, hkv, 1, bk] per token, or for int4g32
    [b, hkv, 2 * ng, bk] (group scale rows, then zero rows)."""
    x = _gather(scales, pidx)  # [b, hkv, ppb, ps] or [.., ppb, 2ng, ps]
    if tier == "int4g32":
        x = x.transpose(2, 3)  # [b, hkv, 2ng, ppb, ps]
        return x.reshape(x.shape[0], x.shape[1], x.shape[2], -1)
    return x.reshape(x.shape[0], x.shape[1], 1, -1)


def _row_quant(x: torch.Tensor, top: float):
    """(x / s, s) with s = absmax(x) / top per row (1 for a zero row)."""
    a = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(a == 0.0, torch.ones_like(a), div_exact(a, top))
    return x / s, s


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).float()


def _dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of exact f64 products summed in f64, rounded to f32 once:
    the kernel's order-free dot."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Last-axis sum in f64, rounded to f32 once (keepdim)."""
    return x.double().sum(dim=-1, keepdim=True).float()


def _group_slices(d: int, ng: int):
    gw = d // ng
    return [slice(g * gw, (g + 1) * gw) for g in range(ng)]


def paged_decode_plain(
    q: torch.Tensor,
    k_vals: torch.Tensor,
    v_vals: torch.Tensor,
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    k_tier: str,
    v_tier: str,
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
    pages [hkv, P, rows, d] (rows = ps / 2 for token-packed nibbles);
    scales [hkv, P, ps], [hkv, P, 2 * d/32, ps] (int4g32) or None.

    Dots and sums take exact products summed in f64 and round to f32 once
    (``_dot``, ``_sum``), and each other step rounds on its own in a
    fixed order, so the kernel matches it bit for bit on the card."""
    b, hq, d = q.shape
    hkv = k_vals.shape[0]
    ps = k_vals.shape[2] * (2 if k_tier in PACKED_TIERS else 1)
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
    q_scale = None
    if k_tier in MXU_TIERS:
        q_op, q_scale = _row_quant(qs, 127.0)
        q_op = torch.clamp(torch.round(q_op), -127, 127)
    elif k_tier == "fp8_native":
        q_op, q_scale = _row_quant(qs, FP8_MAX)
        q_op = _e4m3(q_op)
    elif k_tier in ("bfloat16", "int4g32"):
        q_op = qs.to(torch.bfloat16).float()
    else:
        q_op = qs
    slopes = None if alibi is None else alibi.float().reshape(1, hkv, g, 1)
    inv_cap = None if softcap is None else torch.tensor(
        1.0 / softcap, dtype=f32
    )

    def capped(s):
        return s if softcap is None else softcap * torch.tanh(s * inv_cap)

    def scores(kb, ksc):
        if k_tier == "int4g32":
            ng = ksc.shape[2] // 2
            s = torch.zeros((b, hkv, g, bk), device=dev)
            for gi, sl in enumerate(_group_slices(d, ng)):
                part = _dot("bhgd,bhkd->bhgk", q_op[..., sl], kb[..., sl])
                qsum = _sum(qs[..., sl])
                s = s + part * ksc[:, :, None, gi] + (
                    qsum * ksc[:, :, None, ng + gi])
            return s
        s = _dot("bhgd,bhkd->bhgk", q_op, kb)
        if q_scale is not None:
            s = s * q_scale
        return s if ksc is None else s * ksc

    def pv(p, vb, vsc):
        if v_tier == "int4g32":
            ng = vsc.shape[2] // 2
            parts = []
            for gi, sl in enumerate(_group_slices(d, ng)):
                pg = (p * vsc[:, :, None, gi]).to(torch.bfloat16).float()
                zg = _sum(p.double() * vsc[:, :, None, ng + gi].double())
                parts.append(_dot("bhgk,bhkd->bhgd", pg, vb[..., sl]) + zg)
            return torch.cat(parts, dim=-1)
        if v_tier in MXU_TIERS or v_tier == "fp8_native":
            top = 127.0 if v_tier in MXU_TIERS else FP8_MAX
            p_op, p_scale = _row_quant(p * vsc, top)
            p_op = (torch.clamp(torch.round(p_op), 0, 127)
                    if v_tier in MXU_TIERS else _e4m3(p_op))
            return _dot("bhgk,bhkd->bhgd", p_op, vb) * p_scale
        if v_tier in EXACT_SCALED_TIERS:
            p = p * vsc
        elif v_tier == "bfloat16":
            p = p.to(torch.bfloat16).float()
        return _dot("bhgk,bhkd->bhgd", p, vb)

    m = torch.full((b, hkv, g, 1), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, g, 1), device=dev)
    acc = torch.zeros((b, hkv, g, d), device=dev)

    def update(s, pv_fn, active):
        nonlocal m, l, acc
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l_next = l * alpha + _sum(p)
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
        kb = _block_values(k_vals, pidx, k_tier)  # [b, hkv, bk, d]
        vb = _block_values(v_vals, pidx, v_tier)
        ksc = None if k_scales is None else _block_scales(k_scales, pidx,
                                                          k_tier)
        vsc = None if v_scales is None else _block_scales(v_scales, pidx,
                                                          v_tier)
        s = capped(scores(kb, ksc))
        pos = i * bk + torch.arange(bk, device=dev)[None, :]  # [1, bk]
        valid = pos < page_limit[:, None]
        if window is not None:
            valid = valid & (pos >= (eff - window)[:, None])
        if slopes is not None:
            s = s + slopes * (pos - (eff[:, None] - 1)).float()[:, None, None]
        s = torch.where(valid[:, None, None], s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
        update(s, lambda p, vb=vb, vsc=vsc: pv(p, vb, vsc), active)

    if w_ring:
        q_r = qs.to(torch.bfloat16).float()
        s = capped(_dot("bhgd,bhwd->bhgw", q_r, recent_k))
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
            lambda p: _dot("bhgw,bhwd->bhgd", p.to(torch.bfloat16).float(),
                           recent_v),
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


def fp8_native_default(device) -> bool:
    """Whether e4m3 pages take the native tier by default: on a CUDA
    device that multiplies e4m3 (compute capability 8.9 and up), as the
    JAX kernel turns it on where the device's matrix unit takes fp8;
    off on the CPU."""
    device = torch.device(device)
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device) >= (8, 9))


def side_tier(pages, *, int8_mxu: bool, fp8_native: bool):
    """(tier name, values, scales) of one side's pages for the kernel:
    per-token scales as [hkv, P, ps], int4g32's as stored."""
    if not isinstance(pages, QuantizedTensor):
        if pages.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported page dtype {pages.dtype}")
        return str(pages.dtype).removeprefix("torch."), pages, None
    name = pages.dtype_name
    if name not in ("int8", "int4", "int4g32", "fp8"):
        raise ValueError(f"unsupported KV quant {name!r}")
    if name in ("int4", "int4g32") and pages.packing != "tokens":
        raise ValueError(
            "int4 KV pages must be token-packed (quantize_pages)"
        )
    if name == "int4g32":
        return name, pages.values, pages.scales
    if name in ("int8", "int4") and int8_mxu:
        name += "_mxu"
    elif name == "fp8" and fp8_native:
        name = "fp8_native"
    return name, pages.values, pages.scales.squeeze(-1)


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
    int4_bitwise_unpack: bool = False,
    fp8_native: Optional[bool] = None,
    return_state: bool = False,
    recent_k: Optional[torch.Tensor] = None,
    recent_v: Optional[torch.Tensor] = None,
):
    """Single-token GQA decode attention over a paged KV cache.

    Args:
      q: [batch, num_q_heads, head_dim] current-token queries.
      k_pages / v_pages: dense [num_kv_heads, num_pages, page_size, d]
        (bf16 or f32), or ``QuantizedTensor`` pages: int8 or fp8 with
        per-token scales [num_kv_heads, num_pages, page_size, 1]; int4
        token-packed to [.., page_size / 2, d] with per-token scales;
        int4g32 token-packed with group rows [.., 2 * d/32, page_size].
        K and V may differ in tier (k8v4: int8 K, int4 V).
      lengths: [batch] int32 context lengths (>= 1).
      page_indices: [batch, pages_per_seq] int32 page table.
      int8_mxu: int8 and int4 pages -- quantize q and P rows to int8 and
        take integer dots (the JAX default); False is the exact dequant
        path.
      int4_bitwise_unpack: accepted for the JAX signature; the JAX
        kernel's nibble-plane variant gives the unpack path's scores bit
        for bit (and P within its split rounding), so both settings
        compute the unpack path here.
      fp8_native: fp8 pages -- renormalize q and P rows into e4m3 and
        dot them with the e4m3 pages; False is the exact dequant path;
        None turns it on for a CUDA device that multiplies e4m3
        (:func:`fp8_native_default`), off on the CPU.
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
    del int4_bitwise_unpack  # the unpack path either way (see Args)
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
    if fp8_native is None:
        fp8_native = fp8_native_default(q.device)
    opts = dict(int8_mxu=int8_mxu, fp8_native=bool(fp8_native))
    k_tier, k_vals, k_scales = side_tier(k_pages, **opts)
    v_tier, v_vals, v_scales = side_tier(v_pages, **opts)
    if k_scales is None and v_vals.dtype != k_vals.dtype:
        raise ValueError("K and V pages must share a dtype")
    batch, num_q_heads, head_dim = q.shape
    num_kv_heads = k_vals.shape[0]
    page_size = k_vals.shape[2] * (2 if k_tier in PACKED_TIERS else 1)
    v_page_size = v_vals.shape[2] * (2 if v_tier in PACKED_TIERS else 1)
    if v_page_size != page_size:
        raise ValueError(
            f"K and V pages disagree on tokens/page: {page_size} vs "
            f"{v_page_size}"
        )
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be a multiple of "
            f"num_kv_heads ({num_kv_heads})"
        )
    pps = page_indices.shape[1]
    if pages_per_compute_block is None:
        ppb = pages_per_block(page_size, pps, k_tier != "float32")
    else:
        ppb = min(pages_per_compute_block, pps)
    if pps % ppb:
        raise ValueError(
            f"pages_per_seq ({pps}) must be a multiple of "
            f"pages_per_compute_block ({ppb})"
        )
    scale = float(sm_scale if sm_scale is not None else head_dim ** -0.5)
    args = dict(
        k_tier=k_tier, v_tier=v_tier, sm_scale=scale,
        pages_per_compute_block=ppb,
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


def in_q_head_chunks(run, q, k_vals, *args, sinks=None, alibi=None,
                     return_state=False, **kw):
    """``run`` (a decode of ``paged_decode_plain``'s signature) on each
    chunk of at most KERNEL_MAX_Q_PER_KV q heads of every kv head's group,
    the results scattered back into one [b, hq, d] output (and [b, hq]
    m, l). A q row's arithmetic does not depend on the other rows, so
    the chunks give the whole call's values."""
    hq, hkv = q.shape[1], k_vals.shape[0]
    g = hq // hkv
    heads = torch.arange(hq, device=q.device).reshape(hkv, g)
    outs = None
    for j0 in range(0, g, KERNEL_MAX_Q_PER_KV):
        idx = heads[:, j0:j0 + KERNEL_MAX_Q_PER_KV].reshape(-1)
        part = run(
            q[:, idx].contiguous(), k_vals, *args,
            sinks=None if sinks is None else sinks[idx].contiguous(),
            alibi=None if alibi is None else alibi[idx].contiguous(),
            return_state=return_state, **kw,
        )
        part = part if return_state else (part,)
        if outs is None:
            outs = [x.new_empty(x.shape[:1] + (hq,) + x.shape[2:])
                    for x in part]
        for o, x in zip(outs, part):
            o[:, idx] = x
    return tuple(outs) if return_state else outs[0]


def _paged_decode_cuda(q, k_vals, v_vals, k_scales, v_scales, lengths,
                       page_indices, *, k_tier, v_tier, sm_scale,
                       pages_per_compute_block, window, softcap, sinks,
                       alibi, recent_k, recent_v, return_state):
    b, hq, d = q.shape
    hkv, num_pages = k_vals.shape[:2]
    if hq // hkv > KERNEL_MAX_Q_PER_KV:
        return in_q_head_chunks(
            _paged_decode_cuda, q, k_vals, v_vals, k_scales, v_scales,
            lengths, page_indices, k_tier=k_tier, v_tier=v_tier,
            sm_scale=sm_scale,
            pages_per_compute_block=pages_per_compute_block, window=window,
            softcap=softcap, sinks=sinks, alibi=alibi, recent_k=recent_k,
            recent_v=recent_v, return_state=return_state)
    ps = k_vals.shape[2] * (2 if k_tier in PACKED_TIERS else 1)
    if q.dtype not in KERNEL_Q_DTYPES:
        raise ValueError(f"paged_decode kernel takes f32/bf16 q, got {q.dtype}")
    if (k_tier, v_tier) not in KERNEL_TIER_PAIRS:
        raise ValueError(
            f"paged_decode kernel has no {k_tier} K / {v_tier} V build"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged_decode kernel is built for head_dim {KERNEL_HEAD_DIMS}, "
            f"got {d}"
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
    k_vals, v_vals = build.aligned(k_vals), build.aligned(v_vals)
    if k_scales is not None:
        k_scales = k_scales.float().contiguous()
        v_scales = v_scales.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32).contiguous()
    if recent_k is not None:
        recent_k, recent_v = build.aligned(recent_k), build.aligned(recent_v)
    pps = page_indices.shape[1]
    bk = pages_per_compute_block * ps
    ring_w = 0 if recent_k is None else recent_k.shape[2]
    slices = launch_slices(q, k_tier, v_tier, hkv, ps, pps, bk, ring_w)
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
        KERNEL_Q_DTYPES[q.dtype], TIERS[k_tier], TIERS[v_tier], b, hq, hkv,
        num_pages, ps, pps, bk, ring_w, d,
        sm_scale, 0 if window is None else window,
        0.0 if softcap is None else softcap,
        0.0 if softcap is None else float(1.0 / softcap),
        slices, build.stream_handle(q),
        tag=k_tier if k_tier == v_tier else f"{k_tier}/{v_tier}",
    )
    if return_state:
        return o, m_out, l_out
    return o
