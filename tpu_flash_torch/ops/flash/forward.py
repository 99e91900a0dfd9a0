"""Flash-attention forward: the ``flash_fwd`` CUDA kernel and its plain
PyTorch version.

One computation replaces the four Pallas grid geometries of
``tpu_flash/ops/flash/forward.py`` (rectangular ``_flash_fwd_kernel``,
single-pass ``_flash_fwd_onepass_kernel``, triangular
``_flash_fwd_tri_kernel`` and paired ``_flash_fwd_tri2_kernel``): tiled
online softmax with deferred normalisation. Both versions here walk the
same kv tiles (``TileSizes.block_kv`` rows) with the TPU kernel's
roundings -- q scaled in its own dtype, P rounded to the value dtype
before P V, ``acc * (1 / l)`` at the end -- so they agree with each other
to summation order, and with the JAX kernel wherever it uses the same kv
tile.

:func:`flash_fwd` takes the plain version for CPU tensors only; a CUDA
tensor launches the kernel (``csrc/flash_fwd.cu``) or raises: bf16 on
the tensor cores, f32 on the order-exact kernel. :func:`flash_fwd_exact`
takes the source's order-exact entry in both dtypes: the order-exact
prefill tile (``csrc/prefill_tile.cuh``) over dense K/V on the CUDA
cores, whose rows a block and score scratch :func:`tile_launch` sizes.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.core.config import TileSizes
from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128, 256)  # what csrc/flash_fwd.cu instantiates
KERNEL_TILES = TileSizes()  # what csrc/flash_fwd.cu compiles


def rounded_scale(sm_scale: float, dtype: torch.dtype) -> float:
    """The softmax scale as the kernels apply it: rounded to the q dtype
    first (JAX multiplies a bf16 q by a weakly-typed scalar in bf16)."""
    return float(torch.tensor(sm_scale, dtype=dtype).float())


def segment_ids_for_kernel(q_seg, kv_seg):
    """Segment ids as the kernels read them: contiguous int32 (None
    stays None)."""
    if q_seg is None:
        return None, None
    return (q_seg.to(torch.int32).contiguous(),
            kv_seg.to(torch.int32).contiguous())


def flash_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    save_lse: bool = False,
):
    """Plain PyTorch version of the ``flash_fwd`` kernel (same arguments
    as :func:`flash_fwd`), stepping the kernel's kv tiles."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    dt = q.dtype
    dev = q.device
    scale = torch.tensor(rounded_scale(sm_scale, dt), dtype=torch.float32)
    qs = (q.float() * scale).to(dt).float().reshape(b, hkv, g, sq, d)
    qpos = (torch.arange(sq, device=dev) + q_offset)[:, None]
    slopes = None
    if alibi is not None:
        slopes = alibi.float().reshape(1, hkv, g, 1, 1)
    m = torch.full((b, hkv, g, sq, 1), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, g, sq, 1), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    inv_cap = None if softcap is None else torch.tensor(
        1.0 / softcap, dtype=torch.float32
    )
    block_kv = KERNEL_TILES.block_kv
    for t0 in range(0, kv_len, block_kv):
        t1 = min(t0 + block_kv, kv_len)
        kt = k[:, :, t0:t1].float()
        vt = v[:, :, t0:t1].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qs, kt)
        if softcap is not None:
            s = softcap * torch.tanh(s * inv_cap)
        kpos = (torch.arange(t0, t1, device=dev))[None, :]
        valid = torch.ones((sq, t1 - t0), dtype=torch.bool, device=dev)
        if causal:
            valid = kpos <= qpos
            if window is not None:
                valid = valid & (kpos > qpos - window)
            if slopes is not None:
                s = s + slopes * (kpos - qpos).float()
        if q_seg is not None:
            same = q_seg[:, :, None] == kv_seg[:, None, t0:t1]
            valid = (valid & same)[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_next
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vt)
        acc = acc * alpha + pv
    if sinks is None:
        mult = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
        lse = torch.where(
            m == -torch.inf, torch.full_like(m, -torch.inf), m + torch.log(l)
        )
    else:
        sk = sinks.float().reshape(1, hkv, g, 1, 1)
        m2 = torch.maximum(m, sk)
        scale_m = torch.exp(m - m2)
        l_tot = l * scale_m + torch.exp(sk - m2)
        mult = scale_m / l_tot
        lse = m2 + torch.log(l_tot)
    o = (acc * mult).to(dt).reshape(b, hq, sq, d)
    if save_lse:
        return o, lse.reshape(b, hq, sq)
    return o


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    save_lse: bool = False,
):
    """Attention forward over q [b, hq, sq, d], k/v [b, hkv, skv, d].

    Masks: causal (q row i sits at position i + q_offset), the kv tail
    (positions >= kv_len), a sliding ``window``, segment ids (``q_seg``
    [b, sq] and ``kv_seg`` [b, skv] int32: a score whose ids differ is
    masked); ``softcap`` applies before masking, ``alibi`` slopes [hq]
    after it; ``sinks`` [hq] join the denominator. Returns o in q's
    dtype, and lse f32 [b, hq, sq] with ``save_lse``. CPU tensors take
    :func:`flash_fwd_plain`; CUDA tensors launch the kernel.
    """
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              kv_len=kv_len, window=window, softcap=softcap, sinks=sinks,
              alibi=alibi, q_seg=q_seg, kv_seg=kv_seg, save_lse=save_lse)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    return _flash_fwd_cuda(build.FLASH_FWD, q, k, v, **kw)


def flash_fwd_exact(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **kw):
    """:func:`flash_fwd` (the same arguments and results) on the kernel's
    order-exact entry: the order-exact prefill tile on the CUDA cores in
    both dtypes, whose sums run one FMA at a time in the order of this
    module's plain version on the card. The tensor cores sum inside each
    product in an order of their own; the serving engine takes this entry
    so that its greedy tokens stay the plain version's. CPU tensors take
    :func:`flash_fwd_plain`."""
    if q.device.type != "cuda":
        return flash_fwd(q, k, v, **kw)  # the plain version, or a refusal
    return _flash_fwd_cuda(build.FLASH_FWD_EXACT, q, k, v, **kw)


def tile_heads(group: int, rows: int) -> int:
    """q heads a block of the order-exact kernel holds: the largest
    divisor of the GQA group that fits its rows (the whole group where
    it fits), each over ``rows // heads`` positions (flash_fwd.cu's
    ``heads_per_block``)."""
    return max(h for h in range(1, min(group, rows) + 1) if group % h == 0)


def tile_launch(q: torch.Tensor, num_kv_heads: int,
                sms: Optional[int] = None):
    """(rows a block, score scratch, its slots) of an order-exact launch
    over q: 16 rows for a bf16 call whose 64-row grid would leave SMs
    idle (``paged_prefill.tile_rows``), else 64; a score scratch only
    where a kv step (``block_kv`` columns) is wider than the tile's
    window (d 256), with a slot for each block the card runs at once
    (``paged_prefill.tile_scratch``), else (None, 0)."""
    # paged_prefill imports this module: take it at call time.
    from tpu_flash_torch.ops.flash import paged_prefill as pp

    hq, d = q.shape[1], q.shape[-1]
    rows = pp.tile_rows(q, num_kv_heads, sms)
    if KERNEL_TILES.block_kv <= pp.TILE_WINDOW[256 if d > 128 else 128]:
        return rows, None, 0
    heads = tile_heads(hq // num_kv_heads, rows)
    resident = pp.resident_blocks(build.FLASH_FWD_EXACT,
                                  (KERNEL_DTYPES[q.dtype], d, rows), q.device)
    scratch, slots = pp.tile_scratch(q, hq // heads, rows,
                                     KERNEL_TILES.block_kv, resident)
    return rows, scratch, slots


def _flash_fwd_cuda(kernel, q, k, v, *, causal, sm_scale, q_offset=0,
                    kv_len=None, window=None, softcap=None, sinks=None,
                    alibi=None, q_seg=None, kv_seg=None, save_lse=False):
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd kernel takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_fwd kernel is built for head_dim {KERNEL_HEAD_DIMS}, "
            f"got {d}"
        )
    for t in (k, v, sinks, alibi, q_seg, kv_seg):
        if t is not None and t.device != q.device:
            raise ValueError("flash_fwd: all tensors must share q's device")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"flash_fwd: kv_len {kv_len} outside [0, {skv}]")
    q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    sinks = None if sinks is None else sinks.float().contiguous()
    alibi = None if alibi is None else alibi.float().contiguous()
    q_seg, kv_seg = segment_ids_for_kernel(q_seg, kv_seg)
    o = torch.empty_like(q)
    lse = (
        torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        if save_lse else None
    )
    rows, scratch, slots = 0, None, 0  # the tensor cores take neither
    if kernel is build.FLASH_FWD_EXACT or q.dtype == torch.float32:
        rows, scratch, slots = tile_launch(q, hkv)
    kernel.launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
        build.ptr(lse), build.ptr(sinks), build.ptr(alibi),
        build.ptr(q_seg), build.ptr(kv_seg), build.ptr(scratch),
        0 if scratch is None else scratch.numel(), slots, rows,
        KERNEL_DTYPES[q.dtype], b, hq, hkv, sq, skv, kv_len, d,
        rounded_scale(sm_scale, q.dtype), int(bool(causal)), int(q_offset),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        0.0 if softcap is None else float(1.0 / softcap),
        build.stream_handle(q),
    )
    return (o, lse) if save_lse else o
