"""Causal-forward variants for A/B runs: the ``variant_fwd`` CUDA kernel and
its plain PyTorch version.

The port of ``tpu_flash/bench/experiments.py::variant_attention`` (the
Pallas kernel ``_kernel``, ``:30``): a standalone copy of the causal
forward over q/k/v [b, h, s, d] with q_len = kv_len and no GQA, whose mask
mode, exponential and block sizes are parameters, so that a variant can be
timed against the others behind one parity gate
(``python -m tpu_flash_torch.bench.experiments``) before it goes into the
product kernel.

``mask_mode`` "always" masks every tile, "diag" only the kv stages that
cross the diagonal: the same function, since a tile wholly below the
diagonal keeps every score. ``use_exp2`` folds log2 e into the q scale and
takes exp2. ``block_kv`` fixes where P is rounded (after each step's
running max), so the plain version steps it; ``block_q`` and
``block_kv_major`` only change which tiles are computed, and a tile past a
row's diagonal leaves its softmax state unchanged (its P is exactly 0), so
the plain version walks all rows at once.

:func:`variant_attention` takes the plain version for CPU tensors only; a
CUDA tensor launches the kernel (``csrc/variant_fwd.cu``) or raises.
"""

from __future__ import annotations

import math

import torch

from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.flash.forward import rounded_scale

LOG2E = 1.4426950408889634
MASK_MODES = ("always", "diag")
KERNEL_HEAD_DIM = 128  # what csrc/variant_fwd.cu instantiates
# (block_q, block_kv_major, block_kv) shapes csrc/variant_fwd.cu builds.
KERNEL_TILES = ((64, 128, 64), (64, 128, 128), (128, 128, 64),
                (128, 128, 128), (64, 64, 64))


def variant_scale(sm_scale: float, use_exp2: bool) -> float:
    """The q scale a variant applies (log2 e folded in under exp2)."""
    return sm_scale * LOG2E if use_exp2 else sm_scale


def _check(q, k, v, block_q, block_kv_major, block_kv, mask_mode):
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode must be one of {MASK_MODES}, got "
                         f"{mask_mode!r}")
    if k.shape != q.shape or v.shape != q.shape or q.dim() != 4:
        raise ValueError(
            f"variant_attention takes q/k/v of one [b, h, s, d] shape "
            f"(q_len = kv_len, no GQA), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    s = q.shape[2]
    if s % block_q or s % block_kv_major or block_kv_major % block_kv:
        raise ValueError(
            f"variant_attention needs s % block_q == s % block_kv_major == "
            f"block_kv_major % block_kv == 0; got s {s}, blocks "
            f"{block_q}/{block_kv_major}/{block_kv}"
        )


def variant_attention_plain(q, k, v, *, sm_scale, block_q, block_kv_major,
                            block_kv, mask_mode="always", use_exp2=False):
    """Plain PyTorch version of the ``variant_fwd`` kernel (same arguments
    as :func:`variant_attention`), stepping its ``block_kv`` columns."""
    _check(q, k, v, block_q, block_kv_major, block_kv, mask_mode)
    dt = q.dtype
    s = q.shape[2]
    scale = variant_scale(sm_scale, use_exp2)
    qs = q
    if scale != 1.0:
        qs = (q.float() * rounded_scale(scale, dt)).to(dt)
    qs = qs.float()
    exp = torch.exp2 if use_exp2 else torch.exp
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((*q.shape[:3], 1), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t0 in range(0, s, block_kv):
        kt = k[:, :, t0:t0 + block_kv].float()
        sc = torch.einsum("bhqd,bhkd->bhqk", qs, kt)
        cols = torch.arange(t0, t0 + block_kv, device=q.device)[None, :]
        sc = torch.where(cols <= rows, sc,
                         torch.full_like(sc, DEFAULT_MASK_VALUE))
        m_next = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = exp(m - m_next)
        p = exp(sc - m_next)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_next
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                          v[:, :, t0:t0 + block_kv].float())
        acc = acc * alpha + pv
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(dt)


def variant_attention(q, k, v, *, sm_scale, block_q, block_kv_major,
                      block_kv, mask_mode="always", use_exp2=False):
    """Causal attention over q/k/v [b, h, s, d] as one variant computes it:
    ``mask_mode`` "always" or "diag", ``use_exp2``, and the three block
    sizes (module docstring). Returns o in q's dtype, no lse. CPU tensors
    take :func:`variant_attention_plain`; CUDA tensors launch the kernel,
    which is built for bf16, d 128 and the shapes in ``KERNEL_TILES``."""
    kw = dict(sm_scale=sm_scale, block_q=block_q,
              block_kv_major=block_kv_major, block_kv=block_kv,
              mask_mode=mask_mode, use_exp2=use_exp2)
    if q.device.type == "cpu":
        return variant_attention_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"variant_attention: unsupported device {q.device}")
    _check(q, k, v, block_q, block_kv_major, block_kv, mask_mode)
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"variant_fwd kernel is built for bfloat16 q/k/v, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    b, h, s, d = q.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"variant_fwd kernel is built for head_dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    if (block_q, block_kv_major, block_kv) not in KERNEL_TILES:
        raise ValueError(
            f"variant_fwd kernel is built for (block_q, block_kv_major, "
            f"block_kv) in {KERNEL_TILES}, got "
            f"{(block_q, block_kv_major, block_kv)}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("variant_attention: all tensors must share q's "
                         "device")
    q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    o = torch.empty_like(q)
    build.VARIANT_FWD.launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o), b, h, s, d,
        rounded_scale(variant_scale(sm_scale, use_exp2), q.dtype),
        block_q, block_kv_major, block_kv, int(mask_mode == "always"),
        int(bool(use_exp2)), build.stream_handle(q),
    )
    return o
