"""Quantized-input flash attention (int8 / fp8 Q, K, V): the port of
``tpu_flash/ops/flash/quantized.py``.

Q/K/V arrive quantized per row (symmetric absmax scales) and dequantize
inside the products as rank-1 rescales:

    (q_i s_q) (k_j s_k)^T = s_q * (q_i k_j^T) * s_k      (scores)
    sum_j p_j (v_j s_vj)  = sum_j (p_j s_vj) v_j          (P V)

Scale layouts are the JAX package's: q scales lane-replicated [b, hq, s,
128] f32 (here a stride-0 expand of [b, hq, s, 1]: the same shape, no
memory), k/v scales row vectors [b, hkv, 1, s] f32.

Routes, as in JAX: tiled (the JAX kernel's rectangular and triangular
grids; one kernel loop here visits only live kv tiles, so one route
serves both) and the opt-in int8 staircase (``onepass=True``, the JAX
``BlockSizes(onepass=True, onepass_diag=512)``, gated as JAX gates it).
:func:`quant_fwd` launches the ``quant_fwd`` kernel
(``csrc/quant_fwd.cu``) on CUDA tensors and takes :func:`quant_fwd_plain`
on CPU tensors; the two walk the same 128-column kv steps and round at
the same places, so they differ only in the order of f32 sums.

Scores are exact dot products rounded to f32 once, on both sides: the
plain version sums int8 products in f32 (exact below 2^24) and e4m3
products in f64 (exact); the kernel takes int8 dots from the tensor
cores' s32 sums and e4m3 dots as exact int64 sums of s8 limb products
(tensor-core f32 sums of e4m3 products, as the JAX kernel takes them,
round inside the product and would flip P roundings). Every P then
rounds alike, and the two differ only in the order of the f32 sums of l
and P V. The fp8 tier: software (P V as bf16(p * v_scale) times V) or
native (P V renormalises each P row into e4m3); by default native where
the card multiplies e4m3 (compute capability 8.9 and up), software on
the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_flash_torch.core.config import TileSizes
from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.decode.paged import fp8_native_default
from tpu_flash_torch.ops.quant.quantize import (
    FP8_MAX,
    INT8_MAX,
    div_exact,
    quantize_fp8_rows,
    quantize_pallas,
)

NUM_LANES = 128  # the lane-replicated width of the q scales (JAX layout)
QUANT_BLOCK_Q = 64  # the JAX function's q block: q_len's alignment
QUANT_BLOCK_KV = TileSizes().block_kv  # kv columns per online-softmax step
ONEPASS_STAIR = 512  # rows of one staircase stair (the JAX diag_rows)
KERNEL_HEAD_DIMS = (64, 128, 256)  # what csrc/quant_fwd.cu instantiates
KERNEL_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"int8": 0, "fp8": 1, "fp8_native": 2, "onepass": 3}


class QuantizedAttentionInputs(NamedTuple):
    """Q/K/V quantized in the kernel's scale layouts."""

    q_values: torch.Tensor  # [b, hq, s, d] int8 | float8_e4m3fn
    q_scales: torch.Tensor  # [b, hq, s, 128] f32, lane-replicated
    k_values: torch.Tensor  # [b, hkv, s, d]
    k_scales: torch.Tensor  # [b, hkv, 1, s] f32, row vector
    v_values: torch.Tensor
    v_scales: torch.Tensor
    dtype_name: str  # "int8" | "fp8"


def quantize_attention_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dtype_name: str = "int8",
) -> QuantizedAttentionInputs:
    """Per-row symmetric quantization of q/k/v into the kernel's scale
    layouts, byte-identical to the JAX function. int8 rows go through
    :func:`quantize_pallas` (the ``quantize_rows`` kernel on CUDA
    tensors), fp8 rows through plain tensor code."""
    if dtype_name not in ("int8", "fp8"):
        raise ValueError(f"unsupported attention quant dtype {dtype_name!r}")

    def quant(x):
        if dtype_name == "int8":
            qt = quantize_pallas(x)
            return qt.values, qt.scales
        return quantize_fp8_rows(x)

    qv, qs = quant(q)
    kv_, ks = quant(k)
    vv, vs = quant(v)
    return QuantizedAttentionInputs(
        q_values=qv,
        q_scales=qs.expand(*qs.shape[:-1], NUM_LANES),
        k_values=kv_,
        k_scales=ks.squeeze(-1).unsqueeze(2),
        v_values=vv,
        v_scales=vs.squeeze(-1).unsqueeze(2),
        dtype_name=dtype_name,
    )


def dequantize_attention_inputs(inputs: QuantizedAttentionInputs,
                                dtype=torch.float32):
    """Exact dequantized q/k/v: the parity oracle for the fused kernel."""
    q = inputs.q_values.float() * inputs.q_scales[..., :1]
    k = inputs.k_values.float() * inputs.k_scales[:, :, 0, :, None]
    v = inputs.v_values.float() * inputs.v_scales[:, :, 0, :, None]
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def _epilogue(acc, m, l, sinks, g):
    """acc / l (l == 0: 1), or the sink-inclusive denominator."""
    if sinks is None:
        return acc * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    sk = sinks.float().reshape(1, -1, g, 1, 1)
    m2 = torch.maximum(m, sk)
    scale_m = torch.exp(m - m2)
    l_tot = l * scale_m + torch.exp(sk - m2)
    return acc * (scale_m / l_tot)


def quant_fwd_plain(
    qv, qs, kv_, ks, vv, vs, *, dtype_name: str, causal: bool,
    sm_scale: float, kv_len: Optional[int] = None,
    window: Optional[int] = None, softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None, fp8_native: bool = False,
    onepass: bool = False, out_dtype=torch.bfloat16,
):
    """Plain PyTorch version of the ``quant_fwd`` kernel (same arguments
    as :func:`quant_fwd`): the tiled route steps 128-column kv tiles
    with an online softmax, the staircase computes each stair's two parts
    whole."""
    b, hq, sq, d = qv.shape
    hkv, skv = kv_.shape[1], kv_.shape[2]
    g = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    dev = qv.device
    q_scale = (qs[..., :1].float() * _f32(sm_scale, dev)).reshape(
        b, hkv, g, sq, 1)
    # Exact scores, rounded to f32 once: int8 dots stay below 2^24 and sum
    # exactly in f32; e4m3 products are multiples of 2^-18 below 2^25 and
    # sum exactly in f64, in any order (the kernel sums them in int64).
    exact = torch.float32 if dtype_name == "int8" else torch.float64
    qf = qv.to(exact).reshape(b, hkv, g, sq, d)
    k_sc = ks[:, :, 0, :].float()[:, :, None, None, :]  # [b, hkv, 1, 1, skv]
    v_sc = vs[:, :, 0, :].float()[:, :, None, None, :]
    slopes = None if alibi is None else alibi.float().reshape(1, hkv, g, 1, 1)
    inv_cap = None if softcap is None else _f32(1.0 / softcap, dev)
    kf, vf = kv_.to(exact), vv.float()

    def scores(rows, t0, t1, mask):
        """Scores of q rows ``rows`` against kv columns [t0, t1)."""
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, rows],
                         kf[:, :, t0:t1]).float()
        s = s * q_scale[:, :, :, rows] * k_sc[..., t0:t1]
        if softcap is not None:
            s = softcap * torch.tanh(s * inv_cap)
        qpos = torch.arange(sq, device=dev)[rows][:, None]
        kpos = torch.arange(t0, t1, device=dev)[None, :]
        valid = kpos < kv_len
        if causal:
            if mask:
                valid = valid & (kpos <= qpos)
                if window is not None:
                    valid = valid & (kpos > qpos - window)
            if slopes is not None:
                s = s + slopes * (kpos - qpos).float()
        return torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))

    if onepass:
        o = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
        for lo in range(0, sq, ONEPASS_STAIR):
            rows = slice(lo, lo + ONEPASS_STAIR)
            parts = [_onepass_part(scores(rows, lo, lo + ONEPASS_STAIR, True),
                                   v_sc[..., lo:lo + ONEPASS_STAIR],
                                   vv[:, :, lo:lo + ONEPASS_STAIR])]
            if lo > 0:
                parts.append(_onepass_part(scores(rows, 0, lo, False),
                                           v_sc[..., :lo], vv[:, :, :lo]))
            if len(parts) == 1:
                m, l, pv = parts[0]
            else:
                (m2, l2, pv2), (m1, l1, pv1) = parts
                m = torch.maximum(m1, m2)
                a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
                l = l1 * a1 + l2 * a2
                pv = pv1 * a1 + pv2 * a2
            o[:, :, :, rows] = _epilogue(pv, m, l, sinks, g)
        return o.to(out_dtype).reshape(b, hq, sq, d)

    m = torch.full((b, hkv, g, sq, 1), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, g, sq, 1), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    for t0 in range(0, kv_len, QUANT_BLOCK_KV):
        t1 = min(t0 + QUANT_BLOCK_KV, skv)
        # Rows that see no column of this tile (above the causal diagonal,
        # past the window) would add exactly nothing: leave them out.
        r0 = t0 if causal else 0
        r1 = min(sq, t1 - 1 + window) if causal and window else sq
        if r0 >= r1:
            continue
        rows = slice(r0, r1)
        s = scores(rows, t0, t1, True)
        m_prev = m[:, :, :, rows]
        m_next = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_prev - m_next)
        p = torch.exp(s - m_next)
        l[:, :, :, rows] = l[:, :, :, rows] * alpha + p.sum(-1, keepdim=True)
        m[:, :, :, rows] = m_next
        pv_f = p * v_sc[..., t0:t1]
        if fp8_native and dtype_name == "fp8":
            c = pv_f.amax(dim=-1, keepdim=True)
            c = torch.where(c == 0.0, torch.ones_like(c), div_exact(c, FP8_MAX))
            p_f8 = (pv_f / c).to(torch.float8_e4m3fn).float()
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p_f8, vf[:, :, t0:t1]) * c
        else:
            pv = torch.einsum("bhgqk,bhkd->bhgqd",
                              pv_f.to(torch.bfloat16).float(),
                              vf[:, :, t0:t1])
        acc[:, :, :, rows] = acc[:, :, :, rows] * alpha + pv
    return _epilogue(acc, m, l, sinks, g).to(out_dtype).reshape(b, hq, sq, d)


def _onepass_part(s, v_sc, v8):
    """(m, l, P V) of one stair part: P quantized to int8 per row over
    the whole part, P V an exact integer dot (in f64) times p_scale."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv_f = p * v_sc
    p_abs = pv_f.amax(dim=-1, keepdim=True)
    p_scale = torch.where(p_abs == 0.0, torch.ones_like(p_abs),
                          div_exact(p_abs, INT8_MAX))
    p8 = torch.clamp(torch.round(pv_f / p_scale), 0.0, INT8_MAX)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p8.double(), v8.double())
    return m, l, pv.float() * p_scale


def quant_fwd(qv, qs, kv_, ks, vv, vs, *, dtype_name: str, causal: bool,
              sm_scale: float, kv_len: Optional[int] = None,
              window: Optional[int] = None, softcap: Optional[float] = None,
              sinks: Optional[torch.Tensor] = None,
              alibi: Optional[torch.Tensor] = None, fp8_native: bool = False,
              onepass: bool = False, out_dtype=torch.bfloat16):
    """Attention over quantized q [b, hq, sq, d] and k/v [b, hkv, skv, d]
    with scales in the JAX layouts. CPU tensors take
    :func:`quant_fwd_plain`; CUDA tensors launch the kernel."""
    kw = dict(dtype_name=dtype_name, causal=causal, sm_scale=sm_scale,
              kv_len=kv_len, window=window, softcap=softcap, sinks=sinks,
              alibi=alibi, fp8_native=fp8_native, onepass=onepass,
              out_dtype=out_dtype)
    if qv.device.type == "cpu":
        return quant_fwd_plain(qv, qs, kv_, ks, vv, vs, **kw)
    if qv.device.type != "cuda":
        raise ValueError(f"quant_fwd: unsupported device {qv.device}")
    return _quant_fwd_cuda(qv, qs, kv_, ks, vv, vs, **kw)


def _quant_fwd_cuda(qv, qs, kv_, ks, vv, vs, *, dtype_name, causal,
                    sm_scale, kv_len, window, softcap, sinks, alibi,
                    fp8_native, onepass, out_dtype):
    payload = torch.int8 if dtype_name == "int8" else torch.float8_e4m3fn
    if any(t.dtype != payload for t in (qv, kv_, vv)):
        raise ValueError(
            f"quant_fwd kernel takes {payload} q/k/v for {dtype_name!r}, got "
            f"{qv.dtype}/{kv_.dtype}/{vv.dtype}"
        )
    if out_dtype not in KERNEL_OUT_DTYPES:
        raise ValueError(f"quant_fwd kernel writes f32 or bf16, not {out_dtype}")
    b, hq, sq, d = qv.shape
    hkv, skv = kv_.shape[1], kv_.shape[2]
    if d not in KERNEL_HEAD_DIMS or skv % QUANT_BLOCK_KV:
        raise ValueError(
            f"quant_fwd kernel is built for head_dim in {KERNEL_HEAD_DIMS} "
            f"and a stored kv length divisible by {QUANT_BLOCK_KV}; got "
            f"head_dim {d}, stored kv {skv}"
        )
    for t in (qs, kv_, ks, vv, vs, sinks, alibi):
        if t is not None and t.device != qv.device:
            raise ValueError("quant_fwd: all tensors must share q's device")
    qs = qs.float()
    qs_strides = qs.stride()[:3]
    u8 = torch.uint8
    qv, kv_, vv = (build.aligned(t).view(u8) for t in (qv, kv_, vv))
    ks, vs = build.aligned(ks.float()), build.aligned(vs.float())
    sinks = None if sinks is None else sinks.float().contiguous()
    alibi = None if alibi is None else alibi.float().contiguous()
    mode = "onepass" if onepass else (
        "fp8_native" if dtype_name == "fp8" and fp8_native else dtype_name)
    o = torch.empty((b, hq, sq, d), dtype=out_dtype, device=qv.device)
    build.QUANT_FWD.launch(
        build.ptr(qv), build.ptr(qs), build.ptr(kv_), build.ptr(ks),
        build.ptr(vv), build.ptr(vs), build.ptr(o), build.ptr(sinks),
        build.ptr(alibi), *qs_strides, MODES[mode],
        KERNEL_OUT_DTYPES[out_dtype], b, hq, hkv, sq, skv,
        skv if kv_len is None else int(kv_len), d, int(bool(causal)),
        0 if window is None else int(window), float(sm_scale),
        0.0 if softcap is None else float(softcap),
        0.0 if softcap is None else float(1.0 / softcap),
        build.stream_handle(qv), tag=mode,
    )
    return o


def quant_occupancy(mode: str, out_dtype, head_dim: int):
    """(shared memory bytes a block, blocks an SM) of the kernel instance
    that serves ``mode`` (a key of MODES) at ``out_dtype`` and
    ``head_dim`` on the current card (the CUDA occupancy calculator)."""
    import ctypes

    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    fn = build.QUANT_FWD.entry("quant_fwd_occupancy", [build.I] * 3
                               + [build.P] * 2)
    rc = fn(MODES[mode], KERNEL_OUT_DTYPES[out_dtype], head_dim,
            ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"quant_fwd_occupancy failed: CUDA error {rc}")
    return smem.value, blocks.value


def onepass_route(onepass: bool, dtype_name: str, causal: bool, window,
                  kv_len: int, kv_len_stored: int, q_len: int) -> bool:
    """Whether the int8 staircase serves the call: JAX's gate
    (``tpu_flash/ops/flash/quantized.py:592-604``), opt-in."""
    return (
        onepass
        and dtype_name == "int8"
        and causal
        and window is None
        and kv_len == kv_len_stored == q_len
        and q_len % ONEPASS_STAIR == 0
        and ONEPASS_STAIR < q_len <= 2048
    )


def flash_attention_quantized(
    inputs,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    onepass: bool = False,
    out_dtype=torch.bfloat16,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    fp8_native: Optional[bool] = None,
) -> torch.Tensor:
    """Fused attention over quantized Q/K/V (int8 or fp8-e4m3 payloads).

    ``inputs`` comes from :func:`quantize_attention_inputs` (or holds
    the same layouts). GQA: hkv divides hq. The stored lengths must be
    aligned: q_len a multiple of ``min(64, q_len)`` (itself a multiple of
    8) and the stored kv length of 128; for a ragged true kv length pad
    k/v and pass it as ``kv_len`` (the tail is masked). Causal is aligned
    at position 0 of q and kv. ``fp8_native`` (fp8 only): renormalise P
    rows into e4m3 for P V; None resolves with
    :func:`~tpu_flash_torch.ops.decode.paged.fp8_native_default`.
    ``onepass``: opt in to the int8 staircase where JAX's gate admits
    the call (:func:`onepass_route`).
    """
    qv, qs, kv_, ks, vv, vs, dtype_name = inputs
    if fp8_native is None:
        fp8_native = dtype_name == "fp8" and fp8_native_default(qv.device)
    batch, num_q_heads, q_len, head_dim = qv.shape
    _, num_kv_heads, kv_len_stored, _ = kv_.shape
    if kv_len is None:
        kv_len = kv_len_stored
    if not 0 < kv_len <= kv_len_stored:
        raise ValueError(
            f"kv_len ({kv_len}) must be in (0, stored kv length "
            f"{kv_len_stored}]"
        )
    if num_q_heads % num_kv_heads:
        raise ValueError(
            f"num_q_heads ({num_q_heads}) must be a multiple of "
            f"num_kv_heads ({num_kv_heads})"
        )
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= q_len:
            window = None  # covers every position: plain causal
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if alibi is not None and not causal:
        raise ValueError("alibi requires causal=True")
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    block_q = min(QUANT_BLOCK_Q, q_len)
    block_kv_major = min(QUANT_BLOCK_KV, kv_len_stored)
    if (q_len % block_q or kv_len_stored % block_kv_major or block_q % 8
            or block_kv_major % NUM_LANES):
        raise ValueError(
            "quantized path needs q_len divisible by a sublane-aligned "
            f"block_q and the stored kv length by a lane-aligned "
            f"block_kv_major; got q_len={q_len}, stored kv="
            f"{kv_len_stored}, blocks=({block_q}, {block_kv_major})"
        )
    onepass = onepass_route(onepass, dtype_name, causal, window, kv_len,
                            kv_len_stored, q_len)
    return quant_fwd(
        qv, qs, kv_, ks, vv, vs, dtype_name=dtype_name, causal=causal,
        sm_scale=float(sm_scale), kv_len=kv_len,
        window=None if window is None else int(window),
        softcap=None if softcap is None else float(softcap), sinks=sinks,
        alibi=alibi, fp8_native=bool(fp8_native) and dtype_name == "fp8",
        onepass=onepass, out_dtype=out_dtype,
    )
