"""Flash-attention backward: the ``flash_bwd`` CUDA kernels (dK/dV and
dQ) and their plain PyTorch version.

The port of ``tpu_flash/ops/flash/backward.py::flash_attention_backward``
without the TPU padding: the Pallas dKV and dQ kernels (K8,
``_flash_bwd_dkv_kernel`` / ``_flash_bwd_dq_kernel``) and their
single-pass pair (K9, ``_bwd_dq_onepass_kernel`` /
``_bwd_dkv_onepass_kernel``, a TPU geometry of the same two
computations) become two CUDA kernels in ``csrc/flash_bwd.cu``. P is
recomputed from the forward's lse, with the JAX kernel's arithmetic:

* s = q k^T in f32 from the inputs' own values, times ``sm_scale`` as an
  f32 number (not the q-dtype-rounded scale the forward applies);
* softcap ``c tanh(s / c)`` (its chain factor ``1 - tanh^2`` kept),
  then ALiBi, then p = exp(s - lse), zero wherever masked;
* di = rowsum(o do) - dlse (a torch op on both paths, as the JAX
  package computes it outside its kernels);
* dv += p^T do and dp = do v^T in f32; ds = p (dp - di) dcap scale;
* dk += round(ds)^T q and dq += round(ds) k, the rounding to the input
  dtype; sums in f32, cast to the input dtype at the end.

The bf16 kernels also round P to bf16 for the dV product (tensor cores
take bf16 operands), as the TPU kernel's single bf16 MXU pass does at
``Precision.DEFAULT`` (``tpu_flash/ops/flash/backward.py:38-43,184-188``);
interpret mode does not, so the plain version rounds it only when asked
(``round_p=True``). The f32 kernels take every product in three TF32
passes on the tensor cores (the counterpart of the TPU's
``Precision.HIGHEST``) and round nothing. Where dp - di cancels they take
dp again as the plain version's sequential f32 sum (``p_and_ds`` in
``csrc/flash_bwd.cu``): at P > 1/2; at P > 1/64 with |dp - di| under 1/8
of max(|dp|, |di|); and on a masked step, at any P with |dp - di| under
1/64 of it.

dk/dv come back per q head ([b, hq, skv, d]); the caller sums each GQA
group. :func:`flash_bwd` takes the plain version for CPU tensors only; a
CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.flash.forward import (
    KERNEL_DTYPES,
    segment_ids_for_kernel,
)

BWD_BLOCK_KV = 64  # kv rows per tile of csrc/flash_bwd.cu
KERNEL_HEAD_DIMS = (64, 128, 256)  # what csrc/flash_bwd.cu instantiates


def softmax_di(o: torch.Tensor, do: torch.Tensor,
               dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """di = rowsum(o * do) - dlse in f32 [b, hq, sq]: the term the
    softmax backward subtracts (an lse cotangent folds in here, since
    dL/ds = p (dp - di + dlse))."""
    di = (o.float() * do.float()).sum(-1)
    if dlse is not None:
        di = di - dlse.float()
    return di


def recompute_p(qf, kt, lse, t0, *, causal, sm_scale, q_offset=0,
                window=None, softcap=None, alibi=None, q_seg=None,
                kv_seg=None):
    """(p, dcap) of one kv tile with the backward's arithmetic:
    qf [b, hkv, g, sq, d] and kt [b, hkv, tk, d] f32 (kv rows from
    position ``t0``), lse [b, hkv, g, sq, 1]; p = exp(s - lse), zero where
    masked; dcap the softcap chain factor (None without softcap). The JAX
    kernel's ``_recompute_p`` (``tpu_flash/ops/flash/backward.py:46``)."""
    b, hkv, g, sq, _ = qf.shape
    dev = qf.device
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * torch.tensor(
        sm_scale, dtype=torch.float32)
    dcap = None
    if softcap is not None:
        t = torch.tanh(s * torch.tensor(1.0 / softcap, dtype=torch.float32))
        s = softcap * t
        dcap = 1.0 - t * t
    qpos = (torch.arange(sq, device=dev) + q_offset)[:, None]
    kpos = torch.arange(t0, t0 + kt.shape[2], device=dev)[None, :]
    valid = torch.ones((sq, kt.shape[2]), dtype=torch.bool, device=dev)
    if causal:
        valid = kpos <= qpos
        if window is not None:
            valid = valid & (kpos > qpos - window)
    if alibi is not None:
        s = s + alibi.float().reshape(1, hkv, g, 1, 1) * (kpos - qpos).float()
    if q_seg is not None:
        same = q_seg[:, :, None] == kv_seg[:, None, t0:t0 + kt.shape[2]]
        valid = (valid & same)[:, None, None]
    p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
    return p, dcap


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
    part: Optional[str] = None,
    round_p: bool = False,
):
    """Plain PyTorch version of the ``flash_bwd`` kernels (arguments as
    :func:`flash_bwd`), stepping their kv tiles. ``part`` "dkv" or "dq"
    gives the plain version of that kernel alone, with None for the other
    kernel's outputs. ``round_p`` rounds P to the input dtype in the dV
    product only (dS keeps the f32 P): the bf16 kernels' arithmetic."""
    if part not in (None, "dkv", "dq"):
        raise ValueError(f"flash_bwd_plain: part {part!r}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    dt = q.dtype
    dev = q.device
    scale = torch.tensor(sm_scale, dtype=torch.float32)
    qf = q.float().reshape(b, hkv, g, sq, d)
    dof = do.float().reshape(b, hkv, g, sq, d)
    lse_c = lse.float().reshape(b, hkv, g, sq, 1)
    di_c = softmax_di(o, do, dlse).reshape(b, hkv, g, sq, 1)
    dq = torch.zeros((b, hkv, g, sq, d), device=dev)
    dk = torch.zeros((b, hkv, g, skv, d), device=dev)
    dv = torch.zeros((b, hkv, g, skv, d), device=dev)
    for t0 in range(0, kv_len, BWD_BLOCK_KV):
        t1 = min(t0 + BWD_BLOCK_KV, kv_len)
        kt = k[:, :, t0:t1].float()
        vt = v[:, :, t0:t1].float()
        p, dcap = recompute_p(qf, kt, lse_c, t0, causal=causal,
                              sm_scale=sm_scale, q_offset=q_offset,
                              window=window, softcap=softcap, alibi=alibi,
                              q_seg=q_seg, kv_seg=kv_seg)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vt)
        ds = p * (dp - di_c)
        if dcap is not None:
            ds = ds * dcap
        ds = ds * scale
        ds_r = ds.to(dt).float()
        if part != "dq":
            p_dv = p.to(dt).float() if round_p else p
            dv[:, :, :, t0:t1] = torch.einsum("bhgqk,bhgqd->bhgkd", p_dv,
                                              dof)
            dk[:, :, :, t0:t1] = torch.einsum("bhgqk,bhgqd->bhgkd", ds_r,
                                              qf)
        if part != "dkv":
            dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds_r, kt)
    dq = None if part == "dkv" else dq.to(dt).reshape(b, hq, sq, d)
    if part == "dq":
        return dq, None, None
    return (dq, dk.to(k.dtype).reshape(b, hq, skv, d),
            dv.to(v.dtype).reshape(b, hq, skv, d))


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
):
    """Attention backward: (dq [b, hq, sq, d], dk and dv per q head
    [b, hq, skv, d]) from q [b, hq, sq, d], k/v [b, hkv, skv, d], the
    forward's o and lse [b, hq, sq] f32, and do = dL/do. ``dlse`` is an
    lse cotangent (the forward's ``save_residuals`` output). The forward
    options (causal with ``q_offset``, ``kv_len``, ``window``,
    ``softcap``, ``alibi``, segment ids) are those of :func:`flash_fwd`;
    sink logits need no term here (their gradient is the caller's
    closed form). CPU tensors take :func:`flash_bwd_plain`; CUDA tensors
    launch the kernels.
    """
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              kv_len=kv_len, window=window, softcap=softcap, alibi=alibi,
              q_seg=q_seg, kv_seg=kv_seg, dlse=dlse)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, do, lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    return _flash_bwd_cuda(q, k, v, o, do, lse, **kw)


def _flash_bwd_cuda(q, k, v, o, do, lse, *, causal, sm_scale, q_offset,
                    kv_len, window, softcap, alibi, q_seg, kv_seg, dlse):
    if q.dtype not in KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(
            f"flash_bwd kernels take f32 or bf16 q/k/v/o/do of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}/{o.dtype}/{do.dtype}"
        )
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_bwd kernels are built for head_dim {KERNEL_HEAD_DIMS}, "
            f"got {d}"
        )
    for t in (k, v, o, do, lse, alibi, q_seg, kv_seg, dlse):
        if t is not None and t.device != q.device:
            raise ValueError("flash_bwd: all tensors must share q's device")
    q, k, v, do = (build.aligned(t) for t in (q, k, v, do))
    lse = lse.float().contiguous()
    di = softmax_di(o, do, dlse).contiguous()
    alibi = None if alibi is None else alibi.float().contiguous()
    q_seg, kv_seg = segment_ids_for_kernel(q_seg, kv_seg)
    dq = torch.empty_like(q)
    dk = torch.empty((b, hq, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    tail = (KERNEL_DTYPES[q.dtype], b, hq, hkv, sq, skv,
            skv if kv_len is None else int(kv_len), d, float(sm_scale),
            int(bool(causal)), int(q_offset),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            0.0 if softcap is None else float(1.0 / softcap),
            build.stream_handle(q))
    head = [build.ptr(t) for t in (q, k, v, do, lse, di)]
    opts = [build.ptr(t) for t in (alibi, q_seg, kv_seg)]
    build.FLASH_BWD_DKV.launch(*head, build.ptr(dk), build.ptr(dv), *opts,
                               *tail)
    build.FLASH_BWD_DQ.launch(*head, build.ptr(dq), None, *opts, *tail)
    return dq, dk, dv
