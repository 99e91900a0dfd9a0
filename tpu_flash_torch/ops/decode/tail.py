"""Exact recent-window tail attention, external-merge construction.

The port of ``tpu_flash/ops/decode/tail.py``: the plain oracle the fused
ring (``paged_attention(recent_k=..., recent_v=...)``) is tested against.
The ring holds the last W tokens of each slot in bf16; ring row j holds
position ``(L-1) - ((L-1-j) mod W)``. Decode attends the pages for
[0, quant_len) with ``return_state=True``, the ring here for
[quant_len, L), and merges the two softmax states once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE


def recent_tail_state(
    q: torch.Tensor,  # [batch, num_q_heads, head_dim] (unscaled)
    k_ring: torch.Tensor,  # [batch, num_kv_heads, W, head_dim] bf16
    v_ring: torch.Tensor,
    lengths: torch.Tensor,  # [batch] post-append context length L
    quant_len: torch.Tensor,  # [batch] tokens covered by the paged call
    *,
    sm_scale: float,
    softcap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax state (o, m, l) of q against ring positions [quant_len, L):
    o normalized in q.dtype, m/l [batch, num_q_heads] f32. The scaled q
    and P round to the ring dtype before their products, as the fused
    kernel's ring block does."""
    b, hq, d = q.shape
    hkv, w = k_ring.shape[1], k_ring.shape[2]
    g = hq // hkv
    qg = (q.reshape(b, hkv, g, d).float() * sm_scale).to(k_ring.dtype)
    s = torch.einsum("bhgd,bhwd->bhgw", qg.float(), k_ring.float())
    if softcap is not None:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    j = torch.arange(w, device=q.device)
    last = (lengths.to(q.device).long() - 1)[:, None]
    pos = last - torch.remainder(last - j, w)
    valid = (pos >= quant_len.to(q.device)[:, None]) & (pos >= 0)
    if alibi is not None:
        slopes = alibi.float().reshape(1, hkv, g, 1)
        s = s + slopes * (pos - last).float()[:, None, None, :]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum(
        "bhgw,bhwd->bhgd", p.to(v_ring.dtype).float(), v_ring.float()
    )
    o = o * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (
        o.reshape(b, hq, d).to(q.dtype),
        m[..., 0].reshape(b, hq),
        l[..., 0].reshape(b, hq),
    )


def merge_attention_states(
    o1: torch.Tensor,  # [batch, num_q_heads, head_dim] normalized
    m1: torch.Tensor,  # [batch, num_q_heads]
    l1: torch.Tensor,
    o2: torch.Tensor,
    m2: torch.Tensor,
    l2: torch.Tensor,
    *,
    part1_valid: Optional[torch.Tensor] = None,  # [batch]
    sinks: Optional[torch.Tensor] = None,  # [num_q_heads]
) -> torch.Tensor:
    """Merge two normalized attention parts by their softmax states,
    folding the sink logit exactly once; rows with ``part1_valid`` False
    drop part 1."""
    if part1_valid is not None:
        pv = part1_valid[:, None]
        m1 = torch.where(pv, m1, torch.full_like(m1, -torch.inf))
        l1 = torch.where(pv, l1, torch.zeros_like(l1))
    m = torch.maximum(m1, m2)
    if sinks is not None:
        m = torch.maximum(m, sinks.float()[None, :])

    def weight(mi, li):
        return torch.where(
            mi == -torch.inf, torch.zeros_like(mi), torch.exp(mi - m)
        ) * li

    a1, a2 = weight(m1, l1), weight(m2, l2)
    denom = a1 + a2
    if sinks is not None:
        denom = denom + torch.exp(sinks.float()[None, :] - m)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (
        o1.float() * (a1 / denom)[..., None]
        + o2.float() * (a2 / denom)[..., None]
    )
    return o.to(o1.dtype)
