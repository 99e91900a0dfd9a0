"""Online-softmax merge algebra on partial-attention states.

The port of ``tpu_flash/core/softmax.py``: an associative, commutative
operator on (acc, m, l) states with an unnormalized accumulator, finalized
once; ``merge_over_axis`` is the same merge across the ranks of a
``torch.distributed`` group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SoftmaxState(NamedTuple):
    """Partial attention over a subset S of KV positions.

    acc: sum_{j in S} exp(s_j - m) * v_j     [..., head_dim]  (unnormalized)
    m:   max_{j in S} s_j                    [..., 1]
    l:   sum_{j in S} exp(s_j - m)           [..., 1]
    """

    acc: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def empty_state(shape, head_dim, dtype=torch.float32, device=None):
    """Identity element: attention over the empty KV set."""
    return SoftmaxState(
        acc=torch.zeros((*shape, head_dim), dtype=dtype, device=device),
        m=torch.full((*shape, 1), -torch.inf, dtype=dtype, device=device),
        l=torch.zeros((*shape, 1), dtype=dtype, device=device),
    )


def _rescale(m_side, m):
    # Guard the identity element: exp(-inf - -inf) would be NaN.
    return torch.where(
        m_side == -torch.inf, torch.zeros_like(m), torch.exp(m_side - m)
    )


def merge_softmax_states(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Combine partial attention over disjoint KV sets. Associative."""
    m = torch.maximum(a.m, b.m)
    alpha = _rescale(a.m, m)
    beta = _rescale(b.m, m)
    both_empty = torch.isneginf(a.m) & torch.isneginf(b.m)
    return SoftmaxState(
        acc=a.acc * alpha + b.acc * beta,
        m=torch.where(both_empty, torch.full_like(m, -torch.inf), m),
        l=a.l * alpha + b.l * beta,
    )


def state_from_block(scores: torch.Tensor, v: torch.Tensor) -> SoftmaxState:
    """A state from one block of (already masked, scaled) f32 scores
    [..., q, kv] and values [..., kv, head_dim]."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(
        m == -torch.inf, torch.zeros_like(scores), torch.exp(scores - m)
    )
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("...qk,...kd->...qd", p, v.float())
    return SoftmaxState(acc=acc, m=m, l=l)


def finalize(state: SoftmaxState, dtype=None) -> torch.Tensor:
    """Deferred normalization: O = acc / l (safe where l == 0)."""
    l_inv = torch.where(
        state.l == 0.0, torch.ones_like(state.l), 1.0 / state.l
    )
    out = state.acc * l_inv
    return out.to(dtype) if dtype is not None else out


def finalize_with_sinks(
    state: SoftmaxState, sinks: torch.Tensor, dtype=None
) -> torch.Tensor:
    """Finalize with per-head sink logits folded into the denominator
    exactly once. ``state`` m/l are [batch, heads, q, 1]; sinks [heads]."""
    sk = sinks.float()[None, :, None, None]
    m2 = torch.maximum(state.m, sk)
    scale = _rescale(state.m, m2)
    l_tot = state.l * scale + torch.exp(sk - m2)
    out = state.acc * (scale / l_tot)
    return out.to(dtype) if dtype is not None else out


def merge_over_axis(state: SoftmaxState, group=None) -> SoftmaxState:
    """Merge partial states across the ranks of a process group (JAX's
    ``merge_over_axis`` over a mesh axis): the global max by an
    all-reduce MAX, then SUM of the rescaled (acc, l). A rank whose m is
    -inf (attention over no key) adds nothing. Every rank gets the
    merged state."""
    import torch.distributed as dist

    m = state.m.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    alpha = _rescale(state.m, m)
    acc = state.acc * alpha
    l = state.l * alpha
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    return SoftmaxState(acc=acc, m=m, l=l)
