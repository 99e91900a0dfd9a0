"""Token sampling: greedy, temperature, top-k, top-p (nucleus), min-p.

The port of ``tpu_flash/engine/sampling.py``. Per-slot parameters ride as
tensors, so one call serves any mix of greedy and sampled rows. Random
draws come from the caller's ``torch.Generator`` (Gumbel-max over the
filtered logits, as ``jax.random.categorical`` does); the generators of
the two packages differ, so tests compare ``filtered_logits`` and the
greedy path, not draws. Speculative rejection sampling comes with the
speculative-decoding slice.

Semantics: temperature <= 0 -> greedy (argmax, other filters ignored);
top_k > 0 keeps the k highest logits; top_p < 1 keeps the smallest
probability-sorted prefix with mass >= top_p (top-1 always kept); min_p
drops tokens below min_p * max_prob; filters intersect.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration."""

    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0  # 0 -> no top-k filter
    top_p: float = 1.0  # 1 -> no nucleus filter
    min_p: float = 0.0  # 0 -> no min-p filter

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")


GREEDY = SamplingParams()


def filtered_logits(
    logits: torch.Tensor,  # [batch, vocab] f32
    temperature: torch.Tensor,  # [batch] f32
    top_k: torch.Tensor,  # [batch] int (0 = off)
    top_p: torch.Tensor,  # [batch] f32
    min_p: Optional[torch.Tensor] = None,  # [batch] f32 (0 = off)
) -> torch.Tensor:
    """The temperature-scaled, filtered logits each row samples from;
    greedy rows collapse to an exact one-hot (0 at the argmax, the f32
    minimum elsewhere)."""
    batch, vocab = logits.shape
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    sorted_scaled = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab)).long()
    kth = torch.gather(sorted_scaled, -1, (k - 1).clamp(0, vocab - 1)[:, None])
    keep_k = scaled >= kth
    probs_sorted = torch.softmax(sorted_scaled, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    stays = cum_before < top_p[:, None]
    num_keep = torch.clamp(stays.sum(dim=-1), min=1)
    pth = torch.gather(sorted_scaled, -1, (num_keep - 1)[:, None])
    keep = keep_k & (scaled >= pth)
    if min_p is not None:
        max_prob = probs_sorted[:, :1]
        row_probs = torch.softmax(scaled, dim=-1)
        keep = keep & (row_probs >= min_p[:, None] * max_prob)
    neg = torch.finfo(scaled.dtype).min
    filtered = torch.where(keep, scaled, torch.full_like(scaled, neg))
    greedy_mask = (
        torch.arange(vocab, device=logits.device)[None]
        == logits.argmax(dim=-1, keepdim=True)
    )
    greedy = torch.where(greedy_mask, torch.zeros_like(scaled),
                         torch.full_like(scaled, neg))
    return torch.where(temperature[:, None] <= 0.0, greedy, filtered)


def sample_tokens(
    logits: torch.Tensor,  # [batch, vocab] f32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [batch] f32
    top_k: torch.Tensor,  # [batch] int
    top_p: torch.Tensor,  # [batch] f32
    min_p: Optional[torch.Tensor] = None,  # [batch] f32
) -> torch.Tensor:
    """Per-row sampling; returns [batch] int64 token ids. Greedy rows take
    the argmax exactly (callers whose rows are all greedy may call
    ``argmax`` alone and skip the filters)."""
    greedy = logits.argmax(dim=-1)
    filtered = filtered_logits(logits, temperature, top_k, top_p, min_p)
    u = torch.rand(filtered.shape, generator=generator,
                   device=filtered.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    sampled = (filtered - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
