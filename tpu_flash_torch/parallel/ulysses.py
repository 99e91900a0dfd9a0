"""Ulysses sequence parallelism: an all-to-all head scatter / sequence gather.

The port of ``tpu_flash/parallel/ulysses.py``, the alternative to ring
attention behind the same call shape. Where the ring keeps heads whole
and rotates K/V blocks, Ulysses keeps the *sequence* whole during
attention:

  1. all-to-all: inputs arrive sequence-sharded [b, h, s/n, d]; each rank
     trades its sequence block of (n-1)/n of the heads for every sequence
     block of its h/n heads -> [b, h/n, s, d];
  2. every rank runs the ordinary flash forward on its heads: full
     context, exact causal masking, no merge algebra;
  3. the inverse all-to-all restores sequence sharding.

``dist.all_to_all_single`` splits and concatenates along dim 0 of a
contiguous tensor, so each exchange makes the split axis leading: heads
[b, n, h/n, s/n, d] -> [n, b, h/n, s/n, d] on the way in (block j goes to
rank j; what arrives from rank j is sequence block j), and the sequence
blocks the same way on the way out. Both exchanges go through
``torch.distributed.nn.functional.all_to_all_single``, whose gradient is
the inverse all-to-all, so the attention is differentiable in q, k, v
and the sink logits (every rank must run the backward). Needs
num_q_heads and num_kv_heads divisible by n; holds O(s) K/V per rank
during attention (the ring holds O(s/n)).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.nn.functional import all_to_all_single

from tpu_flash_torch.ops.flash.api import flash_attention
from tpu_flash_torch.parallel.mesh import (
    axis_size,
    shard_head_slice,
    take_shard,
)


def _heads_to_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[b, h, s/n, d] sequence-sharded -> [b, h/n, s, d] head-sharded."""
    b, h, sl, d = x.shape
    send = x.reshape(b, n, h // n, sl, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = all_to_all_single(torch.empty_like(send), send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * sl, d)


def _seq_to_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[b, h/n, s, d] head-sharded -> [b, h, s/n, d] sequence-sharded."""
    b, hl, s, d = x.shape
    send = x.reshape(b, hl, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = all_to_all_single(torch.empty_like(send), send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * hl, s // n, d)


def ulysses_attention(
    mesh: DeviceMesh,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    seq_axis: str = "seq",
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
):
    """fn(q, k, v) over global [b, h, s, d] tensors that every rank of
    ``seq_axis`` passes alike (s and the head counts divisible by the axis
    size); returns this rank's sequence block [b, h, s/n, d]. Its
    ``local`` attribute takes this rank's sequence blocks instead.
    ``window`` and ``softcap`` apply as in the one-device kernel; the
    per-head ``sinks`` and ``alibi`` slice to the rank's head range."""
    n = axis_size(mesh, seq_axis)

    def local(q, k, v):
        if q.shape[1] % n or k.shape[1] % n:
            raise ValueError(
                f"ulysses needs num_q_heads ({q.shape[1]}) and "
                f"num_kv_heads ({k.shape[1]}) divisible by the seq axis "
                f"size ({n}); use ring attention for few-head models"
            )
        group = mesh.get_group(seq_axis)
        if n > 1:
            q, k, v = (_heads_to_seq(x, n, group) for x in (q, k, v))
        hq = q.shape[1]
        o = flash_attention(
            q, k, v, causal=causal, sm_scale=sm_scale, window=window,
            softcap=softcap,
            sinks=shard_head_slice(sinks, hq, mesh, seq_axis),
            alibi=shard_head_slice(alibi, hq, mesh, seq_axis),
        )
        return _seq_to_heads(o, n, group) if n > 1 else o

    def fn(q, k, v):
        r = mesh.get_local_rank(seq_axis)
        return local(*(take_shard(x, n, r, 2, "sequence") for x in (q, k, v)))

    fn.local = local
    return fn
