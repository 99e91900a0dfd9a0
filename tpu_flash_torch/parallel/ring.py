"""Ring attention: sequence-parallel exact attention around the ``seq`` axis.

The port of ``tpu_flash/parallel/ring.py``, differentiable in q, k, v
and the sink logits. K/V blocks rotate around the ranks of the ``seq``
group (``dist.batch_isend_irecv``: an ``isend`` to the next rank and an
``irecv`` from the previous one, started before the block in hand is
computed, so the transfer overlaps the flash kernel), while every rank
runs the flash forward on the block in front of it; partial results merge
through the online-softmax algebra (``core/softmax.py``).

The gradient is JAX's, where ``ppermute`` transposes to the reverse
rotation: each rotation is a :class:`_Rotate` step whose backward sends
the received block's gradient to the previous rank and takes the sent
block's from the next one, and every block state is the flash kernel's
differentiable (o, lse) (``FlashAttentionFn``, the backward kernel with
the lse cotangent), merged by plain torch ops. Every rank takes part in
every backward exchange: a rank whose last received block goes unused
(a causal ring's source ahead of it, or past the window) ties that block
to its output with a zero gradient (:class:`_Tie`), since autograd never
runs backward for an unused output and the ring would wait on it.

A block's partial state comes from the kernel's (o, lse) residuals: a
normalized block output o with logsumexp lse is exactly the state
(acc=o, m=lse, l=1), so the kernel needs no change for distribution.

Blocks decompose by the rank distance d = my - src (equal blocks of
``blk`` tokens, :func:`block_kind`): with ``causal``, d = 0 is the
diagonal (causal), a source ahead of this rank is empty, a block wholly
inside the window is dense, one straddling the window's lower edge is
banded (causal at q_offset = d * blk so the window lands on absolute
positions) and one wholly below it empty. ALiBi's bias splits into an
in-block part and a per-(head, distance) constant: the dense blocks run
causal at q_offset = blk (every key visible) and shift their m by
slope * blk * (1 - d), as the JAX ring's shared dense branch does. Sink
logits join once, at the final normalization.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_flash_torch.core.softmax import (
    SoftmaxState,
    empty_state,
    finalize,
    finalize_with_sinks,
    merge_softmax_states,
)
from tpu_flash_torch.ops.flash.api import flash_attention
from tpu_flash_torch.parallel.mesh import (
    axis_size,
    shard_head_slice,
    take_shard,
)


def block_kind(distance: int, blk_len: int, causal: bool,
               window: Optional[int]) -> str:
    """"dense", "diag", "band" or "empty": how the q block of rank my
    attends the kv block of rank my - ``distance`` (JAX's ``_kind_for``;
    a negative distance is a source ahead of this rank)."""
    if not causal:
        return "dense"
    if distance < 0:
        return "empty"
    if distance == 0:
        return "diag"
    if window is None or window >= distance * blk_len + blk_len:
        return "dense"
    if window <= distance * blk_len - blk_len + 1:
        return "empty"
    return "band"


def _state(q, k, v, **kw) -> SoftmaxState:
    o, lse = flash_attention(q, k, v, save_residuals=True, **kw)
    m = lse[..., None]
    return SoftmaxState(acc=o.float(), m=m, l=torch.ones_like(m))


def ring_block_state(
    q_blk: torch.Tensor,
    k_src: torch.Tensor,
    v_src: torch.Tensor,
    *,
    distance: int,
    n_ring: int,
    causal: bool,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> SoftmaxState:
    """The partial state of one ring step: the q block of rank my over
    the kv block of rank my - ``distance`` (mod ``n_ring`` for a
    non-causal ring), from the flash forward's (o, lse). Sink-free:
    sinks join at :func:`finalize_with_sinks`."""
    if not -n_ring < distance < n_ring:
        raise ValueError(f"distance {distance} outside a ring of {n_ring}")
    blk_len = q_blk.shape[2]
    kind = block_kind(distance, blk_len, causal, window)
    kw = dict(sm_scale=sm_scale, softcap=softcap)
    if kind == "empty":
        return empty_state(q_blk.shape[:3], q_blk.shape[3],
                           device=q_blk.device)
    if kind == "diag":
        return _state(q_blk, k_src, v_src, causal=True, window=window,
                      alibi=alibi, **kw)
    if kind == "band":
        return _state(q_blk, k_src, v_src, causal=True, window=window,
                      q_offset=distance * blk_len, alibi=alibi, **kw)
    if alibi is None:
        return _state(q_blk, k_src, v_src, causal=False, **kw)
    st = _state(q_blk, k_src, v_src, causal=True, q_offset=blk_len,
                alibi=alibi, **kw)
    shift = alibi.float()[None, :, None, None] * (
        float(blk_len) * (1.0 - distance))
    return st._replace(m=st.m + shift)


def _merged(q_blk, my, n_ring, sources, *, causal, sinks, **kw):
    """(out, unused): rank ``my``'s output block -- its q block's state
    over each (src, k, v) of ``sources`` in ring order, merged, then
    normalized (sinks folded in once) -- and the last source's (k, v)
    when its block went unused (kind "empty"), else None."""
    state = empty_state(q_blk.shape[:3], q_blk.shape[3], device=q_blk.device)
    unused = None
    for src, k_src, v_src in sources:
        distance = my - src if causal else 0
        state = merge_softmax_states(state, ring_block_state(
            q_blk, k_src, v_src, distance=distance, n_ring=n_ring,
            causal=causal, **kw))
        kind = block_kind(distance, q_blk.shape[2], causal, kw.get("window"))
        unused = (k_src, v_src) if kind == "empty" else None
    if sinks is not None:
        return finalize_with_sinks(state, sinks, q_blk.dtype), unused
    return finalize(state, q_blk.dtype), unused


def _exchange(send, to, frm, group):
    """Send each tensor of ``send`` to global rank ``to`` and receive a
    tensor of the same shape from ``frm`` into a new one; returns (the
    received tensors, the pending requests)."""
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for s, r in zip(send, recv):
        ops += [dist.P2POp(dist.isend, s, to, group),
                dist.P2POp(dist.irecv, r, frm, group)]
    return recv, dist.batch_isend_irecv(ops)


class _Rotate(torch.autograd.Function):
    """One ring step of a K/V block pair: forward sends (k, v) to the
    next rank and receives the previous rank's pair. The transfer is
    started, not waited on: its requests go into ``pending``, which the
    caller waits on before it reads the received pair. Backward is the
    reverse rotation (JAX's transpose of ``ppermute``): the received
    pair's gradients go to the previous rank, the sent pair's come from
    the next."""

    @staticmethod
    def forward(ctx, k, v, group, nxt, prv, pending):
        (k_in, v_in), reqs = _exchange((k, v), nxt, prv, group)
        pending.extend(reqs)
        ctx.ring = (group, nxt, prv)
        return k_in, v_in

    @staticmethod
    def backward(ctx, dk, dv):
        group, nxt, prv = ctx.ring
        (dk_out, dv_out), reqs = _exchange(
            (dk.contiguous(), dv.contiguous()), prv, nxt, group)
        for r in reqs:
            r.wait()
        return dk_out, dv_out, None, None, None, None


class _Tie(torch.autograd.Function):
    """``out`` unchanged; in backward, zero gradients for the ``unused``
    tensors, so that the ring steps that made them run their backward
    exchange on this rank too."""

    @staticmethod
    def forward(ctx, out, *unused):
        ctx.unused = [(t.shape, t.dtype, t.device) for t in unused]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.unused))


def _rotating(k_blk, v_blk, group, my: int, n_ring: int):
    """Yield (src, k, v) around the ring: this rank's own block first,
    then each block received from the previous rank through a
    :class:`_Rotate` step. The next block's transfer starts before the
    block in hand is yielded, so it overlaps the caller's work on it."""
    nxt = dist.get_global_rank(group, (my + 1) % n_ring)
    prv = dist.get_global_rank(group, (my - 1) % n_ring)
    k_cur, v_cur = k_blk.contiguous(), v_blk.contiguous()
    for step in range(n_ring):
        pending = []
        if step + 1 < n_ring:
            k_nxt, v_nxt = _Rotate.apply(k_cur, v_cur, group, nxt, prv,
                                         pending)
        yield (my - step) % n_ring, k_cur, v_cur
        for r in pending:
            r.wait()
        if pending:
            k_cur, v_cur = k_nxt, v_nxt


def _check_options(causal, window, alibi):
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if alibi is not None and not causal:
        raise ValueError("alibi requires causal=True")


def ring_attention_local(
    q_blk: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    *,
    group=None,
    causal: bool,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-rank ring attention body: q/k/v [b, h, blk, d] are this rank's
    sequence blocks, the ring the ranks of ``group`` in group-rank order
    (None: no ring, one rank). ``sinks`` ([local q heads]) fold into the
    denominator once, at the end. Returns this rank's output block,
    differentiable in q, k, v and ``sinks``; every rank of the ring must
    run the backward (the gradients of k and v travel the ring back)."""
    _check_options(causal, window, alibi)
    if sm_scale is None:
        sm_scale = q_blk.shape[-1] ** -0.5
    n_ring = 1 if group is None else dist.get_world_size(group)
    if n_ring == 1:
        return flash_attention(q_blk, k_blk, v_blk, causal=causal,
                               sm_scale=sm_scale, window=window,
                               softcap=softcap, sinks=sinks, alibi=alibi)
    my = dist.get_rank(group)
    out, unused = _merged(
        q_blk, my, n_ring, _rotating(k_blk, v_blk, group, my, n_ring),
        causal=causal, sinks=sinks, window=window, softcap=softcap,
        alibi=alibi, sm_scale=sm_scale)
    if unused is not None and torch.is_grad_enabled():
        out = _Tie.apply(out, *unused)
    return out


def ring_attention_schedule(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_ring: int,
    *,
    causal: bool,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ring's whole schedule in one process: for each rank r of an
    ``n_ring`` ring, its q block over the sources r, r - 1, ... in ring
    order, merged as :func:`ring_attention_local` merges them (so each
    block is that function's bit for bit); the blocks concatenated.
    Global [b, h, s, d] in and out."""
    _check_options(causal, window, alibi)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qs, ks, vs = ([take_shard(x, n_ring, r, 2, "sequence")
                   for r in range(n_ring)] for x in (q, k, v))
    outs = []
    for my in range(n_ring):
        order = [(my - step) % n_ring for step in range(n_ring)]
        outs.append(_merged(
            qs[my], my, n_ring,
            [(src, ks[src], vs[src]) for src in order],
            causal=causal, sinks=sinks, window=window, softcap=softcap,
            alibi=alibi, sm_scale=sm_scale)[0])
    return torch.cat(outs, dim=2)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    seq_axis: str = "seq",
    data_axis: str = "data",
    model_axis: Optional[str] = "model",
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention with q/k/v sharded along the sequence: every rank
    passes the same global [batch, heads, seq, head_dim] tensors (seq
    divisible by the ``seq`` axis size) and gets its own block of the
    output, [batch / data, heads / model, seq / seq-axis, head_dim]:
    batch over ``data``, heads over ``model`` when that axis is larger
    than 1 (ring x heads), the sequence over the ring. ALiBi slopes slice
    to the rank's heads; ``sinks`` pass as given, as in JAX."""
    n_ring = axis_size(mesh, seq_axis)
    n_data = axis_size(mesh, data_axis)
    n_model = axis_size(mesh, model_axis) if model_axis else 1

    def cut(x, what):
        x = take_shard(x, n_data, mesh.get_local_rank(data_axis), 0,
                       f"batch of {what}")
        if n_model > 1:
            x = take_shard(x, n_model, mesh.get_local_rank(model_axis), 1,
                           f"heads of {what}")
        return take_shard(x, n_ring, mesh.get_local_rank(seq_axis), 2,
                          f"sequence of {what}")

    q_blk, k_blk, v_blk = cut(q, "q"), cut(k, "k"), cut(v, "v")
    al = alibi
    if al is not None and n_model > 1:
        al = shard_head_slice(al, al.shape[0] // n_model, mesh, model_axis)
    return ring_attention_local(
        q_blk, k_blk, v_blk, group=mesh.get_group(seq_axis), causal=causal,
        sm_scale=sm_scale, window=window, softcap=softcap, sinks=sinks,
        alibi=al,
    )
