"""Training steps over the port's model: one device, or DP x TP x SP.

The port of ``tpu_flash/parallel/train.py::make_train_step``. On one
device (no mesh): ``model.loss_fn`` through the flash kernels' autograd
(``ops/flash/api.py``), then plain SGD with the JAX package's update, or
one step of a torch optimizer. The parameters stay the model's plain
dict of tensors; the step updates them in place (JAX returns new
arrays), so the same dict can be served by an engine between steps.

On a mesh (``parallel/mesh.py``; one process per device, every rank runs
the same step on its own shard, JAX's ``shard_map`` body):

  data  -- batch sharded; gradients summed over "data".
  model -- tensor parallelism: QKV and MLP weights column-sharded, their
           output projections row-sharded (``models.shard_params``'
           layout); the partial products summed over "model" after the
           out- and down-projections.
  seq   -- sequence parallelism: tokens sharded along the sequence,
           exact attention over the whole sequence by ring attention
           (``parallel/ring.py``, differentiable); the next-token target
           at a chunk boundary comes from the next seq rank.

The TP boundary ops are JAX's ``_enter_tp`` / ``_exit_tp`` as autograd
functions: with them activations stay replicated over "model" and every
replicated parameter's local gradient is already its whole gradient, so
gradients are summed over data x seq only.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_flash_torch.models.transformer import (
    FlashTransformer,
    Params,
    _rms_norm,
    shard_params as model_shard_params,
)
from tpu_flash_torch.parallel.mesh import (
    axis_size,
    plane_group,
    shard_head_slice,
    take_shard,
)
from tpu_flash_torch.parallel.ring import ring_attention_local


def _named(params: Params):
    """(name, tensor) of every parameter in a fixed order: embed, each
    layer's weights by name, final_norm, lm_head."""
    out = [("embed", params["embed"])]
    for i, layer in enumerate(params["layers"]):
        out += [(f"layers.{i}.{n}", layer[n]) for n in sorted(layer)]
    return out + [("final_norm", params["final_norm"]),
                  ("lm_head", params["lm_head"])]


def param_names(params: Params) -> List[str]:
    """The names of :func:`param_leaves`, in its order."""
    return [n for n, _ in _named(params)]


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of the parameter dict in :func:`param_names` order,
    each made a leaf that requires grad (in place). Build a torch
    optimizer over this list."""
    leaves = [w for _, w in _named(params)]
    for w in leaves:
        w.requires_grad_(True)
    return leaves


def loss_and_grads(model: FlashTransformer, params: Params,
                   tokens: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None):
    """(loss, gradients): ``model.loss_fn`` of ``tokens`` (f32 scalar,
    detached) and its gradient for each of :func:`param_leaves`, in that
    order. Each gradient is also left in its leaf's ``.grad``."""
    leaves = param_leaves(params)
    for w in leaves:
        w.grad = None
    with torch.enable_grad():
        loss = model.loss_fn(params, tokens, segment_ids)
        loss.backward()
    return loss.detach(), [w.grad for w in leaves]


def make_train_step(
    model: FlashTransformer,
    mesh: Optional[DeviceMesh] = None,
    *,
    learning_rate: float = 1e-3,
    optimizer=None,
    max_grad_norm: Optional[float] = None,
    make_optimizer: Optional[Callable] = None,
):
    """Build a training step.

    With a ``mesh``: ``(shard_params, build)``, JAX's sharded step (see
    :func:`_mesh_train_step`). It takes ``make_optimizer``, a factory
    that ``build`` calls over each rank's shard, and no ``optimizer`` or
    ``max_grad_norm`` (JAX's sharded step has no norm clip). Without a
    mesh: ``train_step(params, tokens, segment_ids=None) -> loss`` on
    one device.

    One step on one device: the mean next-token loss of ``tokens`` [b, s] (packed
    documents with ``segment_ids``), its gradients, an optional global
    norm clip to ``max_grad_norm``, and the update, in place. Without
    ``optimizer`` the update is plain SGD with the JAX package's
    arithmetic, ``w <- (w - lr * g.float()).to(w.dtype)``; with one (built
    over :func:`param_leaves` of the same dict) it is ``optimizer.step()``.
    Returns the loss (f32 scalar, detached). Leaves keep ``requires_grad``
    and their ``.grad`` after the step.
    """
    if mesh is not None:
        if optimizer is not None or max_grad_norm is not None:
            raise ValueError(
                "the mesh step takes make_optimizer (a factory over the "
                "shard) and no optimizer or max_grad_norm (JAX's sharded "
                "step has no norm clip)")
        return _mesh_train_step(model, mesh, learning_rate=learning_rate,
                                make_optimizer=make_optimizer)
    if make_optimizer is not None:
        raise ValueError("make_optimizer is the mesh step's; on one device "
                         "pass optimizer=, built over param_leaves(params)")

    def train_step(params: Params, tokens: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None):
        loss, _ = loss_and_grads(model, params, tokens, segment_ids)
        leaves = param_leaves(params)
        with torch.no_grad():
            if max_grad_norm is not None:
                torch.nn.utils.clip_grad_norm_(leaves, max_grad_norm)
            if optimizer is None:
                for w in leaves:
                    w.copy_((w.float() - learning_rate * w.grad.float())
                            .to(w.dtype))
            else:
                optimizer.step()
        return loss

    return train_step


# -- DP x TP x SP on a mesh ----------------------------------------------------


class _EnterTP(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the model group
    (the replicated activation fans into per-shard branches)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ExitTP(torch.autograd.Function):
    """Sum over the model group forward (the partial products of a
    row-sharded projection); identity backward (the gradient is already
    replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _next_seq_first(tok: torch.Tensor, group, n_seq: int) -> torch.Tensor:
    """The first token column of the next seq rank's chunk (JAX's
    ``ppermute`` of ``tokens[:, :1]`` from rank i to i - 1, cyclic): a
    send to the previous rank and a receive from the next."""
    first = tok[:, :1].contiguous()
    if n_seq == 1:
        return first
    my = dist.get_rank(group)
    got = torch.empty_like(first)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, first,
                   dist.get_global_rank(group, (my - 1) % n_seq), group),
        dist.P2POp(dist.irecv, got,
                   dist.get_global_rank(group, (my + 1) % n_seq), group),
    ])
    for r in reqs:
        r.wait()
    return got


def _mesh_train_step(
    model: FlashTransformer,
    mesh: DeviceMesh,
    *,
    learning_rate: float = 1e-3,
    make_optimizer: Optional[Callable] = None,
):
    """``(shard_params, build)`` for the mesh, JAX's contract.

    ``shard_params(params)``: this rank's shard of a global params dict
    (``models.shard_params`` over "model"), copied onto the model's
    device; the caller's dict is not touched. ``build(local)`` returns ``step(local, tokens) -> loss``:
    ``tokens`` [batch, seq] are the global batch, the same on every rank
    (batch divisible by "data", seq by "seq"); the rank trains on its
    block, and the loss (f32 scalar) is the global mean, the same on
    every rank. The shard is updated in place: plain SGD at
    ``learning_rate`` with JAX's update, ``(w.float() - lr *
    g.float()).to(w.dtype)``, or, with ``make_optimizer`` (a callable that
    builds a ``torch.optim`` optimizer over a list of tensors, such as
    ``functools.partial(torch.optim.AdamW, lr=3e-3)``: the stand-in for
    an optax transformation), one step of the optimizer that ``build``
    made over :func:`param_leaves` of the shard, ``step.optimizer``. The
    update is elementwise, so on shards it is the update on whole
    tensors. After the step each leaf's ``.grad`` holds the gradient of
    the global mean loss."""
    cfg = model.config
    n_data = axis_size(mesh, "data")
    n_seq = axis_size(mesh, "seq")
    n_model = axis_size(mesh, "model")
    if cfg.num_q_heads % n_model or cfg.num_kv_heads % n_model:
        raise ValueError(
            f"model axis ({n_model}) must divide q heads "
            f"({cfg.num_q_heads}) and kv heads ({cfg.num_kv_heads})"
        )
    model_group = mesh.get_group("model") if n_model > 1 else None
    seq_group = mesh.get_group("seq") if n_seq > 1 else None
    batch_group = plane_group(mesh, ("data", "seq"))
    seq_idx = mesh.get_local_rank("seq")
    alibi = shard_head_slice(model.alibi_for(),
                             cfg.num_q_heads // n_model, mesh, "model")

    def enter(x):
        return x if model_group is None else _EnterTP.apply(x, model_group)

    def exit_(x):
        return x if model_group is None else _ExitTP.apply(x, model_group)

    def local_loss(p: Params, tok: torch.Tensor):
        """(loss sum, target count) of this rank's (data, seq) block.

        The layer loop repeats ``FlashTransformer.forward``'s rather than
        calling it: the ring takes each layer's window and sinks, which
        ``forward``'s ``attention_fn(q, k, v)`` is not given, and the TP
        boundaries here are autograd functions where serving's
        ``tp_reduce`` all-reduces in place with no backward. Folding both
        into ``forward`` would make it branch on whether it trains on a
        mesh; a change to the model body is made in both."""
        b, s_local = tok.shape
        pos0 = seq_idx * s_local
        positions = pos0 + torch.arange(s_local, device=tok.device)
        x = p["embed"][tok].to(model.dtype)
        for li, layer in enumerate(p["layers"]):
            xn = enter(_rms_norm(x, layer["attn_norm"], cfg.rms_eps))
            q, k, v = model._qkv(layer, xn, positions, li)
            attn = ring_attention_local(
                q, k, v, group=seq_group, causal=True,
                window=cfg.layer_window(li), softcap=cfg.attn_softcap,
                sinks=layer.get("sinks"), alibi=alibi)
            h, d = attn.shape[1], attn.shape[3]
            attn = attn.transpose(1, 2).reshape(b, s_local, h * d)
            x = x + exit_(attn @ layer["wo"])
            xn = enter(_rms_norm(x, layer["mlp_norm"], cfg.rms_eps))
            x = x + exit_(model._mlp(layer, xn, li))
        x = _rms_norm(x, p["final_norm"], cfg.rms_eps)
        logits = (x @ p["lm_head"]).float()
        targets = torch.cat(
            [tok[:, 1:], _next_seq_first(tok, seq_group, n_seq)], dim=1)
        # The global last position has no target.
        valid = (positions < n_seq * s_local - 1).float()
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            targets.reshape(-1).long(), reduction="none",
        ).reshape(b, s_local)
        return (nll * valid[None]).sum(), valid.sum() * b

    def block(tokens: torch.Tensor) -> torch.Tensor:
        tok = take_shard(tokens, n_data, mesh.get_local_rank("data"), 0,
                         "batch")
        return take_shard(tok, n_seq, seq_idx, 1, "sequence")

    def shard_params(params: Params) -> Params:
        local = model_shard_params(params, mesh.get_local_rank("model"),
                                   n_model)

        def leaf(w):
            return w.detach().to(model.device, copy=True)

        return {
            **{k: leaf(w) for k, w in local.items() if k != "layers"},
            "layers": [{n: leaf(w) for n, w in layer.items()}
                       for layer in local["layers"]],
        }

    def build(local: Params):
        opt = (None if make_optimizer is None
               else make_optimizer(param_leaves(local)))

        def step(p: Params, tokens: torch.Tensor) -> torch.Tensor:
            leaves = param_leaves(p)
            for w in leaves:
                w.grad = None
            with torch.enable_grad():
                loss_sum, count = local_loss(p, block(tokens))
                loss_sum.backward()
            totals = torch.stack([loss_sum.detach(), count])
            if batch_group is not None:
                dist.all_reduce(totals, group=batch_group)
            count = totals[1]
            with torch.no_grad():
                for w in leaves:
                    if batch_group is not None:
                        dist.all_reduce(w.grad, group=batch_group)
                    # Gradients of the loss sum, normalized by the global
                    # target count: the mean loss's (f32, as JAX's).
                    g = w.grad.float() / count
                    if opt is None:
                        w.copy_((w.float() - learning_rate * g).to(w.dtype))
                    w.grad = g.to(w.dtype)
                if opt is not None:
                    opt.step()
            return totals[0] / count

        step.optimizer = opt
        return step

    return shard_params, build
