"""A single-device training step over the port's model.

The counterpart of ``tpu_flash/parallel/train.py::make_train_step`` on a
one-device mesh: ``model.loss_fn`` through the flash kernels' autograd
(``ops/flash/api.py``), then plain SGD with the JAX package's update, or
one step of a torch optimizer. The parameters stay the model's plain
dict of tensors; the step updates them in place (JAX returns new
arrays), so the same dict can be served by an engine between steps.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from tpu_flash_torch.models.transformer import FlashTransformer, Params


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
    *,
    learning_rate: float = 1e-3,
    optimizer: Optional[torch.optim.Optimizer] = None,
    max_grad_norm: Optional[float] = None,
) -> Callable:
    """Build ``train_step(params, tokens, segment_ids=None) -> loss``.

    One step: the mean next-token loss of ``tokens`` [b, s] (packed
    documents with ``segment_ids``), its gradients, an optional global
    norm clip to ``max_grad_norm``, and the update, in place. Without
    ``optimizer`` the update is plain SGD with the JAX package's
    arithmetic, ``w <- (w - lr * g.float()).to(w.dtype)``; with one (built
    over :func:`param_leaves` of the same dict) it is ``optimizer.step()``.
    Returns the loss (f32 scalar, detached). Leaves keep ``requires_grad``
    and their ``.grad`` after the step.
    """

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
