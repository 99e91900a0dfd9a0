"""Multi-device serving and training on ``torch.distributed``: the mesh,
process-group start-up, head-sharded, ring and Ulysses attention (both
differentiable), and the training step on one device or DP x TP x SP
over a mesh."""

from tpu_flash_torch.parallel.mesh import build_mesh
from tpu_flash_torch.parallel.multihost import initialize_multihost
from tpu_flash_torch.parallel.ring import ring_attention
from tpu_flash_torch.parallel.sharded import (
    sharded_flash_attention,
    sharded_paged_attention,
)
from tpu_flash_torch.parallel.train import (
    loss_and_grads,
    make_train_step,
    param_leaves,
    param_names,
)
from tpu_flash_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "build_mesh", "initialize_multihost", "ring_attention",
    "sharded_flash_attention", "sharded_paged_attention",
    "ulysses_attention", "loss_and_grads", "make_train_step",
    "param_leaves", "param_names",
]
