"""Training on one device (the mesh, tensor and sequence parallelism of
``tpu_flash/parallel`` wait for their own slice)."""

from tpu_flash_torch.parallel.train import (
    loss_and_grads,
    make_train_step,
    param_leaves,
    param_names,
)

__all__ = ["loss_and_grads", "make_train_step", "param_leaves",
           "param_names"]
