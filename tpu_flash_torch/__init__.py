"""tpu_flash_torch: the PyTorch + CUDA port of ``tpu_flash``.

The same serving slice as the JAX package -- a Llama-style model served
through a paged bf16/f32/int8 KV cache by a continuous-batching engine --
with every attention kernel on that path written by hand in CUDA C++ for
Hopper (``csrc/``). Module names follow ``tpu_flash`` so each counterpart
is easy to find. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper takes its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
