"""Process-group start-up for multi-process runs (one process per device).

The port of ``tpu_flash/parallel/multihost.py``. Where JAX stitches the
global device set with ``jax.distributed.initialize``, PyTorch joins the
processes into one ``torch.distributed`` process group: each process
(one per device, as ``torchrun --nproc-per-node N`` starts them) calls
:func:`initialize_multihost` before it builds a mesh
(``parallel/mesh.py``). The backend follows the device type the caller
asks for: NCCL on CUDA, gloo on the CPU. An NCCL failure raises; nothing
falls back to gloo.

Mesh axis placement for multi-host (``mesh.AXIS_ORDER``): ``data`` is
outermost, so that its traffic is the only one crossing hosts; ``seq``
and ``model`` stay within a host (NVLink).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: str = "cuda",
    init_method: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join this process to the process group, once.

    Without arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); a
    process with none of it and no coordinator is a single-process run,
    and the call returns False without doing anything. Explicit
    arguments take precedence: ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id``, or ``init_method`` (any
    ``torch.distributed`` URL, such as ``file://`` for tests) with
    ``num_processes`` and ``process_id``. On CUDA the process takes
    device ``LOCAL_RANK`` (0 without it) before the group starts.
    Returns True once a group exists (also when one was already
    initialised)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if coordinator_address is None:
            if "MASTER_ADDR" not in env and num_processes is None:
                logger.info("single-process run; no process group started")
                return False
            addr = env.get("MASTER_ADDR", "127.0.0.1")
            port = env.get("MASTER_PORT", "29500")
            coordinator_address = f"{addr}:{port}"
        init_method = f"tcp://{coordinator_address}"
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if device_type not in BACKENDS:
        raise ValueError(
            f"device_type must be one of {sorted(BACKENDS)}, got "
            f"{device_type!r}"
        )
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend=BACKENDS[device_type], init_method=init_method,
        world_size=world, rank=rank, **kw,
    )
    logger.info("process group up: rank %d of %d (%s)", rank, world,
                BACKENDS[device_type])
    return True
