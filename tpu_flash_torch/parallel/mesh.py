"""Device-mesh construction over the process group.

The port of ``tpu_flash/parallel/mesh.py``. Axes (``core/config.py``
``MeshConfig``), outermost first:

  data  -- batch / request parallelism (tolerates crossing hosts)
  seq   -- sequence / context parallelism (ring and Ulysses attention)
  model -- attention-head tensor parallelism (innermost: the most
           latency-sensitive traffic, kept on the fastest links)

A JAX ``Mesh`` plus ``shard_map`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the same three named
dimensions over one process per device: a ``shard_map`` body is a plain
function each rank runs on its own shard, ``axis_index(name)`` is
``mesh.get_local_rank(name)`` and a ``psum`` over an axis is an
``all_reduce`` on ``mesh.get_group(name)``. Start the process group first
(``parallel/multihost.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_flash_torch.core.config import MeshConfig

AXIS_ORDER = ("data", "seq", "model")
# ranks -> (the default group it was made under, the group).
_PLANE_GROUPS: dict = {}


def build_mesh(config: MeshConfig, device_type: Optional[str] = None
               ) -> DeviceMesh:
    """A ``DeviceMesh`` of shape (data, seq, model) over the first
    ``config.num_devices`` ranks of the process group; ``device_type``
    "cuda" unless the caller asks for "cpu". Raises when the group holds
    fewer ranks than the mesh needs (a process with no group holds one),
    or when no group was started for a mesh that needs one."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if config.num_devices > world:
        raise ValueError(
            f"mesh needs {config.num_devices} devices; {world} present"
        )
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs a process group: call "
            "parallel.initialize_multihost() first (under torchrun, or with "
            "explicit arguments)"
        )
    shape = (config.data, config.seq, config.model)
    ranks = torch.arange(config.num_devices).reshape(shape)
    return DeviceMesh(device_type or "cuda", ranks,
                      mesh_dim_names=AXIS_ORDER)


def mesh_config_for(num_devices: int) -> MeshConfig:
    """JAX's default factorization of n devices: a ring-friendly seq axis
    of 2 when n allows, then data 2 when the rest allows, model the
    rest."""
    n = num_devices
    seq = 2 if n % 2 == 0 and n >= 4 else 1
    rem = n // seq
    data = 2 if rem % 2 == 0 and rem >= 4 else 1
    return MeshConfig(data=data, model=rem // data, seq=seq)


def mesh_for(num_devices: int, device_type: Optional[str] = None
             ) -> DeviceMesh:
    """``build_mesh`` of :func:`mesh_config_for`'s layout."""
    return build_mesh(mesh_config_for(num_devices), device_type)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of a named mesh dimension (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def plane_group(mesh: DeviceMesh, axes) -> Optional[dist.ProcessGroup]:
    """The process group of the ranks that share this rank's indices on
    every mesh axis outside ``axes`` (for ("data", "seq"): its data x seq
    plane; for ``AXIS_ORDER``: the whole mesh), or None when that is this
    rank alone. Only the members make it (``use_local_synchronization``),
    so a mesh over the first ranks of a larger world needs nothing of the
    others; a set of ranks gets one group per default group, made at
    first use and kept."""
    coord = mesh.get_coordinate()
    idx = tuple(slice(None) if name in axes else c
                for name, c in zip(mesh.mesh_dim_names, coord))
    ranks = tuple(mesh.mesh[idx].flatten().tolist())
    if len(ranks) == 1:
        return None
    world = dist.group.WORLD
    if len(ranks) == dist.get_world_size():
        return world
    made = _PLANE_GROUPS.get(ranks)
    if made is None or made[0] is not world:
        made = _PLANE_GROUPS[ranks] = (world, dist.new_group(
            list(ranks), use_local_synchronization=True))
    return made[1]


def take_shard(x: torch.Tensor, n: int, index: int, dim: int,
               what: str = "dimension") -> torch.Tensor:
    """Block ``index`` of ``n`` equal blocks of ``x`` along ``dim``,
    contiguous; raises when ``n`` does not divide the dimension."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(
            f"{what} ({size}) must be divisible by the mesh axis size ({n})"
        )
    step = size // n
    return x.narrow(dim, index * step, step).contiguous()


def shard_head_slice(vals: Optional[torch.Tensor], num_local: int,
                     mesh: Optional[DeviceMesh], axis: str):
    """Slice a per-head tensor (sink logits or ALiBi slopes,
    [num_heads_global]) to this rank's contiguous head range on
    ``axis``; a tensor already of ``num_local`` heads stays as it is."""
    if vals is None or vals.shape[0] == num_local:
        return vals
    idx = mesh.get_local_rank(axis)
    return vals[idx * num_local:(idx + 1) * num_local]
