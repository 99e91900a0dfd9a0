"""Head-sharded tensor parallelism and data parallelism for attention.

The port of ``tpu_flash/parallel/sharded.py``. Query heads shard over the
``model`` axis with no communication during attention (GQA keeps each kv
head with its query group on one rank); batch shards over ``data``. The
paged decode kernel shards its pages over kv heads on ``model``: each
rank owns the pages (and scales) of its heads.

Each factory returns a function of the global tensors, as JAX's jitted
``shard_map`` does, that every rank calls with the same arguments: it
checks that the mesh axes divide them, cuts out this rank's shard and
returns this rank's block of the output. Its ``local`` attribute is the
per-shard body alone, for a caller that holds only its shard.
"""

from __future__ import annotations

from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from tpu_flash_torch.ops.decode.paged import paged_attention
from tpu_flash_torch.ops.flash.api import flash_attention
from tpu_flash_torch.ops.quant import QuantizedTensor
from tpu_flash_torch.parallel.mesh import axis_size, take_shard


def sharded_flash_attention(
    mesh: DeviceMesh,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """fn(q, k, v) with batch on ``data`` and heads on ``model``; q
    [b, hq, sq, d], k/v [b, hkv, skv, d] global. num_q_heads and
    num_kv_heads must both divide the model-axis size (GQA groups stay on
    one rank). Returns this rank's [b / data, hq / model, sq, d]."""
    n_data = axis_size(mesh, data_axis)
    n_model = axis_size(mesh, model_axis)

    def local(q, k, v):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset)

    def fn(q, k, v):
        di = mesh.get_local_rank(data_axis)
        mi = mesh.get_local_rank(model_axis)

        def cut(x, what):
            x = take_shard(x, n_data, di, 0, f"batch of {what}")
            return take_shard(x, n_model, mi, 1, f"heads of {what}")

        return local(cut(q, "q"), cut(k, "k"), cut(v, "v"))

    fn.local = local
    return fn


def _kv_head_shard(pages, n: int, index: int):
    """This rank's kv heads of a page tensor (dense or ``QuantizedTensor``:
    payload and scales alike, kv heads leading)."""
    if isinstance(pages, QuantizedTensor):
        return pages._replace(
            values=take_shard(pages.values, n, index, 0, "kv heads"),
            scales=take_shard(pages.scales, n, index, 0, "kv heads"),
        )
    return take_shard(pages, n, index, 0, "kv heads")


def sharded_paged_attention(
    mesh: DeviceMesh,
    *,
    sm_scale: Optional[float] = None,
    pages_per_compute_block: int = 4,
    model_axis: str = "model",
):
    """Paged GQA decode sharded over kv heads: q's heads, the pages and
    their scales split on ``model``; lengths and page tables replicated.
    fn(q [b, hq, d], k_pages, v_pages [hkv, pages, page_size, d] or
    ``QuantizedTensor``, lengths, page_indices) -> this rank's
    [b, hq / model, d]."""
    n = axis_size(mesh, model_axis)

    def local(q, k_pages, v_pages, lengths, page_indices):
        return paged_attention(
            q, k_pages, v_pages, lengths, page_indices, sm_scale=sm_scale,
            pages_per_compute_block=pages_per_compute_block,
        )

    def fn(q, k_pages, v_pages, lengths, page_indices):
        mi = mesh.get_local_rank(model_axis)
        return local(take_shard(q, n, mi, 1, "q heads"),
                     _kv_head_shard(k_pages, n, mi),
                     _kv_head_shard(v_pages, n, mi), lengths, page_indices)

    fn.local = local
    return fn
