"""Dataclass configuration for the kernels, the model and the engine.

Field names and defaults follow ``tpu_flash.core.config`` so a config
written for the JAX engine reads the same here. The TPU ``BlockSizes``
(VMEM tiles, grid geometries) has no meaning on the GPU; :class:`TileSizes`
holds only what the two CUDA kernels of this package read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _check_pos(name: str, v: int) -> None:
    if v <= 0:
        raise ValueError(f"{name} must be positive, got {v}")


# Paged prefill's fixed block rules (the JAX kernel's constants): history
# tokens per block before the cut to a divisor of the history pages, and
# the most query rows (q heads x block_q) one block stacks.
PREFILL_HIST_TOKENS = 2048
PREFILL_ROWS_CAP = 1024


@dataclasses.dataclass(frozen=True)
class TileSizes:
    """Tiles of the CUDA kernels (and of their plain versions, which walk
    the same tiles so that their roundings agree).

    ``block_kv``: the flash forward's kv rows per online-softmax step
    (``csrc/flash_fwd.cu`` compiles ``BK = 128``; the plain version must
    step the same tiles). ``decode_block_tokens`` /
    ``decode_block_tokens_f32``: the paged decode's kv extent per
    online-softmax step for bf16/int8 and for f32 pages -- the extent
    the JAX kernel uses (``tpu_flash/ops/decode/paged.py:926-934``),
    because int8 decode quantizes each P row over that whole extent.

    Paged prefill walks history blocks of ``PREFILL_HIST_TOKENS // ps``
    pages (cut until it divides the history pages) and then the chunk in
    blocks of ``prefill_block_q`` rows, capped so that ``q_per_kv *
    block_q <= PREFILL_ROWS_CAP`` -- the JAX kernel's defaults
    (``tpu_flash/ops/flash/paged_prefill.py:419-441``). P is rounded
    after each block's running max, so both versions step these blocks.
    ``ragged_block_kv``: the ragged prefill's kv tile over the dense
    [history | chunk] buffer (the JAX kernel takes its tile from a TPU
    tuning table; the port fixes one for kernel and plain version).
    """

    block_kv: int = 128
    decode_block_tokens: int = 4096
    decode_block_tokens_f32: int = 2048
    prefill_block_q: int = 512
    ragged_block_kv: int = 128

    def prefill_blocks(self, q_per_kv: int, q_len: int, page_size: int,
                       hist_pages: int, block_q: Optional[int] = None,
                       pages_per_block: Optional[int] = None):
        """(block_q, history pages per block) of paged prefill for one
        call's shapes, as the JAX kernel picks them; a given ``block_q``
        or ``pages_per_block`` is honored as the JAX kernel honors it."""
        if pages_per_block is None:
            pages_per_block = PREFILL_HIST_TOKENS // page_size
        ppb = max(1, min(pages_per_block, hist_pages))
        while hist_pages % ppb:
            ppb -= 1
        if block_q is None:
            block_q = self.prefill_block_q
            if q_per_kv * block_q > PREFILL_ROWS_CAP:
                block_q = max(8, PREFILL_ROWS_CAP // q_per_kv)
        return min(block_q, -(-q_len // 8) * 8), ppb

    def __post_init__(self):
        for f in dataclasses.fields(self):
            _check_pos(f.name, getattr(self, f.name))


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Shapes of one attention operator: GQA head counts, head dim,
    causality and the softmax scale (None -> 1/sqrt(head_dim))."""

    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    sm_scale: Optional[float] = None

    def __post_init__(self):
        _check_pos("num_q_heads", self.num_q_heads)
        _check_pos("num_kv_heads", self.num_kv_heads)
        _check_pos("head_dim", self.head_dim)
        if self.num_q_heads % self.num_kv_heads != 0:
            raise ValueError(
                f"num_q_heads ({self.num_q_heads}) must be a multiple of "
                f"num_kv_heads ({self.num_kv_heads})"
            )

    @property
    def q_per_kv(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    @property
    def scale(self) -> float:
        if self.sm_scale is not None:
            return self.sm_scale
        return float(self.head_dim) ** -0.5


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Paged KV-cache layout: page size, capacity, and quantization.

    The fields are the JAX package's. ``None`` means "auto": the engine
    fills such fields in at construction with the JAX package's layout
    policy (``tpu_flash_torch.utils.tuning.resolve_cache_config``).

    ``recent_window`` (quantized caches): the last W tokens of every slot
    are also kept in an exact bf16 ring; decode attends pages for
    [0, L - W) and the ring for the rest.
    """

    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    max_pages_per_seq: Optional[int] = None
    kv_dtype: str = "bfloat16"
    scale_dtype: str = "float32"
    recent_window: Optional[int] = None

    def __post_init__(self):
        if self.page_size is not None:
            _check_pos("page_size", self.page_size)
        if self.num_pages is not None:
            _check_pos("num_pages", self.num_pages)
        if self.max_pages_per_seq is not None:
            _check_pos("max_pages_per_seq", self.max_pages_per_seq)
        if self.kv_dtype not in (
            "bfloat16", "float32", "int8", "int4", "int4g32", "k8v4",
            "fp8"
        ):
            raise ValueError(f"unsupported kv_dtype {self.kv_dtype!r}")
        if self.recent_window is not None and self.recent_window < 0:
            raise ValueError(
                f"recent_window must be >= 0, got {self.recent_window}"
            )

    @property
    def quantized(self) -> bool:
        return self.kv_dtype in (
            "int8", "int4", "int4g32", "k8v4", "fp8"
        )

    @property
    def resolved(self) -> bool:
        """True when every auto (None) layout knob has a concrete value."""
        return not (
            self.page_size is None
            or self.num_pages is None
            or self.max_pages_per_seq is None
            or self.recent_window is None
        )

    @property
    def max_context(self) -> int:
        if self.page_size is None or self.max_pages_per_seq is None:
            raise ValueError(
                "CacheConfig has unresolved auto fields (resolve them with "
                "utils.tuning.resolve_cache_config)"
            )
        return self.page_size * self.max_pages_per_seq


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Continuous-batching engine configuration (the JAX fields).

    ``paged_prefill``: "auto" and True attend chunk history straight from
    the pages (the paged-prefill kernel), False gathers it dense first;
    the int4g32/k8v4 tiers always gather, as in JAX. ``fused_mixed_step``:
    "auto" folds a step's decode slots into its prefill dispatch when
    ``0 < live decode slots <= prefill chunks``, True whenever both exist,
    False never. ``health`` is an ``engine.health.HealthConfig`` or None
    (defaults).
    """

    max_batch_size: int = 8
    max_seq_len: int = 8192
    prefill_chunk: int = 512
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    health: Optional[object] = None
    prefix_cache: bool = True
    paged_prefill: object = "auto"  # "auto" | True | False
    admission: str = "reserve"  # "reserve" | "optimistic"
    preemption: str = "recompute"  # "recompute" | "swap"
    fused_mixed_step: object = "auto"  # "auto" | True | False
    max_decode_burst: int = 8

    def __post_init__(self):
        _check_pos("max_batch_size", self.max_batch_size)
        _check_pos("max_seq_len", self.max_seq_len)
        _check_pos("prefill_chunk", self.prefill_chunk)
        _check_pos("max_decode_burst", self.max_decode_burst)
        if self.paged_prefill not in ("auto", True, False):
            raise ValueError(
                f"paged_prefill must be 'auto', True or False, got "
                f"{self.paged_prefill!r}"
            )
        if self.admission not in ("reserve", "optimistic"):
            raise ValueError(
                f"admission must be 'reserve' or 'optimistic', got "
                f"{self.admission!r}"
            )
        if self.preemption not in ("recompute", "swap"):
            raise ValueError(
                f"preemption must be 'recompute' or 'swap', got "
                f"{self.preemption!r}"
            )
        if self.fused_mixed_step not in ("auto", True, False):
            raise ValueError(
                f"fused_mixed_step must be 'auto', True or False, got "
                f"{self.fused_mixed_step!r}"
            )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Named device-mesh layout (``parallel/mesh.py::build_mesh``).

    ``data``  -- batch / request parallelism (DP)
    ``model`` -- attention-head tensor parallelism (TP, GQA-aware)
    ``seq``   -- sequence/context parallelism (ring and Ulysses attention)
    """

    data: int = 1
    model: int = 1
    seq: int = 1

    def __post_init__(self):
        _check_pos("data", self.data)
        _check_pos("model", self.model)
        _check_pos("seq", self.seq)

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.seq
