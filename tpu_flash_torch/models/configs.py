"""Model configurations: the JAX package's presets, copied.

A copy of ``tpu_flash/models/configs.py`` (this package imports nothing
from ``tpu_flash``): Llama-2-7B and Llama-3-8B attention geometries, the
other published presets, and a tiny config for tests.
"""

from __future__ import annotations

import dataclasses

from tpu_flash_torch.core.config import AttentionConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Sliding-window attention (Mistral convention: each position attends to
    # the previous `sliding_window` positions including itself) — None for
    # full causal attention. Applied in every layer unless
    # ``sliding_window_pattern`` is set.
    sliding_window: "int | None" = None
    # Gemma-2/3-style alternation: every ``pattern``-th layer (layers with
    # (i + 1) % pattern == 0) is GLOBAL full attention; the rest use the
    # sliding window. pattern=2 alternates local/global (Gemma-2);
    # pattern=6 is Gemma-3's 5-local:1-global.
    sliding_window_pattern: "int | None" = None

    def layer_window(self, layer_idx: int) -> "int | None":
        """The sliding window for one layer under the configured pattern."""
        if self.sliding_window is None:
            return None
        if self.sliding_window_pattern is None:
            return self.sliding_window
        if (layer_idx + 1) % self.sliding_window_pattern == 0:
            return None  # global layer
        return self.sliding_window
    # Gemma-2-style attention logit soft-capping (tanh), None to disable.
    attn_softcap: "float | None" = None
    # StreamingLLM / gpt-oss-style learnable per-head attention-sink
    # logits (a valueless softmax column); adds a per-layer "sinks"
    # [num_q_heads] parameter.
    attn_sinks: bool = False
    # RoPE context extension: None (off), "linear" (position
    # interpolation), "ntk" (NTK-aware theta rescale), "yarn"
    # (per-frequency interpolation ramp + attention temperature), or
    # "llama3" (Llama-3.1's wavelength-threshold interpolation — no
    # temperature).
    rope_scaling: "str | None" = None
    rope_scaling_factor: float = 1.0
    # Original training context, used by the yarn/llama3 ramps to decide
    # which frequency bands to interpolate.
    rope_orig_context: int = 4096
    # llama3-scheme band thresholds (HF low_freq_factor/high_freq_factor):
    # wavelengths longer than orig_ctx/low_freq_factor fully interpolate;
    # shorter than orig_ctx/high_freq_factor stay unscaled.
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    # Softmax scale denominator override (Gemma-2's query_pre_attn_scalar):
    # scores use 1/sqrt(query_pre_attn_scalar) instead of 1/sqrt(head_dim).
    # Folded into q post-rope, so kernels keep their default scale.
    query_pre_attn_scalar: "float | None" = None
    # ALiBi positional scheme (BLOOM/MPT): per-head linear distance
    # penalties replace rotary embeddings entirely (rope is skipped).
    # Slopes are the standard fixed set (core.reference.alibi_slopes).
    attn_alibi: bool = False

    @property
    def attention(self) -> AttentionConfig:
        return AttentionConfig(
            num_q_heads=self.num_q_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            causal=True,
        )

    @property
    def q_per_kv(self) -> int:
        return self.num_q_heads // self.num_kv_heads


LLAMA2_7B = ModelConfig(
    name="llama2-7b",
    vocab_size=32000,
    hidden_size=4096,
    num_layers=32,
    num_q_heads=32,
    num_kv_heads=32,
    head_dim=128,
    intermediate_size=11008,
)

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    vocab_size=128256,
    hidden_size=4096,
    num_layers=32,
    num_q_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    rope_theta=500000.0,
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b",
    vocab_size=32000,
    hidden_size=4096,
    num_layers=32,
    num_q_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    sliding_window=4096,
)

# Tiny config for CI: same structure, trivial sizes.
TINY_TEST = ModelConfig(
    name="tiny-test",
    vocab_size=256,
    hidden_size=64,
    num_layers=2,
    num_q_heads=4,
    num_kv_heads=2,
    head_dim=16,
    intermediate_size=128,
    dtype="float32",
)


GEMMA2_9B = ModelConfig(
    name="gemma2-9b",
    vocab_size=256000,
    hidden_size=3584,
    num_layers=42,
    num_q_heads=16,
    num_kv_heads=8,
    head_dim=256,
    intermediate_size=14336,
    rms_eps=1e-6,
    # Gemma-2: local/global alternation, tanh logit soft-capping, and
    # query scaling by 1/sqrt(query_pre_attn_scalar).
    sliding_window=4096,
    sliding_window_pattern=2,
    attn_softcap=50.0,
    query_pre_attn_scalar=256.0,
)

QWEN2_7B = ModelConfig(
    name="qwen2-7b",
    vocab_size=152064,
    hidden_size=3584,
    num_layers=28,
    num_q_heads=28,
    num_kv_heads=4,
    head_dim=128,
    intermediate_size=18944,
    rms_eps=1e-6,
    rope_theta=1000000.0,
)

LLAMA31_8B = ModelConfig(
    name="llama3.1-8b",
    vocab_size=128256,
    hidden_size=4096,
    num_layers=32,
    num_q_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    rope_theta=500000.0,
    # Llama-3.1's 128K context: wavelength-threshold rope interpolation.
    rope_scaling="llama3",
    rope_scaling_factor=8.0,
    rope_orig_context=8192,
    rope_low_freq_factor=1.0,
    rope_high_freq_factor=4.0,
)

BLOOM_7B = ModelConfig(
    name="bloom-7b",
    vocab_size=250880,
    hidden_size=4096,
    num_layers=30,
    num_q_heads=32,
    num_kv_heads=32,
    head_dim=128,
    intermediate_size=16384,
    # BLOOM: ALiBi distance bias instead of rotary embeddings.
    attn_alibi=True,
)
