"""Llama-style decoder transformer over the port's attention kernels.

The port of ``tpu_flash/models/transformer.py``: RMSNorm -> GQA flash
attention with rotary embeddings -> SwiGLU MLP, pre-norm residuals, an
untied LM head. Parameters are a plain dict of tensors with the JAX tree's
names and layouts (dense weights are [in, out]); :class:`FlashTransformer`
is a functional class over it. Prefill runs ``flash_attention``; the
engine's decode step uses ``decode_qkv`` and the paged decode kernel;
training takes ``loss_fn`` (the forward is differentiable end to end:
no in-place writes into saved tensors, no detaching casts). The
projection and MLP matmuls stay ``torch.matmul``, as the JAX package left
them to XLA.

Tensor parallelism (serving): with ``tp_group`` (a ``torch.distributed``
group, JAX's ``tp_axis``) each rank holds :func:`shard_params`' shard --
its attention heads and MLP hidden columns, the matching rows of ``wo``
and ``w_down`` -- head counts follow the weights' shapes, activations stay
replicated, and the two row-sharded projections all-reduce their partial
products (after the ``proj_hook``, so a LoRA delta joins the sum).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from tpu_flash_torch.core.reference import SegmentIds, alibi_slopes
from tpu_flash_torch.models.configs import ModelConfig
from tpu_flash_torch.ops.flash import flash_attention

Params = Dict[str, Any]


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def scaled_rope_frequencies(cfg, device=None):
    """(freqs, q_mult) for the config's RoPE scheme: "linear" (position
    interpolation), "ntk" (theta rescale), "yarn" (per-band ramp plus the
    t^2 attention temperature folded into q), "llama3" (Llama-3.1's
    wavelength thresholds). A Gemma-2 ``query_pre_attn_scalar`` folds
    into q_mult too."""
    base = rope_frequencies(cfg.head_dim, cfg.rope_theta, device)
    s = float(cfg.rope_scaling_factor)
    kind = cfg.rope_scaling
    q_mult = 1.0
    qpas = getattr(cfg, "query_pre_attn_scalar", None)
    if qpas is not None:
        q_mult *= math.sqrt(cfg.head_dim / qpas)
    if kind is None or s == 1.0:
        return base, q_mult
    if kind == "linear":
        return base / s, q_mult
    if kind == "ntk":
        d = cfg.head_dim
        return rope_frequencies(d, cfg.rope_theta * s ** (d / (d - 2)),
                                device), q_mult
    if kind == "yarn":
        wavelengths = 2.0 * math.pi / base
        rotations = cfg.rope_orig_context / wavelengths
        beta_fast, beta_slow = 32.0, 1.0
        ramp = torch.clamp(
            (rotations - beta_slow) / (beta_fast - beta_slow), 0.0, 1.0
        )
        freqs = (1.0 - ramp) * (base / s) + ramp * base
        t = 0.1 * math.log(s) + 1.0
        return freqs, q_mult * t * t
    if kind == "llama3":
        low_f = getattr(cfg, "rope_low_freq_factor", 1.0)
        high_f = getattr(cfg, "rope_high_freq_factor", 4.0)
        wavelengths = 2.0 * math.pi / base
        low_wl = cfg.rope_orig_context / low_f
        high_wl = cfg.rope_orig_context / high_f
        smooth = torch.clamp(
            (cfg.rope_orig_context / wavelengths - low_f) / (high_f - low_f),
            0.0, 1.0,
        )
        freqs = torch.where(
            wavelengths > low_wl,
            base / s,
            torch.where(
                wavelengths < high_wl,
                base,
                (1.0 - smooth) * base / s + smooth * base,
            ),
        )
        return freqs, q_mult
    raise ValueError(
        f"unknown rope_scaling {kind!r}; expected linear|ntk|yarn|llama3"
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs):
    """Rotary embedding, split-half convention. x [b, h, s, d];
    positions [b, s] or [s]."""
    dtype = x.dtype
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [b, s, d/2]
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def document_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Rope positions that restart at each document of a packed row:
    arange minus the start of each token's segment (a cummax over the
    boundary indices), [b, s]."""
    s = segment_ids.shape[1]
    ar = torch.arange(s, device=segment_ids.device)
    boundary = torch.ones_like(segment_ids, dtype=torch.bool)
    boundary[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    starts = torch.where(boundary, ar[None], torch.zeros_like(ar)[None])
    return ar[None] - torch.cummax(starts, dim=1).values


class FlashTransformer:
    """Stateless model: the parameters are an explicit dict of tensors.

    ``device``: where the rope tables (and ``init``'s weights) live;
    "cuda" unless the caller asks for "cpu"."""

    def __init__(self, config: ModelConfig, device=None):
        self.config = config
        self.device = torch.device(device if device is not None else "cuda")
        self.dtype = getattr(torch, config.dtype)
        self.freqs, self._q_mult = scaled_rope_frequencies(
            config, self.device
        )
        # ALiBi replaces rotary embeddings (BLOOM/MPT): fixed slopes.
        self._alibi = (
            alibi_slopes(config.num_q_heads, self.device)
            if config.attn_alibi else None
        )

    def alibi_for(self):
        """Per-head ALiBi slopes, or None when the model uses rope."""
        return self._alibi

    def init(self, generator: torch.Generator) -> Params:
        """Random weights: N(0, 1/fan_in) per dense weight (embedding
        N(0, 1)), ones for the norms, zero sink logits -- the JAX init's
        scaling rule, drawn from ``generator`` on its device."""
        cfg = self.config
        h, d = cfg.hidden_size, cfg.head_dim
        qd, kvd = cfg.num_q_heads * d, cfg.num_kv_heads * d
        dev = generator.device

        def dense(fan_in, shape):
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (w * fan_in ** -0.5).to(self.dtype)

        def ones(n):
            return torch.ones((n,), dtype=self.dtype, device=dev)

        layers = []
        for _ in range(cfg.num_layers):
            layer = {
                "attn_norm": ones(h),
                "wq": dense(h, (h, qd)),
                "wk": dense(h, (h, kvd)),
                "wv": dense(h, (h, kvd)),
                "wo": dense(qd, (qd, h)),
                "mlp_norm": ones(h),
                "w_gate": dense(h, (h, cfg.intermediate_size)),
                "w_up": dense(h, (h, cfg.intermediate_size)),
                "w_down": dense(cfg.intermediate_size,
                                (cfg.intermediate_size, h)),
            }
            if cfg.attn_sinks:
                layer["sinks"] = torch.zeros(
                    (cfg.num_q_heads,), dtype=torch.float32, device=dev
                )
            layers.append(layer)
        return {
            "embed": dense(1, (cfg.vocab_size, h)),
            "layers": layers,
            "final_norm": ones(h),
            "lm_head": dense(h, (h, cfg.vocab_size)),
        }

    def _scale_q(self, q: torch.Tensor) -> torch.Tensor:
        # YaRN temperature / query_pre_attn_scalar, multiplied in q's
        # dtype as JAX does with a weakly-typed scalar.
        if self._q_mult == 1.0:
            return q
        return q * torch.tensor(self._q_mult, dtype=q.dtype)

    def _qkv(self, layer: Params, x: torch.Tensor, positions, li: int = 0,
             proj_hook=None):
        """x [b, s, hidden] -> q [b, hq, s, d], k/v [b, hkv, s, d], with
        rope on q/k (head counts from the weight shapes).
        ``proj_hook(li, name, x, y)`` post-processes each projection's
        output (the multi-LoRA seam)."""
        b, s, _ = x.shape
        d = self.config.head_dim
        hq = layer["wq"].shape[1] // d
        hkv = layer["wk"].shape[1] // d

        def proj(name):
            y = x @ layer[name]
            return y if proj_hook is None else proj_hook(li, name, x, y)

        q = proj("wq").reshape(b, s, hq, d).transpose(1, 2)
        k = proj("wk").reshape(b, s, hkv, d).transpose(1, 2)
        v = proj("wv").reshape(b, s, hkv, d).transpose(1, 2)
        if self._alibi is not None:
            return q, k, v
        q = self._scale_q(apply_rope(q, positions, self.freqs))
        k = apply_rope(k, positions, self.freqs)
        return q, k, v

    def _mlp(self, layer: Params, x: torch.Tensor, li: int = 0,
             proj_hook=None, tp_group=None) -> torch.Tensor:
        def proj(name, inp):
            y = inp @ layer[name]
            return y if proj_hook is None else proj_hook(li, name, inp, y)

        gate = torch.nn.functional.silu(proj("w_gate", x).float())
        up = proj("w_up", x).float()
        # Row-sharded w_down: partial products sum over the TP group.
        return tp_reduce(proj("w_down", (gate * up).to(x.dtype)), tp_group)

    def forward(
        self,
        params: Params,
        tokens: torch.Tensor,  # [batch, seq] int
        *,
        q_offset: int = 0,
        return_kv: bool = False,
        kv_hook=None,
        positions: Optional[torch.Tensor] = None,
        attention_fn=None,
        segment_ids: Optional[torch.Tensor] = None,
        order_exact: bool = False,
        proj_hook=None,
        tp_group=None,
        alibi: Optional[torch.Tensor] = None,
    ):
        """Causal forward over a token block; logits [b, s, vocab] f32.

        ``kv_hook(layer_idx, k, v) -> (k_all, v_all)`` splices per-layer
        history in front of the block's K/V and captures the new K/V (the
        engine's chunked prefill); ``positions`` [s] or [b, s] overrides
        ``q_offset + arange`` for rope; ``attention_fn(q, k, v)`` replaces
        the causal flash call. ``segment_ids`` [b, s]: packed
        multi-document training -- attention is segment-masked and rope
        positions restart at each document (not with kv_hook or
        attention_fn). ``order_exact``: the flash call takes the forward
        kernel's order-exact entry (``flash_attention``).
        ``proj_hook(li, name, x, y)`` post-processes each of the seven
        projections' outputs (the multi-LoRA seam; None costs nothing).
        ``tp_group``: run tensor-parallel over that group on
        :func:`shard_params`' shard (serving); ``alibi`` then gives this
        rank's slopes (None: the model's own, every head). With
        ``return_kv`` also the per-layer (k, v)."""
        cfg = self.config
        if alibi is None:
            alibi = self._alibi
        seg_attn = None
        if segment_ids is not None:
            if kv_hook is not None or attention_fn is not None:
                raise ValueError(
                    "segment_ids (packed training) cannot combine with "
                    "kv_hook/attention_fn (serving seams)"
                )
            seg_attn = SegmentIds(segment_ids, segment_ids)
        x = params["embed"][tokens].to(self.dtype)
        if positions is None:
            if segment_ids is not None:
                positions = document_positions(segment_ids)
            else:
                positions = q_offset + torch.arange(
                    tokens.shape[1], device=tokens.device
                )
        kvs = []
        for li, layer in enumerate(params["layers"]):
            xn = _rms_norm(x, layer["attn_norm"], cfg.rms_eps)
            q, k, v = self._qkv(layer, xn, positions, li, proj_hook)
            if return_kv:
                kvs.append((k, v))
            if kv_hook is not None:
                k, v = kv_hook(li, k, v)
            if attention_fn is not None:
                attn = attention_fn(q, k, v)
            else:
                attn = flash_attention(
                    q, k, v, causal=True, q_offset=q_offset,
                    window=cfg.layer_window(li), softcap=cfg.attn_softcap,
                    segment_ids=seg_attn, sinks=layer.get("sinks"),
                    alibi=alibi,
                    order_exact=order_exact,
                )
            b, h, s, d = attn.shape
            attn = attn.transpose(1, 2).reshape(b, s, h * d)
            proj = attn @ layer["wo"]
            if proj_hook is not None:
                proj = proj_hook(li, "wo", attn, proj)
            x = x + tp_reduce(proj, tp_group)  # row-sharded wo
            xn = _rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
            x = x + self._mlp(layer, xn, li, proj_hook, tp_group)
        x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
        logits = (x @ params["lm_head"]).float()
        if return_kv:
            return logits, kvs
        return logits

    def loss_fn(self, params: Params, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean next-token cross-entropy over a batch [b, s] (the training
        objective). With ``segment_ids`` [b, s] (packed documents) only
        positions whose next token is in the same document count."""
        logits = self.forward(
            params, tokens[:, :-1],
            segment_ids=None if segment_ids is None else segment_ids[:, :-1],
        )
        targets = tokens[:, 1:]
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
            reduction="none",
        ).reshape(targets.shape)
        if segment_ids is None:
            return nll.mean()
        same = (segment_ids[:, :-1] == segment_ids[:, 1:]).to(nll.dtype)
        return (nll * same).sum() / same.sum().clamp(min=1.0)

    def decode_qkv(self, params: Params, layer_idx: int, x: torch.Tensor,
                   positions: torch.Tensor, proj_hook=None):
        """Decode-path projections: x [b, hidden] at positions [b] ->
        q [b, hq, d], k/v [b, hkv, d], rope applied (``proj_hook`` as in
        :meth:`forward`)."""
        layer = params["layers"][layer_idx]
        b = x.shape[0]
        d = self.config.head_dim
        hq = layer["wq"].shape[1] // d
        hkv = layer["wk"].shape[1] // d

        def proj(name):
            y = x @ layer[name]
            return (y if proj_hook is None
                    else proj_hook(layer_idx, name, x, y))

        q = proj("wq").reshape(b, hq, 1, d)
        k = proj("wk").reshape(b, hkv, 1, d)
        v = proj("wv").reshape(b, hkv, d)
        if self._alibi is not None:
            return q[:, :, 0], k[:, :, 0], v
        q = apply_rope(q, positions[:, None], self.freqs)[:, :, 0]
        k = apply_rope(k, positions[:, None], self.freqs)[:, :, 0]
        return self._scale_q(q), k, v


def tp_reduce(partial: torch.Tensor, tp_group) -> torch.Tensor:
    """Sum a row-sharded projection's partial products over the TP group
    (JAX's ``psum`` over ``tp_axis``), in place; unchanged without a
    group."""
    if tp_group is not None:
        dist.all_reduce(partial, group=tp_group)
    return partial


# The dim each per-layer weight splits along over the model axis
# (``tpu_flash/parallel/train.py::param_specs``): by column for the heads
# and MLP hidden of an output, by row for the output projections' inputs,
# by head for the sink logits. Weights not named are replicated.
SHARD_DIMS = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1,
              "wo": 0, "w_down": 0, "sinks": 0}


def shard_params(params: Params, rank: int, n: int) -> Params:
    """This rank's tensor-parallel shard of a params dict, as JAX's
    ``param_specs`` lays it out over a model axis of ``n``: ``wq``, ``wk``,
    ``wv``, ``w_gate`` and ``w_up`` split by column, ``wo`` and ``w_down``
    by row, ``sinks`` by head; every other weight replicated. Shards are
    contiguous copies; with ``n`` 1 the dict's own tensors are kept (not
    copied)."""
    if n == 1:
        return params

    def cut(w, dim):
        if w.shape[dim] % n:
            raise ValueError(
                f"a weight of shape {tuple(w.shape)} does not split {n} ways "
                f"along dim {dim}"
            )
        step = w.shape[dim] // n
        return w.narrow(dim, rank * step, step).contiguous()

    layers = [{name: cut(w, SHARD_DIMS[name]) if name in SHARD_DIMS else w
               for name, w in layer.items()} for layer in params["layers"]]
    return {**params, "layers": layers}
