"""Load HuggingFace Llama-family checkpoints (and JAX param trees) into
the port's params.

The port of ``tpu_flash/checkpoint/convert.py``. ``*.safetensors`` files
are read here directly (an 8-byte little-endian header length, a JSON
header, then raw little-endian tensors), so loading needs no
``safetensors`` package. torch ``nn.Linear`` weights are [out, in]; the
params keep the JAX tree's [in, out], so every projection transposes.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpu_flash_torch.models.configs import ModelConfig

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array. BF16
    tensors come back as float32 (exactly: a bf16 value is the top half
    of its f32)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = data[start:end]
        shape = tuple(meta["shape"])
        if meta["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            dt = np.dtype(_ST_DTYPES[meta["dtype"]]).newbyteorder("<")
            arr = np.frombuffer(raw, dtype=dt)
        out[name] = arr.reshape(shape).copy()
    return out


def _to_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=dtype
    )


def params_from_hf_llama(state_dict: Mapping[str, Any], config: ModelConfig,
                         device=None) -> Dict[str, Any]:
    """The params dict of a ``FlashTransformer`` from an HF Llama state
    dict (numpy arrays or torch tensors), in the config's dtype."""
    dtype = getattr(torch, config.dtype)
    device = device if device is not None else "cuda"

    def dense(name):
        return _to_tensor(state_dict[name], dtype, device).t().contiguous()

    def vec(name):
        return _to_tensor(state_dict[name], dtype, device)

    layers = []
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        layers.append({
            "attn_norm": vec(p + "input_layernorm.weight"),
            "wq": dense(p + "self_attn.q_proj.weight"),
            "wk": dense(p + "self_attn.k_proj.weight"),
            "wv": dense(p + "self_attn.v_proj.weight"),
            "wo": dense(p + "self_attn.o_proj.weight"),
            "mlp_norm": vec(p + "post_attention_layernorm.weight"),
            "w_gate": dense(p + "mlp.gate_proj.weight"),
            "w_up": dense(p + "mlp.up_proj.weight"),
            "w_down": dense(p + "mlp.down_proj.weight"),
        })
    embed = vec("model.embed_tokens.weight")
    if "lm_head.weight" in state_dict:
        lm_head = dense("lm_head.weight")
    else:  # tied embeddings (Llama-3.2-style)
        lm_head = embed.t().contiguous()
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": vec("model.norm.weight"),
        "lm_head": lm_head,
    }
    _validate_shapes(params, config)
    return params


def _validate_shapes(params: Dict[str, Any], config: ModelConfig) -> None:
    h = config.hidden_size
    qd = config.num_q_heads * config.head_dim
    kvd = config.num_kv_heads * config.head_dim
    expect = {
        "embed": (config.vocab_size, h),
        "final_norm": (h,),
        "lm_head": (h, config.vocab_size),
    }
    for name, shape in expect.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(
                f"{name}: got {tuple(params[name].shape)}, expected {shape}"
            )
    layer_expect = {
        "attn_norm": (h,), "mlp_norm": (h,),
        "wq": (h, qd), "wk": (h, kvd), "wv": (h, kvd), "wo": (qd, h),
        "w_gate": (h, config.intermediate_size),
        "w_up": (h, config.intermediate_size),
        "w_down": (config.intermediate_size, h),
    }
    for i, layer in enumerate(params["layers"]):
        for name, shape in layer_expect.items():
            if tuple(layer[name].shape) != shape:
                raise ValueError(
                    f"layers[{i}].{name}: got {tuple(layer[name].shape)}, "
                    f"expected {shape}"
                )


def model_config_from_hf(hf_config: Mapping[str, Any], *,
                         name: str = "hf-import",
                         dtype: str = "bfloat16") -> ModelConfig:
    """A :class:`ModelConfig` from an HF ``config.json`` dict (Llama /
    Mistral / Gemma-2 family), with sliding window, softcap, rope scaling
    and ALiBi mapped as in the JAX package."""
    hidden = hf_config["hidden_size"]
    n_q = hf_config["num_attention_heads"]
    n_kv = hf_config.get("num_key_value_heads", n_q)
    head_dim = hf_config.get("head_dim", hidden // n_q)

    rope_scaling = None
    rope_factor = 1.0
    rope_orig = hf_config.get("max_position_embeddings", 4096)
    rope_low_f, rope_high_f = 1.0, 4.0
    rs = hf_config.get("rope_scaling") or {}
    if rs:
        kind = rs.get("rope_type", rs.get("type", "linear"))
        if kind not in ("linear", "ntk", "yarn", "llama3"):
            # "dynamic" (length-dependent NTK) has no static equivalent.
            raise ValueError(f"unsupported HF rope_scaling type {kind!r}")
        rope_scaling = kind
        rope_factor = float(rs.get("factor", 1.0))
        if kind in ("yarn", "llama3"):
            if "original_max_position_embeddings" not in rs:
                raise ValueError(
                    f"rope_scaling type {kind!r} requires "
                    "original_max_position_embeddings in rope_scaling"
                )
            rope_orig = int(rs["original_max_position_embeddings"])
        if kind == "llama3":
            rope_low_f = float(rs.get("low_freq_factor", 1.0))
            rope_high_f = float(rs.get("high_freq_factor", 4.0))

    return ModelConfig(
        name=name,
        vocab_size=hf_config["vocab_size"],
        hidden_size=hidden,
        num_layers=hf_config["num_hidden_layers"],
        num_q_heads=n_q,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        intermediate_size=hf_config["intermediate_size"],
        rope_theta=float(hf_config.get("rope_theta", 10000.0)),
        rms_eps=float(hf_config.get("rms_norm_eps", 1e-5)),
        dtype=dtype,
        sliding_window=hf_config.get("sliding_window"),
        sliding_window_pattern=hf_config.get(
            "sliding_window_pattern",
            2 if hf_config.get("model_type") == "gemma2"
            and hf_config.get("sliding_window") else None,
        ),
        attn_softcap=hf_config.get("attn_logit_softcapping"),
        rope_scaling=rope_scaling,
        rope_scaling_factor=rope_factor,
        rope_orig_context=rope_orig,
        rope_low_freq_factor=rope_low_f,
        rope_high_freq_factor=rope_high_f,
        query_pre_attn_scalar=hf_config.get("query_pre_attn_scalar"),
        attn_alibi=bool(
            hf_config.get("alibi")
            or hf_config.get("model_type") == "bloom"
            or (hf_config.get("attn_config") or {}).get("alibi", False)
        ),
    )


def load_hf_dir(path: str, *, dtype: str = "bfloat16", device=None):
    """(FlashTransformer, params) from an HF checkpoint directory:
    ``config.json`` plus ``*.safetensors`` (read here) or
    ``pytorch_model*.bin`` shards."""
    from tpu_flash_torch.models.transformer import FlashTransformer

    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    config = model_config_from_hf(
        hf_config, name=hf_config.get("model_type", "hf-import"), dtype=dtype
    )
    files = sorted(os.listdir(path))
    st_files = [f for f in files if f.endswith(".safetensors")]
    bin_files = [f for f in files
                 if f.endswith(".bin") and "pytorch_model" in f]
    state: Dict[str, Any] = {}
    if st_files:
        for f in st_files:
            state.update(read_safetensors(os.path.join(path, f)))
    elif bin_files:
        for f in bin_files:
            state.update(torch.load(os.path.join(path, f),
                                    map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(
            f"no *.safetensors or pytorch_model*.bin shards under {path}"
        )
    model = FlashTransformer(config, device=device)
    return model, params_from_hf_llama(state, config, device=model.device)


def _from_jax_array(x, device) -> torch.Tensor:
    arr = np.array(x)  # a writable copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16
        ).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(np_params: Mapping[str, Any], device=None):
    """The port's params from the JAX package's param tree (its leaves
    as numpy arrays, bf16 included): same names, layouts and values, so
    both packages compute the same model."""
    device = device if device is not None else "cuda"
    return {
        "embed": _from_jax_array(np_params["embed"], device),
        "layers": [
            {name: _from_jax_array(w, device) for name, w in layer.items()}
            for layer in np_params["layers"]
        ],
        "final_norm": _from_jax_array(np_params["final_norm"], device),
        "lm_head": _from_jax_array(np_params["lm_head"], device),
    }
