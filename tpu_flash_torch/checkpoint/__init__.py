from tpu_flash_torch.checkpoint.convert import (
    load_hf_dir,
    model_config_from_hf,
    params_from_hf_llama,
    params_from_jax,
    read_safetensors,
)

__all__ = [
    "load_hf_dir", "model_config_from_hf", "params_from_hf_llama",
    "params_from_jax", "read_safetensors",
]
