from tpu_flash_torch.checkpoint.convert import (
    load_hf_dir,
    model_config_from_hf,
    params_from_hf_llama,
    params_from_jax,
    read_safetensors,
)
from tpu_flash_torch.checkpoint.store import (
    TrainCheckpointManager,
    restore_dp_engine,
    restore_engine,
    restore_params,
    save_params,
    snapshot_dp_engine,
    snapshot_engine,
)

__all__ = [
    "TrainCheckpointManager", "load_hf_dir", "model_config_from_hf",
    "params_from_hf_llama", "params_from_jax", "read_safetensors",
    "restore_dp_engine", "restore_engine", "restore_params", "save_params",
    "snapshot_dp_engine", "snapshot_engine",
]
