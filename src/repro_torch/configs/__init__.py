"""Architecture configs ported so far: the paper's VGGT and qwen3-14b."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

# import for registration side effects
from repro_torch.configs import qwen3_14b, vggt_1b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
