"""Architecture configs ported so far: the paper's VGGT, qwen3-14b, rwkv6-1.6b and
deepseek-moe-16b."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

# import for registration side effects
from repro_torch.configs import deepseek_moe_16b, qwen3_14b, rwkv6_16b, vggt_1b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
