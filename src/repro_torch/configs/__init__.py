"""Architecture configs ported so far: the paper's VGGT, qwen3-14b, rwkv6-1.6b,
deepseek-moe-16b, phi3-mini-3.8b and paligemma-3b."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    paligemma_3b,
    phi3_mini_38b,
    qwen3_14b,
    rwkv6_16b,
    vggt_1b,
)

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
