"""Architecture configs: the paper's VGGT and the reference's ten LMs (qwen3-14b,
rwkv6-1.6b, deepseek-moe-16b, deepseek-v2-lite-16b, phi3-mini-3.8b, paligemma-3b,
internlm2-20b, starcoder2-7b, musicgen-large and jamba-v0.1-52b), each with its
``-smoke`` config."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    deepseek_v2_lite_16b,
    internlm2_20b,
    jamba_v01_52b,
    musicgen_large,
    paligemma_3b,
    phi3_mini_38b,
    qwen3_14b,
    rwkv6_16b,
    starcoder2_7b,
    vggt_1b,
)

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
