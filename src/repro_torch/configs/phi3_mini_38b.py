"""phi3-mini-3.8b [dense] — RoPE SwiGLU MHA [arXiv:2404.14219].

32L d_model=3072 32H (kv=32, i.e. MHA) d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import ModelConfig, register


@register("phi3-mini-3.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        max_seq=131072,
    )


@register("phi3-mini-3.8b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="phi3-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=None,
        d_ff=256,
        vocab_size=512,
        max_seq=128,
    )
