"""starcoder2-7b [dense] — GQA + RoPE, LayerNorm+bias, plain-GELU FFN
[arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        norm="ln",
        norm_bias=True,
        attn_bias=True,
        act="gelu",
        max_seq=16384,
    )


@register("starcoder2-7b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="starcoder2-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq=128,
    )
