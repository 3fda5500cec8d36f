"""qwen3-14b [dense] — GQA + qk_norm [hf:Qwen/Qwen3-14B].

40L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=17408 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        max_seq=32768,
    )


@register("qwen3-14b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="qwen3-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq=128,
    )
