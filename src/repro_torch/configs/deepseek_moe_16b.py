"""deepseek-moe-16b [moe] — fine-grained MoE [arXiv:2401.06066].

28L d_model=2048 16H (MHA) expert d_ff=1408, 2 shared + 64 routed top-6,
first layer dense (d_ff=10944), vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        moe_d_ff=1408,
        dense_d_ff=10944,
        vocab_size=102400,
        moe=True,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        first_dense=1,
        max_seq=32768,
    )


@register("deepseek-moe-16b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="deepseek-moe-smoke",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=None,
        d_ff=64,
        moe_d_ff=64,
        dense_d_ff=256,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        vocab_size=512,
        max_seq=128,
    )
