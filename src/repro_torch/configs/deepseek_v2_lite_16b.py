"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048, MLA with kv_lora_rank=512 (qk_nope 128 / qk_rope 64 /
v_head 128, 16 heads), 2 shared + 64 routed top-6 experts (d_ff=1408),
first layer dense (d_ff=10944), vocab=102400.  The reference's
configuration file records a discrepancy in its source assignment ("2
shared+160 routed"); it follows the published V2-Lite config's 64 routed
experts, and so does this copy.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v2-lite-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        moe_d_ff=1408,
        dense_d_ff=10944,
        vocab_size=102400,
        mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        moe=True,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        first_dense=1,
        max_seq=32768,
    )


@register("deepseek-v2-lite-16b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="deepseek-v2-lite-smoke",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=None,
        kv_lora_rank=64,
        qk_nope_dim=32,
        qk_rope_dim=16,
        v_head_dim=32,
        d_ff=64,
        moe_d_ff=64,
        dense_d_ff=256,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        vocab_size=512,
        max_seq=128,
    )
