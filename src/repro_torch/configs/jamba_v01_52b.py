"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887].
Period-8 pattern with one attention layer per period (1:7) and MoE every
2nd layer; no explicit positional encoding (Mamba provides position).
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = ("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba")


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        pattern=_PATTERN,
        pos="none",
        moe=True,
        n_experts=16,
        top_k=2,
        moe_d_ff=14336,
        moe_period=2,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        max_seq=524288,
    )


@register("jamba-v0.1-52b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="jamba-smoke",
        n_layers=8,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=None,
        d_ff=256,
        moe_d_ff=256,
        n_experts=4,
        top_k=2,
        vocab_size=512,
        max_seq=128,
    )
