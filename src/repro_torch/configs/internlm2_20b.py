"""internlm2-20b [dense] — GQA [arXiv:2403.17297].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internlm2-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        rope_theta=1_000_000.0,
        max_seq=32768,
    )


@register("internlm2-20b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="internlm2-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=None,
        d_ff=256,
        vocab_size=512,
        max_seq=128,
    )
