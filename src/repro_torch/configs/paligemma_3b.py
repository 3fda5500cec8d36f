"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216, head_dim 256,
GeGLU.  The SigLIP vision frontend is a stub, as in the reference: inputs are
precomputed patch embeddings (cfg.embed_inputs), entering through ``in_proj``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("paligemma-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        act="geglu",
        embed_inputs=True,
        max_seq=32768,
    )


@register("paligemma-3b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="paligemma-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq=128,
    )
