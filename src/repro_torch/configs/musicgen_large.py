"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048; LayerNorm+bias, plain
GELU FFN, sinusoidal positions.  The EnCodec frontend is a STUB: the
backbone consumes (single-codebook) token ids, per the assignment's
audio rule.
"""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        norm="ln",
        norm_bias=True,
        act="gelu",
        pos="sincos",
        max_seq=32768,
    )


@register("musicgen-large-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="musicgen-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=None,
        d_ff=256,
        vocab_size=256,
        max_seq=128,
    )
