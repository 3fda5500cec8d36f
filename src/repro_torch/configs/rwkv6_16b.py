"""rwkv6-1.6b [ssm] — "Finch", attention-free, data-dependent decay
[arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536.  No attention layers: the paper's
two-stage attention tiling does not apply; VersaQ quantization applies to
every time-mix and channel-mix projection.
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # wkv heads = d_model / rwkv_head_dim
        n_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        pattern=("rwkv",),
        norm="ln",
        norm_bias=True,
        pos="none",
        rwkv_head_dim=64,
        max_seq=524288,
    )


@register("rwkv6-1.6b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="rwkv6-smoke",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        head_dim=None,
        d_ff=256,
        vocab_size=512,
        rwkv_head_dim=64,
        max_seq=128,
    )
