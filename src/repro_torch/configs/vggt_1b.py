"""vggt-1b — the paper's own model (VGGT, CVPR'25 [55]).

24 alternating-attention pairs (frame + global per pair), d_model=1024,
16H MHA, d_ff=4096, LayerNorm + LayerScale (DINOv2-style).  The DINO
frontend is a STUB (precomputed patch embeddings); camera + DPT heads on
top.  This is the model the VersaQ-3D quantization and two-stage tiling
were designed for.
"""
from repro_torch.configs.base import ModelConfig, register


@register("vggt-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="vggt-1b",
        family="vggt",
        n_layers=24,  # AA pairs
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=1,
        norm="ln",
        norm_bias=True,
        act="gelu",
        pos="none",
        vggt=True,
        layerscale=True,
        embed_inputs=True,
        n_special_tokens=5,
        max_seq=65536,
    )


@register("vggt-1b-smoke")
def smoke_config() -> ModelConfig:
    return config().with_(
        name="vggt-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        max_seq=512,
    )
