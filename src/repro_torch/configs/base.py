"""Model configuration schema + registry.

One ``ModelConfig`` describes every architecture in the assigned pool
(dense / GQA / MLA / MoE / Mamba-hybrid / RWKV / VGGT).  Configs are pure
data; the model code interprets them.  This is the port's own copy of the
JAX package's schema (field for field, so configs compare equal across the
two packages); the port imports nothing from the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, Callable[[], "ModelConfig"]] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | vggt
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # defaults to d_model // n_heads
    norm: str = "rms"  # rms | ln
    norm_bias: bool = False
    qk_norm: bool = False
    pos: str = "rope"  # rope | sincos | none
    rope_theta: float = 10_000.0
    attn_bias: bool = False
    attn_impl: str = "flash"  # flash | two_stage | vanilla (ablation)
    # two_stage + quantized weights route through the INT8 two-stage CUDA
    # kernel; False pins the float emulation
    attn_use_kernel: bool = True
    # a compiled KernelSchedule's attention launch tiles: hashable tuple of
    # (name, int) pairs (bq/bk/bkv), checked against the two-stage kernel's
    # own by kernels.ops.two_stage_mha; None = the kernel's launch tiles
    attn_tiles: tuple | None = None
    attn_dtype: str = "f32"  # f32 | bf16 streaming-attention compute dtype
    act: str = "swiglu"  # swiglu | geglu | gelu
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int | None = None  # per-expert hidden dim
    moe_period: int = 1  # MoE FFN every k-th layer (jamba: 2)
    first_dense: int = 0  # first k layers use the dense FFN (deepseek: 1)
    dense_d_ff: int | None = None  # hidden dim of those dense layers
    capacity_factor: float = 1.25
    moe_dispatch_blocks: int = 0  # 0 = auto (~4096 tokens/block)
    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- layer pattern (period-cycled); entries: attn | mamba | rwkv ---
    pattern: tuple[str, ...] = ("attn",)
    # --- mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    # --- io ---
    embed_inputs: bool = False  # stub frontend: inputs are [B, L, d_model] embeddings
    tie_embeddings: bool = False
    max_seq: int = 8192
    # --- vggt ---
    vggt: bool = False
    n_special_tokens: int = 5  # camera + register tokens per frame
    layerscale: bool = False
    layerscale_init: float = 1e-5

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            self.n_layers,
            self.pattern,
        )

    @property
    def q_heads_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ---
    def _ffn_params(self, layer_idx: int) -> tuple[int, int]:
        """(total, active) FFN params for a layer."""
        d = self.d_model
        glu = self.act in ("swiglu", "geglu")
        mult = 3 if glu else 2
        if not self.moe:
            return mult * d * self.d_ff, mult * d * self.d_ff
        if layer_idx < self.first_dense or (layer_idx % self.moe_period) != 0:
            dff = self.dense_d_ff or self.d_ff
            return mult * d * dff, mult * d * dff
        dff = self.moe_d_ff or self.d_ff
        shared = self.n_shared_experts * mult * d * dff
        routed_total = self.n_experts * mult * d * dff
        routed_active = self.top_k * mult * d * dff
        router = d * self.n_experts
        return shared + routed_total + router, shared + routed_active + router

    def _mixer_params(self, kind: str) -> int:
        d = self.d_model
        hd = self.head_dim
        if kind == "attn":
            if self.mla:
                qd = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                return (
                    d * qd
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d
                )
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if kind == "mamba":
            di = self.mamba_expand * d
            return 2 * d * di + di * self.mamba_d_conv + di * (2 * self.mamba_d_state + 2) + di * d
        if kind == "rwkv":
            # time-mix r,k,v,g,o + decay lora + channel-mix handled in ffn count
            return 5 * d * d + 2 * d * 64
        raise ValueError(kind)

    def param_counts(self) -> tuple[int, int]:
        """(total, active) parameter counts (embeddings included once)."""
        total = active = 0
        for i in range(self.n_layers):
            kind = self.pattern[i % len(self.pattern)]
            m = self._mixer_params(kind)
            t, a = self._ffn_params(i)
            total += m + t
            active += m + a
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        total += emb + head
        active += emb + head
        return total, active


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
