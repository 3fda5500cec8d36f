"""The yardstick's frozen operation and byte counts, worked out from the
models' shapes, and the chip's peaks.

Each kernel launch is counted as the function it computes: each input
byte read once and each output byte written once (scratch is the
kernel's own traffic), int8 operations as 2 x multiply-adds, exponentials
and tanh as transcendentals.  The float32 prologue and epilogue work of
the fused kernels (norm statistics, quantization, IDCT, WHT) is not
counted: it could only raise the bound, so a share against it is never
overstated.  ``model_ops`` counts the model's matmul and attention
operations (2 x multiply-adds) for the served work, what ``mfu`` divides.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1.979e15
PEAK_F32_OPS = 67e12
PEAK_TRANSCENDENTALS = 3.87e12  # 132 SMs x 16 MUFU results a clock x 1.83 GHz
DCT_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class Launch:
    kernel: str
    bytes: float
    int8_ops: float = 0.0
    f32_ops: float = 0.0
    transcendentals: float = 0.0

    def bound_s(self) -> float:
        """The least time the chip could take for this launch."""
        return max(self.bytes / PEAK_BYTES_PER_S, self.int8_ops / PEAK_INT8_OPS,
                   self.f32_ops / PEAK_F32_OPS, self.transcendentals / PEAK_TRANSCENDENTALS)


def quant_matmul(m: int, k: int, n: int) -> Launch:
    """W4A8 y = (x_int @ w_int4) * xs * ws: int8 x and its scales, the
    packed weight and its scales in; float32 y out."""
    return Launch("quant_matmul", bytes=m * k + 4 * m + k // 2 * n + 4 * n + 4 * m * n,
                  int8_ops=2.0 * m * k * n)


def fused_matmul(m: int, k: int, n: int, *, norm: bool, bias: bool) -> Launch:
    """float32 x (normed, quantized in the prologue) times packed W4,
    IDCT and bias in the epilogue, float32 y."""
    b = (4 * m * k + (4 * k if norm else 0) + k // 2 * n + 4 * n + (4 * n if bias else 0)
         + 4 * m * n + 4 * DCT_BLOCK * DCT_BLOCK)
    return Launch("fused_matmul", bytes=b, int8_ops=2.0 * m * k * n)


def fused_ffn(m: int, d: int, dff: int, *, bias: bool) -> Launch:
    """A whole GELU FFN: float32 x in, both packed W4 weights, float32 y
    out; one tanh per hidden element."""
    b = (4 * m * d + 4 * d + 2 * (d // 2 * dff) + 4 * dff + 4 * d
         + ((4 * dff + 4 * d) if bias else 0) + 4 * m * d + 4 * DCT_BLOCK * DCT_BLOCK)
    return Launch("fused_ffn", bytes=b, int8_ops=2.0 * m * d * dff * 2,
                  transcendentals=float(m) * dff)


def two_stage_attention(bh: int, lq: int, lk: int, dh: int) -> Launch:
    """Alg. 1 over bh heads: int8 q/k/v and their scales in, float32 out;
    q.k and p.v are 2 x lq x lk x dh each; one exponential a score."""
    b = bh * lq * (dh + 4) + bh * lk * (2 * dh + 4) + 4 * bh + 4 * bh * lq * dh
    return Launch("two_stage_attention", bytes=b, int8_ops=4.0 * bh * lq * lk * dh,
                  transcendentals=float(bh) * lq * lk)


# ---------------------------------------------------------------------------
# per forward / wave
# ---------------------------------------------------------------------------


def vggt_launches(cfg: dict, batch: int, frames: int, patches: int) -> list[Launch]:
    """The hand-written launches of one VGGT forward served W4A8 fused with
    two-stage attention, at a (padded) batch of ``batch`` scenes."""
    d, h, dff = cfg["d_model"], cfg["n_heads"], cfg["d_ff"]
    dh = d // h
    t = cfg["n_special_tokens"] + patches
    m = batch * frames * t
    blocks = []
    for kind in ("frame", "global"):
        bh, length = (batch * frames * h, t) if kind == "frame" else (batch * h, frames * t)
        blocks += [fused_matmul(m, d, 3 * d, norm=True, bias=True),
                   two_stage_attention(bh, length, length, dh),
                   fused_matmul(m, d, d, norm=False, bias=False),
                   fused_ffn(m, d, dff, bias=True)]
    out = blocks * cfg["n_layers"]  # in launch order: each pair's frame, then global block
    return out


def vggt_model_ops(cfg: dict, frames: int, patches: int) -> float:
    """Matmul and attention operations of one scene's forward."""
    d, dff, ns = cfg["d_model"], cfg["d_ff"], cfg["n_special_tokens"]
    t = ns + patches
    n = frames * t
    per_block = 2.0 * n * (4 * d * d + 2 * d * dff)
    frame_attn = 4.0 * frames * t * t * d
    global_attn = 4.0 * n * n * d
    heads = 2.0 * frames * (d * d + d * 9) + 2.0 * frames * patches * (d * d + d * 5)
    return (cfg["n_layers"] * (2 * per_block + frame_attn + global_attn)
            + 2.0 * frames * patches * d * d + heads)


def lm_launches(cfg: dict, batch: int, length: int) -> list[Launch]:
    """The ``quant_matmul`` launches of one W4A8 prefill wave (every
    projection of every layer at M = batch x length)."""
    d, h, hkv, dh, dff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                          cfg["d_ff"])
    m = batch * length
    per_layer = [quant_matmul(m, d, h * dh), quant_matmul(m, d, hkv * dh),
                 quant_matmul(m, d, hkv * dh), quant_matmul(m, h * dh, d),
                 quant_matmul(m, d, dff), quant_matmul(m, d, dff), quant_matmul(m, dff, d)]
    return per_layer * cfg["n_layers"]


def lm_model_ops(cfg: dict, n: int) -> float:
    """Matmul and causal attention operations of one n-token prompt's
    prefill, the output head at every position included."""
    d, h, hkv, dh, dff, v = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                             cfg["head_dim"], cfg["d_ff"], cfg["vocab_size"])
    per_token = 2.0 * (d * (h + 2 * hkv) * dh + h * dh * d + 3 * d * dff)
    attn = 2.0 * dh * n * (n + 1) * h  # q.k and p.v over the causal triangle
    return cfg["n_layers"] * (n * per_token + attn) + 2.0 * n * d * v
