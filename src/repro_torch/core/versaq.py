"""VersaQ-3D quantization flow (paper §III, Fig. 5/6) — port of
``repro/core/versaq.py``, in the part the unfused W4A8 path needs.

* **Offline weight preparation** (Fig. 6): ``W_final ← Hᵀ·γ·W·Dᵀ`` —
  Hadamard on the input side (the residual stream lives rotated), the
  preceding norm's γ/β folded in (Eq. 6), the DCT on the output side
  (Eq. 7), then symmetric W4/W8 quantization with per-channel scales.
* **Online activation processing** (Fig. 5): per-token dynamic A8/A4
  quantization before each integer matmul, block IDCT after it; norm
  statistics run in the rotated domain (``FoldedNorm``).
* **Per-head rotations**: V/O projections carry an offline per-head
  Hadamard pair; Q and K get an online per-head WHT (scores invariant).

* **Unified datapath** (§IV-B): ``Prologue``/``Epilogue`` descriptors on
  a ``QuantLinear`` and the ``FusedFFN`` layer run the surrounding
  nonlinear work inside one kernel launch (``kernels/fused``), or, off
  the kernel path, as an emulation in the same op order.

Conventions (orthonormal, block-diagonal): rotated residual x' = x·H;
DCT-domain output ŷ = y·Dᵀ, so the online IDCT is ŷ·D.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import transforms
from repro_torch.core.quantize import QTensor, quantize_per_token, quantize_weight, unpack_int4
from repro_torch.kernels.fused import act_rows as _act_fn
from repro_torch.obs import quant_health
from repro_torch.sharded import kernels_for

__all__ = [
    "QuantPolicy",
    "QuantLinear",
    "Prologue",
    "Epilogue",
    "FusedFFN",
    "Norm",
    "FoldedNorm",
    "apply_linear",
    "apply_ffn",
    "apply_norm",
    "carries_norm",
    "folded_norm_stats",
    "prepare_linear",
    "prepare_linear_fp",
    "rotate_rows",
    "rotate_cols",
    "dct_cols",
    "fold_head_hadamard_in",
    "fold_head_hadamard_out",
    "head_wht",
    "make_folded_norm",
    "online_wht",
    "W4A8",
    "W4A4",
    "W8A8",
]

DCT_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which bits + which transforms. method ∈ {rtn, quarot, versaq}."""

    w_bits: int = 4
    a_bits: int = 8
    method: str = "versaq"

    @property
    def use_wht(self) -> bool:
        return self.method in ("quarot", "versaq")

    @property
    def use_dct(self) -> bool:
        return self.method == "versaq"

    @property
    def name(self) -> str:
        return f"{self.method}-w{self.w_bits}a{self.a_bits}"


W8A8 = QuantPolicy(8, 8, "versaq")
W4A8 = QuantPolicy(4, 8, "versaq")
W4A4 = QuantPolicy(4, 4, "versaq")


@dataclasses.dataclass(frozen=True)
class Prologue:
    """Unified-datapath prologue descriptor: fold the preceding norm's
    *statistics* into the site's kernel launch.  The norm runs in
    FoldedNorm semantics (γ/β already live in the weights); an ``ln``
    prologue needs the mean-recovery vector in ``QuantLinear.norm_u``.  The
    site's ``rotate_input`` WHT and the activation quantization always
    join the fused pass."""

    norm: Optional[str] = None  # None | rms | ln
    eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Unified-datapath epilogue descriptor: nonlinear work emitted inside
    the kernel after the IDCT/bias the site already carries — activation,
    blocked WHT toward the next consumer, and optional re-quantization to
    INT8/INT4 (per-token scales), which makes the kernel emit integer
    activations directly."""

    act: str = "none"  # none | gelu | silu
    wht: bool = False
    requant_bits: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class QuantLinear:
    """A quantized linear layer in the VersaQ flow.

    ``qw`` holds the fully fused+quantized weight.  Static flags describe
    the online ops the layer still needs: ``rotate_input`` (blocked WHT on
    x before quantizing), ``idct`` (block IDCT on the output),
    ``use_kernel`` (route the integer matmul through the CUDA kernel
    instead of the float emulation).  ``prologue``/``epilogue`` are the
    unified-datapath descriptors: with ``use_kernel`` they route the site
    through the one-launch ``kernels.ops.fused_linear``; without it the
    same op order runs as the emulation.  ``norm_u`` carries the LayerNorm
    mean-recovery vector of an ``ln`` prologue.
    """

    qw: QTensor
    bias: Optional[torch.Tensor] = None
    a_bits: int = 8
    rotate_input: bool = False
    idct: bool = False
    dct_block: int = DCT_BLOCK
    use_kernel: bool = False
    prologue: Optional[Prologue] = None
    epilogue: Optional[Epilogue] = None
    norm_u: Optional[torch.Tensor] = None
    # Compiled-schedule launch tiles of the site's kernel, as a hashable
    # ``(("bk", 64), ("bm", 128), ("bn", 256))`` tuple (see
    # ``core/precision/compiler.py``); the kernel wrappers raise for tiles
    # their kernel cannot launch.  None = the kernel's own launch tiles.
    tiles: Optional[tuple] = None
    # Dotted PrecisionPlan site path ("frame.ffn.w_down", ...) — the
    # attribution key for quant-health telemetry (obs/quant_health.py).
    site: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Norm:
    """Plain (unquantized) norm: γ (+β), kind ∈ {rms, ln}."""

    g: torch.Tensor
    b: Optional[torch.Tensor] = None
    kind: str = "rms"
    eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class FoldedNorm:
    """A norm whose γ (and β) were folded into downstream weights.

    The statistics still run online, in the rotated domain: RMSNorm is
    rotation-invariant; LayerNorm recovers the mean through
    ``u = Hᵀ1/d`` and the variance from E[x²] − μ².
    """

    kind: str = "rms"
    u: Optional[torch.Tensor] = None  # Hᵀ1/d for LayerNorm mean recovery
    eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class FusedFFN:
    """A whole (optionally gated) FFN layer on the unified datapath: one
    kernel launch runs norm prologue → shared activation quantization →
    gate/up integer matmuls → ``act(g)·u`` → hidden WHT → re-quantization →
    down integer matmul → IDCT/biases.

    ``norm`` (rms|ln) means the layer *absorbs* its pre-norm: the model
    code passes the raw residual stream and skips the external
    ``apply_norm`` (see :func:`carries_norm`).  ``w_gate`` is None for
    plain FFNs.  When the member sites are not kernel-routed the same op
    order runs as the emulation.
    """

    w_up: QuantLinear
    w_down: QuantLinear
    w_gate: Optional[QuantLinear] = None
    norm_u: Optional[torch.Tensor] = None
    act: str = "gelu"
    norm: Optional[str] = None
    norm_eps: float = 1e-6


# ---------------------------------------------------------------------------
# Online ops
# ---------------------------------------------------------------------------


def online_wht(x: torch.Tensor) -> torch.Tensor:
    """Blocked multiplier-free WHT along the last axis."""
    return transforms.fast_wht(x)


def _int_matmul(xq: QTensor, wq: QTensor) -> torch.Tensor:
    """(per-token int) x (per-channel int) -> scaled float32: the float32
    emulation of the integer matmul, op for op as the reference's
    ``_int_matmul`` (the CUDA kernel is the exact hot path).  Expert-stacked
    weights ([E, K(/2), N]) multiply x [..., E, M, K] expert by expert, as
    the reference's ``vmap`` does."""
    xv = xq.values.to(torch.float32)
    stacked = wq.values.ndim - 2
    wv = (unpack_int4(wq.values, wq.pack_axis + stacked) if wq.packed
          else wq.values).to(torch.float32)
    acc = xv @ wv
    return acc * xq.scale.to(torch.float32) * wq.scale.to(torch.float32)


def folded_norm_stats(
    xf: torch.Tensor, kind: str, u: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    """FoldedNorm statistics (γ/β live in the weights) on f32 inputs.

    LayerNorm uses the rotated-domain formula, not ``F.layer_norm``: the
    mean is ⟨x, u⟩ and the image of the mean vector is μ·d·u.
    """
    if kind == "rms":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        return xf * torch.rsqrt(ms + eps)
    d = xf.shape[-1]
    mu = (xf @ u)[..., None]  # mean of the unrotated x
    sq = torch.mean(xf * xf, dim=-1, keepdim=True)  # E[x²] (rotation-invariant)
    var = sq - mu * mu
    return (xf - mu * u * d) * torch.rsqrt(var + eps)


def carries_norm(p: Any) -> bool:
    """True when a fused site absorbs its pre-norm (the layer code must
    pass the raw residual stream and skip the external ``apply_norm``)."""
    if isinstance(p, FusedFFN):
        return p.norm is not None
    if isinstance(p, dict) and "wqkv" in p:
        p = p["wqkv"]
    return isinstance(p, QuantLinear) and p.prologue is not None and p.prologue.norm is not None


def _kernel_ready(p: QuantLinear) -> bool:
    return p.use_kernel and p.qw.bits <= 8 and p.a_bits <= 8


def _monitor_quant(p: QuantLinear, x: torch.Tensor) -> None:
    """Quant-health tap: observe the activation a site is about to
    quantize (obs/quant_health.py; off by default and free when off).  On
    the fused-kernel path this sees the site *input* — the in-kernel
    norm/WHT run before the actual quantize — so the signal is a proxy
    there; the unfused path observes the exact pre-quant tensor."""
    if p.site is not None:
        quant_health.monitor(p.site, x, p.a_bits)


def apply_linear(p: Any, x: torch.Tensor) -> torch.Tensor:
    """Dispatching linear: plain {"w", "b"} dict or QuantLinear.

    A QuantLinear quantizes activations per token at its own ``a_bits``
    and runs the integer matmul on its own weight format.  A MoE layer's
    expert-stacked QuantLinear (values [E, K(/2), N]) takes x [..., E, M, K]
    and applies each expert to its rows (the reference's ``vmap``), on the
    kernel path in one batched launch.  ``use_kernel``
    sites go to the CUDA kernels: a site with ``prologue``/``epilogue``
    descriptors to the one-launch ``kernels.ops.fused_linear``, any other
    to ``kernels.ops.quant_linear_matmul``.  Otherwise the float emulation
    runs the same op order.  A requant epilogue returns a ``QTensor`` and
    must be called through ``fused_linear`` directly.
    """
    if isinstance(p, QuantLinear):
        dtype = x.dtype
        fused = p.prologue is not None or p.epilogue is not None
        if p.epilogue is not None and p.epilogue.requant_bits is not None:
            raise ValueError(
                "requant epilogues return QTensors — call kernels.ops.fused_linear directly"
            )
        if fused and _kernel_ready(p):
            _monitor_quant(p, x)
            return kernels_for(x, p.qw.values).fused_linear(x, p).to(dtype)
        if p.prologue is not None and p.prologue.norm is not None:
            x = folded_norm_stats(
                x.to(torch.float32), p.prologue.norm, p.norm_u, p.prologue.eps
            ).to(dtype)
        if p.rotate_input:
            x = online_wht(x)
        _monitor_quant(p, x)
        if _kernel_ready(p):
            y = kernels_for(x, p.qw.values).quant_linear_matmul(x, p.qw, a_bits=p.a_bits,
                                                                tiles=p.tiles)
        else:
            y = _int_matmul(quantize_per_token(x, p.a_bits), p.qw)
        if p.idct:
            d = transforms.dct_matrix(p.dct_block, dtype=torch.float32, device=y.device)
            y = transforms.apply_blocked(y, d, p.dct_block)  # ŷ·D cancels offline ·Dᵀ
        if p.bias is not None:
            y = y + p.bias.to(torch.float32)
        if p.epilogue is not None:  # emulation twin of the kernel epilogue
            y = _act_fn(y, p.epilogue.act)
            if p.epilogue.wht:
                y = online_wht(y)
        return y.to(dtype)
    if not isinstance(p, dict):
        raise NotImplementedError(f"{type(p).__name__} layers are not ported yet")
    y = x @ p["w"].to(x.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(x.dtype)
    return y


def apply_ffn(f: FusedFFN, x: torch.Tensor) -> torch.Tensor:
    """Apply a :class:`FusedFFN`: one kernel launch when every member site
    is kernel-routed, else the emulation in the same op order."""
    dtype = x.dtype
    members = (f.w_up, f.w_down) + (() if f.w_gate is None else (f.w_gate,))
    if all(_kernel_ready(ql) for ql in members):
        _monitor_quant(f.w_up, x)  # the in-kernel hidden is unobservable
        return kernels_for(x, f.w_up.qw.values).fused_ffn_apply(x, f).to(dtype)
    if f.norm is not None:
        x = folded_norm_stats(x.to(torch.float32), f.norm, f.norm_u, f.norm_eps).to(dtype)
    u = apply_linear(f.w_up, x)
    if f.w_gate is not None:
        h = _act_fn(apply_linear(f.w_gate, x), f.act) * u
    else:
        h = _act_fn(u, f.act)
    return apply_linear(f.w_down, h.to(dtype)).to(dtype)


def apply_norm(p: Any, x: torch.Tensor) -> torch.Tensor:
    """Dispatching norm: ``Norm`` (plain) or ``FoldedNorm`` (γ folded away)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    if isinstance(p, FoldedNorm):
        return folded_norm_stats(xf, p.kind, p.u, p.eps).to(dtype)
    if p.kind == "rms":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + p.eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + p.eps)
    y = y * p.g.to(torch.float32)
    if p.b is not None:
        y = y + p.b.to(torch.float32)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Offline weight preparation (Fig. 6)
# ---------------------------------------------------------------------------


def rotate_rows(w: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """W ← Hᵀ·W with blocked Hadamard along the input (row) dim (H = Hᵀ)."""
    blk = block or transforms.block_size_for(w.shape[0])
    h = transforms.hadamard_matrix(blk, device=w.device)
    d_in = w.shape[0]
    w = w.reshape(d_in // blk, blk, -1).to(torch.float32)
    return (h @ w).reshape(d_in, -1)


def rotate_cols(w: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """W ← W·H (blocked) along the output dim — leaves outputs rotated."""
    blk = block or transforms.block_size_for(w.shape[-1])
    hb = transforms.hadamard_matrix(blk, device=w.device)
    d_out = w.shape[-1]
    lead = tuple(w.shape[:-1])
    w = w.reshape(lead + (d_out // blk, blk)).to(torch.float32)
    return (w @ hb).reshape(lead + (d_out,))


def dct_cols(w: torch.Tensor, block: int = DCT_BLOCK) -> torch.Tensor:
    """W ← W·Dᵀ with blocked DCT along the output dim (online IDCT = ·D)."""
    d = transforms.dct_matrix(block, device=w.device)
    d_out = w.shape[-1]
    lead = tuple(w.shape[:-1])
    w = w.reshape(lead + (d_out // block, block)).to(torch.float32)
    return (w @ d.T).reshape(lead + (d_out,))


def _fuse_weight(
    w: torch.Tensor,
    *,
    use_wht: bool,
    gamma: Optional[torch.Tensor],
    beta: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    rotate_in: bool,
    rotate_out_offline: bool,
    head_rot_in: tuple[int, int] | None,
    head_rot_out: tuple[int, int] | None,
    in_block: int | None,
) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Shared offline fusion (Eq. 6/7 minus the DCT): γ/β fold, per-head
    Hadamards, input-side Hᵀ, output-side H.  Returns (w, b, has_bias)."""
    w = w.to(torch.float32)
    if bias is None:
        b = torch.zeros((w.shape[-1],), dtype=torch.float32, device=w.device)
    else:
        b = bias.to(torch.float32)
    has_bias = bias is not None
    if beta is not None:  # β @ W with the original W
        b = b + beta.to(torch.float32) @ w
        has_bias = True
    if gamma is not None:
        w = w * gamma.to(torch.float32)[:, None]
    if head_rot_in is not None and use_wht:
        w = fold_head_hadamard_in(w, *head_rot_in)
    if rotate_in and use_wht:
        w = rotate_rows(w, in_block or transforms.block_size_for(w.shape[0]))
    if head_rot_out is not None and use_wht:
        w = fold_head_hadamard_out(w, *head_rot_out)
    if rotate_out_offline and use_wht:
        w = rotate_cols(w)
        b = rotate_cols(b[None, :])[0]
    return w, b, has_bias


def prepare_linear(
    w: torch.Tensor,
    policy: QuantPolicy,
    *,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    rotate_in_offline: bool = False,
    rotate_input_online: bool = False,
    rotate_out_offline: bool = False,
    head_rot_in: tuple[int, int] | None = None,
    head_rot_out: tuple[int, int] | None = None,
    in_block: int | None = None,
    use_kernel: bool = False,
    prologue: Optional[Prologue] = None,
    epilogue: Optional[Epilogue] = None,
    norm_u: Optional[torch.Tensor] = None,
    tiles: Optional[tuple] = None,
    site: Optional[str] = None,
) -> QuantLinear:
    """Fuse transforms into a [in, out] weight and quantize (Eq. 7).

    ``gamma``/``beta``: the preceding norm's scale/shift, folded per Eq. 6
    (β contributes ``β @ W`` to the bias, on the *original* W).
    ``rotate_in_offline``: fuse Hᵀ on the input side (input arrives rotated).
    ``rotate_input_online``: the input cannot arrive rotated (the FFN
    hidden); the online WHT runs at apply time and Hᵀ is fused here.
    ``rotate_out_offline``: fuse H on the output side (output stays in the
    rotated residual domain); the bias is rotated to match.
    ``head_rot_in``/``head_rot_out``: (n_heads, head_dim) per-head Hadamard.
    ``use_kernel``: route this site's matmul through the CUDA kernel.
    ``prologue``/``epilogue``/``norm_u``: unified-datapath descriptors
    carried onto the prepared layer (see :class:`QuantLinear`).
    ``tiles``: the site's compiled kernel launch tiles.
    ``site``: the plan's site path, for quant-health attribution.
    """
    w, b, has_bias = _fuse_weight(
        w,
        use_wht=policy.use_wht,
        gamma=gamma,
        beta=beta,
        bias=bias,
        rotate_in=rotate_in_offline or rotate_input_online,
        rotate_out_offline=rotate_out_offline,
        head_rot_in=head_rot_in,
        head_rot_out=head_rot_out,
        in_block=in_block,
    )
    idct = False
    if policy.use_dct and w.shape[-1] % DCT_BLOCK == 0:
        w = dct_cols(w, DCT_BLOCK)
        idct = True  # the bias is added after the online IDCT: keep b as is
    return QuantLinear(
        qw=quantize_weight(w, policy.w_bits),
        bias=b if has_bias else None,
        a_bits=policy.a_bits,
        rotate_input=policy.use_wht and rotate_input_online,
        idct=idct,
        use_kernel=use_kernel,
        prologue=prologue,
        epilogue=epilogue,
        norm_u=norm_u,
        tiles=tiles,
        site=site,
    )


def prepare_linear_fp(
    w: torch.Tensor,
    *,
    use_wht: bool = True,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    rotate_in_offline: bool = False,
    rotate_input_online: bool = False,
    rotate_out_offline: bool = False,
    head_rot_in: tuple[int, int] | None = None,
    head_rot_out: tuple[int, int] | None = None,
    in_block: int | None = None,
) -> dict:
    """bf16-passthrough site preparation for mixed-precision plans: the
    same offline fusion as :func:`prepare_linear`, no DCT, no
    quantization.  ``rotate_input_online`` is accepted for signature
    parity and ignored (with no quantizer between them the online WHT and
    the offline Hᵀ would cancel exactly).  Returns ``{"w", "b"}``."""
    del rotate_input_online
    w, b, has_bias = _fuse_weight(
        w,
        use_wht=use_wht,
        gamma=gamma,
        beta=beta,
        bias=bias,
        rotate_in=rotate_in_offline,
        rotate_out_offline=rotate_out_offline,
        head_rot_in=head_rot_in,
        head_rot_out=head_rot_out,
        in_block=in_block,
    )
    return {"w": w, "b": b if has_bias else None}


def fold_head_hadamard_out(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """Fuse a per-head Hadamard on the *output* side: W[:, (h,d)] ← W·H_dh."""
    k = w.shape[0]
    return rotate_cols(w.reshape(k, n_heads, head_dim)).reshape(k, n_heads * head_dim)


def fold_head_hadamard_in(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """Fuse a per-head Hadamard on the *input* side: W[(h,d), :] ← H_dhᵀ·W."""
    hb = transforms.blocked_hadamard_matrix(head_dim, device=w.device)
    n = w.shape[-1]
    w = w.reshape(n_heads, head_dim, n).to(torch.float32)
    return (hb.T @ w).reshape(n_heads * head_dim, n)


def head_wht(x: torch.Tensor) -> torch.Tensor:
    """Online per-head WHT along head_dim (scores-invariant Q/K smoothing)."""
    return transforms.fast_wht(x)


def make_folded_norm(kind: str, dim: int, eps: float = 1e-6, device=None) -> FoldedNorm:
    if kind == "rms":
        return FoldedNorm(kind="rms", u=None, eps=eps)
    # u = Hᵀ1/d: for a normalized blocked Hadamard, column sums are √b at
    # block-leading coordinates and 0 elsewhere (f32 arithmetic, as the
    # reference computes it)
    b = transforms.block_size_for(dim)
    u = torch.zeros((dim,), dtype=torch.float32, device=device)
    u[::b] = torch.sqrt(torch.tensor(float(b), dtype=torch.float32)) / dim
    return FoldedNorm(kind="ln", u=u, eps=eps)
