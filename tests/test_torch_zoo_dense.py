"""internlm2-20b, starcoder2-7b and musicgen-large in the PyTorch port
against the JAX package, on the CPU: the last dense configs of the
reference, served by model code the port already has.

internlm2-20b is GQA 48/8 with RMSNorm and SwiGLU; starcoder2-7b GQA 36/4
with LayerNorm and bias, attention bias and plain GELU; musicgen-large MHA
32/32 with LayerNorm and bias, plain GELU and sinusoidal positions (whose
table a rotated stream takes as ``pos_rot``).  Checked here: the bridged
trees; ``quantize_lm`` leaf for leaf at their smoke sizes, unfused and
fused (starcoder2's Q/K/V/O biases, musicgen's ``pos_rot``); the fusion
decisions at full width, on the ``meta`` device against the reference's
abstract walk (``jax.eval_shape``): the 8 MiB panel budget keeps every
site of internlm2 and starcoder2 per-site, and fuses musicgen's ``wqkv``
(with its LayerNorm prologue) and ``wo`` but not its FFN; fp, W4A8 and
fused W4A8 forwards, and a left-padded prefill with decode steps through the
int8 KV cache; and the launcher serving each new smoke config, jamba's
too, in a process without JAX.

Weights come from the reference's ``lm.init_params`` (seed 0, jitted),
carried across with ``convert.params_from_numpy``; inputs from numpy.
Bounds: ``REL_L2`` for full-precision logits, ``REL_L2_KV`` through the
int8 cache, ``REL_L2_FLIP`` for quantized whole-model logits
(``tests/test_torch_lm.py`` says why each).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.model_quant import FUSED_PANEL_BUDGET as J_BUDGET
from repro.core.model_quant import quantize_lm as j_quantize_lm
from repro.core.precision import compiler as jcomp
from repro.core.precision.plan import PrecisionPlan as JPlan
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import versaq as tvq
from repro_torch.core.model_quant import FUSED_PANEL_BUDGET, quantize_lm
from repro_torch.core.precision import compiler as tcomp
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.models import lm

from test_torch_launch_serve import _launch
from test_torch_zoo_jamba import _jforward
from test_torch_lm import (
    MAX_INT_FLIPS, REL_L2, REL_L2_FLIP, REL_L2_KV, _compare_trees, flatten_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCHS = ("internlm2-20b", "starcoder2-7b", "musicgen-large")
SMOKES = tuple(a + "-smoke" for a in ARCHS)
PLANS = {"w4a8": dict(default="w4a8", use_kernel=True),
         "fused": dict(default="w4a8", use_kernel=True, fuse=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread: its smoke-size tensors gain
    nothing from more, and under ``pytest -n`` the workers' thread pools
    would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jp = jax.jit(lambda k: jlm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(flatten_jax(jp))


@functools.lru_cache(maxsize=None)
def _trees(arch, policy):
    """fp, or a kernel-routed W4A8 plan (unfused or fused) on both sides:
    the plain versions here, the reference's Pallas kernels in interpret
    mode (its walk jitted)."""
    jcfg, cfg, jp, tp = _setup(arch)
    if policy == "fp":
        return jp, tp
    jt = jax.jit(lambda p: j_quantize_lm(jcfg, p, JPlan(**PLANS[policy])))(jp)
    return jt, quantize_lm(cfg, tp, PrecisionPlan(**PLANS[policy]))


def _tokens(cfg, b=2, n=16, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, n)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SMOKES)
def test_bridged_tree_has_the_references_shapes(arch):
    """``convert`` carries the reference's tree across leaf for leaf (the
    norms' and projections' biases included) and the port's own init builds
    the same layout."""
    _, cfg, jp, tp = _setup(arch)
    jl, jt = jax.tree_util.tree_flatten(flatten_jax(jp))
    bl, bt = jax.tree_util.tree_flatten(params_to_numpy(tp))
    assert jt == bt and all(np.array_equal(a, b) for a, b in zip(jl, bl))
    own = params_to_numpy(lm.init_params(cfg, torch.Generator().manual_seed(0)))
    ol, ot = jax.tree_util.tree_flatten(own)
    assert ot == jt and [np.shape(a) for a in ol] == [np.shape(a) for a in jl]
    mx = tp["blocks"]["l0"]["mixer"]
    assert all((mx[n]["b"] is not None) == cfg.attn_bias for n in ("wq", "wk", "wv", "wo"))
    assert (tp["blocks"]["l0"]["mixer_norm"].b is not None) == cfg.norm_bias
    assert ("w_gate" in tp["blocks"]["l0"]["ffn"]) == (cfg.act == "swiglu")


@pytest.mark.parametrize("policy", ["w4a8", "fused"])
@pytest.mark.parametrize("arch", SMOKES)
def test_quantized_tree_matches_reference(arch, policy):
    """``quantize_lm`` leaf for leaf: integers equal but for ±1 flips,
    scales, biases and float leaves to 1e-5, fusion descriptors equal;
    starcoder2's Q/K/V/O biases ride on their sites (a LayerNorm's β folds
    into Q/K/V's bias too), musicgen's rotated sinusoid table ``pos_rot``
    equals the reference's; at smoke width every panel fits the budget, so
    the fused plan fuses every layer."""
    jt, tt = _trees(arch, policy)
    flips = []
    _compare_trees(jt, tt, "q", flips)
    assert sum(flips) <= MAX_INT_FLIPS, flips
    cfg = get_config(arch)
    mx = tt["blocks"]["l0"]["mixer"]
    qkv_bias = cfg.attn_bias or cfg.norm_bias
    assert (mx["wo"].bias is not None) == cfg.attn_bias
    if policy == "fused":
        assert "wqkv" in mx and isinstance(tt["blocks"]["l0"]["ffn"], tvq.FusedFFN)
        assert mx["wqkv"].prologue.norm == cfg.norm and mx["wo"].epilogue is not None
        assert (mx["wqkv"].bias is not None) == qkv_bias
    else:
        assert all((mx[n].bias is not None) == qkv_bias for n in ("wq", "wk", "wv"))
    assert ("pos_rot" in tt) == (cfg.pos == "sincos")


def _structure(tree, path="q"):
    """A quantized tree's leaf layout: (path, class, static fields, shape,
    dtype) per leaf, for the port's ``meta`` tree and the reference's
    ``jax.eval_shape`` one alike."""
    out = []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, (dict, list)) or dataclasses.is_dataclass(v) or hasattr(v, "shape"):
                out += _structure(v, f"{path}.{f.name}")
            elif f.name != "tiles":  # the kernels' own launch tiles differ by design
                fields[f.name] = v
        out.append((path, type(tree).__name__, tuple(sorted(fields.items()))))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out += _structure(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out += _structure(v, f"{path}[{i}]")
    elif tree is not None:
        out.append((path, tuple(tree.shape), str(tree.dtype).replace("torch.", "")))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_fusion_decisions_match_reference_on_meta(arch):
    """At full width and depth, under ``PrecisionPlan(fuse=True)``: the
    port's walk on the ``meta`` device and the reference's under
    ``jax.eval_shape`` build the same tree, leaf for leaf (class, static
    fields, shape, dtype).  W4 packs half a byte a weight, and a panel over
    ``FUSED_PANEL_BUDGET`` (8 MiB) stays per-site: internlm2's and
    starcoder2's ``wqkv`` (25.2 and 13.0 MB) and FFNs; musicgen's ``wqkv``
    (6.3 MB) fuses with its LayerNorm prologue and ``wo`` (2.1 MB) takes
    its epilogue, its FFN (16.8 MB) does not fuse."""
    assert FUSED_PANEL_BUDGET == J_BUDGET == 8 * 1024 * 1024
    jcfg, cfg = j_get_config(arch), get_config(arch)
    got = tcomp._abstract_quantize(cfg, PrecisionPlan(**PLANS["fused"]))
    want = jcomp._abstract_quantize(jcfg, JPlan(**PLANS["fused"]))
    assert _structure(got) == _structure(want)
    mx, ffn = got["blocks"]["l0"]["mixer"], got["blocks"]["l0"]["ffn"]
    dh = cfg.head_dim
    qkv_bytes = cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh // 2
    fused = qkv_bytes <= FUSED_PANEL_BUDGET
    assert ("wqkv" in mx) == fused == (arch == "musicgen-large"), qkv_bytes
    assert not isinstance(ffn, tvq.FusedFFN)
    if fused:
        assert mx["wqkv"].prologue.norm == "ln" and mx["wo"].epilogue is not None


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,policy", [(a, p) for a in SMOKES for p in ("fp", "w4a8")]
                         + [("musicgen-large-smoke", "fused")])
def test_forward_matches_reference(arch, policy):
    """The full forward: fp at ``REL_L2``, quantized at ``REL_L2_FLIP``;
    musicgen's fused tree too (its LayerNorm prologue with bias in
    ``wqkv``)."""
    jcfg, cfg, _, _ = _setup(arch)
    jt, tt = _trees(arch, policy)
    toks = _tokens(cfg)
    jl = _jforward(jcfg, "full")(jt, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = lm.forward(cfg, tt, torch.as_tensor(toks).long())
    assert tuple(tl.shape) == (2, 16, cfg.vocab_size)
    assert _rel(tl, jl) < (REL_L2 if policy == "fp" else REL_L2_FLIP)


@pytest.mark.parametrize("arch", SMOKES)
def test_prefill_decode_match_reference(arch):
    """fp: a left-padded prefill of 12 tokens and 3 decode steps through
    the int8 KV cache (sinusoid positions shifted per row by the pad for
    musicgen), at ``REL_L2_KV``."""
    jcfg, cfg, _, _ = _setup(arch)
    jt, tt = _trees(arch, "fp")
    toks = _tokens(cfg)
    pad = np.array([0, 4], np.int32)
    jc, tc = jlm.init_cache(jcfg, 2, 16), lm.init_cache(cfg, 2, 16)
    jl, jc = _jforward(jcfg, "prefill")(jt, jnp.asarray(toks[:, :12]), jc, jnp.asarray(pad))
    with torch.inference_mode():
        tl, tc = lm.forward(cfg, tt, torch.as_tensor(toks[:, :12]).long(), cache=tc,
                            mode="prefill", pad_lens=torch.as_tensor(pad).long())
        assert _rel(tl[1, 4:], jl[1, 4:]) < REL_L2_KV and _rel(tl[0], jl[0]) < REL_L2_KV
        for t in range(12, 15):
            jl, jc = _jforward(jcfg, "decode")(jt, jnp.asarray(toks[:, t:t + 1]), jc,
                                               jnp.asarray(pad))
            tl, tc = lm.decode_step(cfg, tt, torch.as_tensor(toks[:, t]).long(), tc,
                                    pad_lens=torch.as_tensor(pad).long())
            assert _rel(tl, jl) < REL_L2_KV, t


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mode", [(a, "continuous") for a in SMOKES]
                         + [("jamba-v0.1-52b-smoke", "bucket")])
def test_launcher_serves_the_new_configs_without_jax(arch, mode):
    """``python -m repro_torch.launch.serve --device cpu --arch <smoke>``
    with the ``quality=fp,balanced=w4a8`` tiers, in a process where JAX
    cannot be imported: 4 requests served; ``auto`` resolves to continuous
    for the dense configs and to bucket mode for jamba, with its reason."""
    out = _launch("--device", "cpu", "--arch", arch, "--tiers", "quality=fp,balanced=w4a8",
                  "--requests", "4", "--prompt-len", "8", "--gen", "4", "--batch", "2",
                  threads=1)
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests -> 16 tokens" in out.stdout
    assert f"scheduler: {mode}" in out.stdout
    if mode == "bucket":
        assert "neither attention-only nor position-free recurrent" in out.stdout
