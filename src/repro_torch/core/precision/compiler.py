"""Kernel-plan compiler: lower ``(ModelConfig, PrecisionPlan)`` to a
serialized :class:`KernelSchedule` (port of
``repro/core/precision/compiler.py``).

It makes every static co-design decision — per-site precision,
unified-datapath fusion eligibility, kernel launch tiles — *once*,
explicitly, and writes it down:

    plan ──lower──▶ KernelSchedule ──(optional) tune──▶ tiles from DB
                         │
                         ▼ load at engine boot (zero per-boot planning)
              quantize_vggt consumes the schedule's decisions

**Lowering** runs the real quantization walker on the ``meta`` device —
an abstract init of the model's shapes (``vggt.init_params`` or
``lm.init_params`` with ``device="meta"``), zero FLOPs, zero allocation —
and reads the decisions off the abstract quantized tree: a merged
``wqkv`` site means QKV fused, a ``FusedFFN`` node means the FFN fused,
and a site that *didn't* fuse gets its reason recomputed from the same
eligibility predicates the walker used.  The schedule therefore cannot
disagree with what ``quantize_vggt`` or ``quantize_lm`` would have done.
The LM walk covers every LM of the registry: GQA and MLA attention, Mamba
and rwkv mixers with dense, MoE and rwkv channel-mix FFNs.

**Tiles** are the launch tiles of the kernel each site runs
(``kernels.ops.launch_tiles``): ``quant_matmul``'s for a plain integer
site (a MoE layer's routed experts too: their batched launch runs the
same tiles), ``fused_matmul``'s for a site with a prologue or epilogue (a fused
QKV group, ``wo`` with its in-kernel IDCT/bias), ``fused_ffn``'s for a
fused FFN group, the two-stage kernel's for attention.  A tuner replaces
them with its DB's winners.  Sites off the kernels (``fp``, the float
``emulation``) carry none.  The reference's TPU tiles (``bm_target`` and
friends) are tilings of Pallas kernels the port does not have: an engine
refuses a schedule compiled for ``interpret`` or ``tpu``.

The schedule is canonical JSON (ints/strings/bools only, sorted keys) so
its SHA-256 ``hash`` is stable across processes — engines key their
bucket caches on it and CI diffs compiled schedules against goldens.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.model_quant import FUSED_PANEL_BUDGET, _panel_bytes, _same_mode
from repro_torch.core.precision.plan import PrecisionPlan, parse_level
from repro_torch.core.versaq import FusedFFN, QuantLinear
from repro_torch.kernels import ops as kernel_ops

__all__ = [
    "SiteSchedule",
    "FusedGroupSchedule",
    "AttentionSchedule",
    "KernelSchedule",
    "compile_schedule",
]

SCHEDULE_VERSION = 1
# What the port's schedules are compiled for; the reference writes
# ``interpret`` (CPU) or ``tpu``.
BACKENDS = ("cuda", "cpu")


def _tiles_tuple(tiles: Optional[dict]) -> Optional[tuple]:
    """Canonical hashable form: key-sorted tuple of (key, int) pairs."""
    if not tiles:
        return None
    return tuple(sorted((k, int(v)) for k, v in tiles.items()))


@dataclasses.dataclass(frozen=True)
class SiteSchedule:
    """One weight site's compiled kernel configuration."""

    site: str
    level: str  # bf16 | w<bits>a<bits>
    kernel: str  # fp | emulation | matmul | fused
    d_in: int
    d_out: int
    count: int  # stacked copies behind this entry (layer groups × experts)
    packed: bool = False
    rotate_input: bool = False
    idct: bool = False
    prologue: Optional[dict] = None  # fused prologue descriptor (norm/eps)
    epilogue: Optional[dict] = None  # fused epilogue descriptor
    tiles: Optional[tuple] = None  # (("bk", 64), ("bm", 128), ("bn", 256))
    fused_group: Optional[str] = None
    fallback: Optional[str] = None  # why a requested fusion didn't happen

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["tiles"] = dict(self.tiles) if self.tiles else None
        return d

    @classmethod
    def from_json(cls, d: dict) -> "SiteSchedule":
        d = dict(d)
        d["tiles"] = _tiles_tuple(d.get("tiles"))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FusedGroupSchedule:
    """A realized multi-site fusion (merged QKV launch or one-launch FFN).

    Only groups that *did* fuse appear in the schedule; a requested-but-
    fallen-back group records its reason on the member sites instead.
    ``wo_epilogue`` (qkv kind) mirrors the walker's follow-on decision to
    run the output projection's IDCT/bias epilogue in-kernel.
    """

    name: str
    kind: str  # qkv | ffn
    members: tuple[str, ...]
    tiles: Optional[tuple] = None
    wo_epilogue: bool = False

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["members"] = list(self.members)
        d["tiles"] = dict(self.tiles) if self.tiles else None
        return d

    @classmethod
    def from_json(cls, d: dict) -> "FusedGroupSchedule":
        d = dict(d)
        d["members"] = tuple(d["members"])
        d["tiles"] = _tiles_tuple(d.get("tiles"))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class AttentionSchedule:
    """Two-stage attention launch tiles (``ModelConfig.attn_tiles``)."""

    impl: str
    tiles: tuple = ()

    def to_json(self) -> dict:
        return {"impl": self.impl, "tiles": dict(self.tiles) if self.tiles else None}

    @classmethod
    def from_json(cls, d: dict) -> "AttentionSchedule":
        return cls(impl=d["impl"], tiles=_tiles_tuple(d.get("tiles")) or ())


# the dotted-name part of a MoE layer's routed-expert sites
_EXPERTS = ".ffn.experts."


def _kernel_level(level: str) -> bool:
    """A level whose integer matmul the CUDA kernels take (bits <= 8)."""
    bits = parse_level(level)
    return bits is not None and max(bits) <= 8


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """The compiled artifact: every kernel decision for one (arch, plan).

    Duck-typed as a quantization policy — ``quantize_vggt`` and the
    serving engine accept it anywhere a ``PrecisionPlan`` is accepted
    (``core.model_quant._Resolver`` detects ``fuse_decision``), but read
    fusion decisions and tiles from the schedule instead of re-deriving
    them.
    """

    arch: str
    plan: PrecisionPlan
    backend: str = "cuda"
    sites: tuple[SiteSchedule, ...] = ()
    groups: tuple[FusedGroupSchedule, ...] = ()
    attention: Optional[AttentionSchedule] = None
    version: int = SCHEDULE_VERSION

    # ---- policy duck-typing (consumed by model_quant._Resolver) ---------

    @property
    def method(self) -> str:
        return self.plan.method

    @property
    def fuse(self) -> bool:
        return self.plan.fuse

    @property
    def use_kernel(self) -> bool:
        return self.plan.use_kernel

    @property
    def name(self) -> str:
        return self.plan.name

    @property
    def tag(self) -> str:
        return f"sched:{self.plan.tag}@{self.hash[:8]}"

    def policy_for(self, site: str):
        return self.plan.policy_for(site)

    def site(self, name: str) -> Optional[SiteSchedule]:
        return self._by_site().get(name)

    def tiles_for(self, name: str) -> Optional[tuple]:
        s = self._by_site().get(name)
        return s.tiles if s is not None else None

    def fuse_decision(self, group: str) -> tuple[bool, Optional[FusedGroupSchedule]]:
        g = self._by_group().get(group)
        return (g is not None), g

    def attention_targets(self) -> Optional[tuple]:
        """Tiles for ``ModelConfig.attn_tiles`` (None = the kernel's own)."""
        if self.attention is None or not self.attention.tiles:
            return None
        return self.attention.tiles

    def check_servable(self) -> None:
        """Raise unless the port's kernels can run this schedule: one the
        JAX package compiled (backend ``interpret`` or ``tpu``) carries
        TPU tilings of the Pallas kernels."""
        if self.backend not in BACKENDS:
            raise ValueError(
                f"schedule {self.arch!r} x {self.plan.tag} was compiled for backend "
                f"{self.backend!r}, whose tiles are TPU tilings; recompile it with "
                "python -m repro_torch.launch.compile"
            )

    def launches_per_forward(self, *, two_stage_attention: bool,
                             decode: bool = False) -> dict[str, int]:
        """Kernel launches one forward makes under this schedule — for an
        LM, one prefill wave or one decode step.

        One ``fused_matmul`` per fused QKV group and one ``fused_ffn`` per
        fused FFN group a layer; per other kernel-routed site one
        ``fused_matmul`` (a site with a prologue or epilogue, e.g. ``wo``
        with its in-kernel IDCT/bias) or ``quant_matmul`` a layer; a MoE
        layer's routed-expert site makes one ``quant_matmul_batched``
        launch a layer for all its experts (``count / n_experts``, the
        layer's own count), not ``count`` 2-D launches.  With
        ``two_stage_attention`` one launch per attention layer whose Q is
        quantized: a VGGT forward with ``attn_impl="two_stage"`` and no
        padding mask, or an LM scoring forward (``lm.forward(mode=
        "full")``).  The served LM prefill and decode attend over the int8
        KV cache with the masked emulation and never reach the two-stage
        kernel: count them with ``two_stage_attention=False``.  MLA layers
        never reach it (their full and prefill modes attend in float, as
        the reference's), and their absorbed decode reads ``w_k_up`` and
        ``w_v_up`` as dequantized weights: with ``decode`` those two sites
        launch nothing (a served MLA decode step; also a one-token
        prefill, which the reference absorbs too)."""
        out: dict[str, int] = {}
        mla = {s.site.rsplit(".", 1)[0] for s in self.sites if s.site.endswith(".w_kv_down")}

        def add(kernel: str, n: int) -> None:
            out[kernel] = out.get(kernel, 0) + n

        for g in self.groups:
            members = [self.site(m) for m in g.members]
            if all(_kernel_level(m.level) for m in members):
                add("fused_matmul" if g.kind == "qkv" else "fused_ffn", members[0].count)
        for s in self.sites:
            if s.fused_group is None and s.kernel == "matmul" and _kernel_level(s.level):
                layer, name = s.site.rsplit(".", 1)
                if decode and layer in mla and name in ("w_k_up", "w_v_up"):
                    continue
                if _EXPERTS in s.site:
                    add("quant_matmul_batched", self._layer_count(s.site))
                    continue
                fused = s.prologue is not None or s.epilogue is not None
                add("fused_matmul" if fused else "quant_matmul", s.count)
        if two_stage_attention:
            for s in self.sites:
                layer, name = s.site.rsplit(".", 1)
                if name == "wq" and s.kernel != "fp" and layer not in mla:
                    add("two_stage_attention", s.count)
        return out

    def _layer_count(self, expert_site: str) -> int:
        """Stacked layers behind a routed-expert site: the count of its
        layer's mixer sites (the expert site's own count is layers x
        experts)."""
        layer = expert_site.split(_EXPERTS)[0] + ".mixer."
        return next(s.count for s in self.sites if s.site.startswith(layer))

    def _by_site(self) -> dict:
        cache = self.__dict__.get("_site_index")
        if cache is None:
            cache = {s.site: s for s in self.sites}
            object.__setattr__(self, "_site_index", cache)
        return cache

    def _by_group(self) -> dict:
        cache = self.__dict__.get("_group_index")
        if cache is None:
            cache = {g.name: g for g in self.groups}
            object.__setattr__(self, "_group_index", cache)
        return cache

    # ---- serialization ---------------------------------------------------

    def canonical(self) -> dict:
        """The serialized form: pure ints/strings/bools, insertion-stable."""
        return {
            "version": self.version,
            "arch": self.arch,
            "backend": self.backend,
            "plan": json.loads(self.plan.to_json()),
            "attention": self.attention.to_json() if self.attention else None,
            "groups": [g.to_json() for g in self.groups],
            "sites": [s.to_json() for s in self.sites],
        }

    @property
    def hash(self) -> str:
        cache = self.__dict__.get("_hash")
        if cache is None:
            blob = json.dumps(self.canonical(), sort_keys=True, separators=(",", ":"))
            cache = hashlib.sha256(blob.encode()).hexdigest()
            object.__setattr__(self, "_hash", cache)
        return cache

    def to_json(self) -> str:
        return json.dumps(self.canonical(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "KernelSchedule":
        d = json.loads(text)
        if d.get("version") != SCHEDULE_VERSION:
            raise ValueError(f"schedule version {d.get('version')!r} != {SCHEDULE_VERSION}")
        return cls(
            arch=d["arch"],
            plan=PrecisionPlan.from_json(json.dumps(d["plan"])),
            backend=d.get("backend", "interpret"),
            sites=tuple(SiteSchedule.from_json(s) for s in d["sites"]),
            groups=tuple(FusedGroupSchedule.from_json(g) for g in d["groups"]),
            attention=(
                AttentionSchedule.from_json(d["attention"]) if d.get("attention") else None
            ),
            version=d["version"],
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "KernelSchedule":
        with open(path) as f:
            return cls.from_json(f.read())

    def summary(self) -> dict:
        """Count sites by kernel choice (the printable one-liner)."""
        out: dict[str, int] = {}
        for s in self.sites:
            out[s.kernel] = out.get(s.kernel, 0) + 1
        return out


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


def _abstract_quantize(cfg: ModelConfig, plan: PrecisionPlan):
    """The quantized tree as shapes only: the real walker over an abstract
    init on the ``meta`` device, so every fusion decision is the walker's
    own.  ``init_params`` draws nothing there: meta tensors carry shapes
    and dtypes, and the generator is never read."""
    from repro_torch.core.model_quant import quantize_lm, quantize_vggt
    from repro_torch.models import lm, vggt

    with torch.no_grad():
        if cfg.vggt:
            return quantize_vggt(cfg, vggt.init_params(cfg, torch.Generator(), device="meta"),
                                 plan)
        return quantize_lm(cfg, lm.init_params(cfg, torch.Generator(), device="meta"), plan)


def _leaf_dims(p) -> tuple[int, int, int]:
    """(d_in, d_out, stacked_count) for a prepared site leaf."""
    if isinstance(p, QuantLinear):
        vs = p.qw.values.shape
        d_in = vs[-2] * (2 if p.qw.packed else 1)
        count = 1
        for s in vs[:-2]:
            count *= int(s)
        return int(d_in), int(vs[-1]), count
    w = p["w"]
    count = 1
    for s in w.shape[:-2]:
        count *= int(s)
    return int(w.shape[-2]), int(w.shape[-1]), count


def _descr(obj) -> Optional[dict]:
    """Prologue/Epilogue dataclass -> plain JSON dict."""
    return None if obj is None else dataclasses.asdict(obj)


class _Lowering:
    """Accumulates site/group entries while walking the abstract tree."""

    def __init__(self, cfg: ModelConfig, plan: PrecisionPlan, tuner):
        self.cfg = cfg
        self.plan = plan
        self.tuner = tuner
        self.sites: list[SiteSchedule] = []
        self.groups: list[FusedGroupSchedule] = []

    def _site_tiles(self, leaf: QuantLinear, d_in: int, d_out: int,
                    experts: Optional[int] = None) -> Optional[tuple]:
        """The launch tiles of the kernel ``apply_linear`` sends the site
        to: ``fused_matmul`` with a prologue or epilogue, else
        ``quant_matmul`` (``experts`` stacked: its batched launch)."""
        fused = leaf.prologue is not None or leaf.epilogue is not None
        norm = leaf.prologue.norm if leaf.prologue is not None else None
        if experts is not None and self.tuner is not None:
            tiles = self.tuner.tune_matmul_batched(d_in, d_out, experts=experts,
                                                   w_bits=leaf.qw.bits, a_bits=leaf.a_bits,
                                                   packed=leaf.qw.packed)
        elif self.tuner is not None:
            tiles = self.tuner.tune_matmul(d_in, d_out, w_bits=leaf.qw.bits, a_bits=leaf.a_bits,
                                           packed=leaf.qw.packed, fused=fused, norm=norm)
        else:
            tiles = kernel_ops.launch_tiles("fused_matmul" if fused else "quant_matmul")
        return _tiles_tuple(tiles)

    def _ffn_tiles(self, f: FusedFFN) -> Optional[tuple]:
        d, dff, _ = _leaf_dims(f.w_up)
        if self.tuner is not None:
            tiles = self.tuner.tune_ffn(
                d, dff, _leaf_dims(f.w_down)[1], w_bits_up=f.w_up.qw.bits,
                w_bits_down=f.w_down.qw.bits, a_bits_in=f.w_up.a_bits,
                a_bits_mid=f.w_down.a_bits, gated=f.w_gate is not None, norm=f.norm,
            )
        else:
            tiles = kernel_ops.launch_tiles("fused_ffn")
        return _tiles_tuple(tiles)

    def emit(self, site: str, leaf, *, fused_group=None, fallback=None,
             tiles=None, d_in=None, d_out=None, count=None) -> None:
        """One SiteSchedule from a prepared leaf (QuantLinear or fp dict)."""
        if d_in is None:
            d_in, d_out, count = _leaf_dims(leaf)
        level = self.plan.resolve(site)
        if not isinstance(leaf, QuantLinear):
            self.sites.append(SiteSchedule(
                site=site, level="bf16", kernel="fp",
                d_in=d_in, d_out=d_out, count=count, fallback=fallback,
            ))
            return
        if fused_group is not None:
            kernel = "fused"
        elif leaf.use_kernel:
            kernel = "matmul"
        else:
            kernel = "emulation"
        if tiles is None and kernel == "matmul":
            tiles = self._site_tiles(leaf, d_in, d_out)
        self.sites.append(SiteSchedule(
            site=site, level=level, kernel=kernel,
            d_in=d_in, d_out=d_out, count=count,
            packed=leaf.qw.packed, rotate_input=leaf.rotate_input,
            idct=leaf.idct,
            prologue=_descr(leaf.prologue), epilogue=_descr(leaf.epilogue),
            tiles=tiles, fused_group=fused_group, fallback=fallback,
        ))

    # ---- attention mixers -------------------------------------------------

    def attn(self, pfx: str, mx: dict) -> None:
        """GQA attention: fused (merged wqkv present) or per-site."""
        cfg = self.cfg
        dh = cfg.head_dim
        widths = {
            "wq": cfg.n_heads * dh,
            "wk": cfg.n_kv_heads * dh,
            "wv": cfg.n_kv_heads * dh,
        }
        if "wqkv" in mx:
            ql: QuantLinear = mx["wqkv"]
            group = f"{pfx}.wqkv"
            d_in, _, count = _leaf_dims(ql)
            tiles = self._site_tiles(ql, d_in, sum(widths.values()))
            wo = mx["wo"]
            wo_epi = isinstance(wo, QuantLinear) and wo.epilogue is not None
            self.groups.append(FusedGroupSchedule(
                name=group, kind="qkv",
                members=tuple(f"{pfx}.{n}" for n in widths),
                tiles=tiles, wo_epilogue=wo_epi,
            ))
            for name, width in widths.items():
                self.emit(f"{pfx}.{name}", ql, fused_group=group, tiles=tiles,
                          d_in=d_in, d_out=width, count=count)
            self.emit(f"{pfx}.wo", wo)
            return
        parts = [mx["wq"], mx["wk"], mx["wv"]]
        fallback = None
        if self.plan.fuse:
            count = _leaf_dims(mx["wo"])[2]
            fallback = _qkv_fallback(parts, count if count > 1 else None)
        for name in ("wq", "wk", "wv"):
            self.emit(f"{pfx}.{name}", mx[name], fallback=fallback)
        self.emit(f"{pfx}.wo", mx["wo"])

    def ffn_dense(self, pfx: str, f) -> None:
        if isinstance(f, FusedFFN):
            group = f"{pfx}"
            members = {"w_up": f.w_up, "w_down": f.w_down}
            if f.w_gate is not None:
                members["w_gate"] = f.w_gate
            tiles = self._ffn_tiles(f)
            self.groups.append(FusedGroupSchedule(
                name=group, kind="ffn",
                members=tuple(f"{pfx}.{n}" for n in sorted(members)),
                tiles=tiles,
            ))
            for name in sorted(members):
                self.emit(f"{pfx}.{name}", members[name], fused_group=group, tiles=tiles)
            return
        fallback = None
        if self.plan.fuse:
            count = _leaf_dims(f["w_down"])[2]
            fallback = _ffn_fallback(f, count if count > 1 else None)
        for name in ("w_gate", "w_up", "w_down"):
            if name in f:
                self.emit(f"{pfx}.{name}", f[name], fallback=fallback)

    def plain(self, pfx: str, node: dict, names: tuple[str, ...]) -> None:
        for name in names:
            self.emit(f"{pfx}.{name}", node[name])

    def experts(self, pfx: str, ex: dict) -> None:
        """A MoE layer's routed experts: one batched ``quant_matmul``
        launch a projection, tuned under its own signature."""
        for name in ("w_gate", "w_up", "w_down"):
            if name not in ex:
                continue
            leaf = ex[name]
            tiles = None
            if isinstance(leaf, QuantLinear) and leaf.use_kernel:
                d_in, d_out, _ = _leaf_dims(leaf)
                tiles = self._site_tiles(leaf, d_in, d_out,
                                         experts=int(leaf.qw.values.shape[-3]))
            self.emit(f"{pfx}.{name}", leaf, tiles=tiles)


def _qkv_fallback(parts, groups) -> Optional[str]:
    """Why a requested QKV fusion fell back (mirrors ``_fuse_qkv``)."""
    if not _same_mode(parts):
        return "qkv members differ in precision/mode"
    if sum(_panel_bytes(p, groups) for p in parts) > FUSED_PANEL_BUDGET:
        return "qkv panel exceeds fused VMEM budget"
    return None


def _ffn_fallback(f: dict, groups) -> Optional[str]:
    """Why a requested FFN fusion fell back (mirrors ``_fuse_ffn``)."""
    gate, up, down = f.get("w_gate"), f.get("w_up"), f.get("w_down")
    parts = [p for p in (gate, up, down) if p is not None]
    if not all(isinstance(p, QuantLinear) for p in parts):
        return "bf16 member keeps ffn per-site"
    if gate is not None and not _same_mode([gate, up]):
        return "gate/up precision mismatch"
    if up.dct_block != down.dct_block:
        return "up/down dct_block mismatch"
    if sum(_panel_bytes(p, groups) for p in parts) > FUSED_PANEL_BUDGET:
        return "ffn panel exceeds fused VMEM budget"
    return None


def _lower_lm(low: _Lowering, q: dict) -> None:
    """The reference's LM walk over the prefix layers and the stacked
    pattern positions: GQA attention through :meth:`_Lowering.attn`, MLA's
    five sites, Mamba's ``w_in``/``w_out`` and the rwkv sites plain (never
    fused), dense FFNs through :meth:`_Lowering.ffn_dense`, a MoE layer's
    routed and shared experts site by site."""
    from repro_torch.models import lm

    cfg = low.cfg
    layers = [(f"prefix.{i}", q["prefix"][i], lm.mixer_kind(cfg, i), lm.ffn_kind(cfg, i))
              for i in range(cfg.first_dense)]
    for j in range(len(cfg.pattern)):
        gi = cfg.first_dense + j
        layers.append((f"blocks.l{j}", q["blocks"][f"l{j}"], lm.mixer_kind(cfg, gi),
                       lm.ffn_kind(cfg, gi)))
    for pfx, lp, kind, fk in layers:
        mx = lp["mixer"]
        if kind == "attn" and cfg.mla:  # never fused, as in the reference
            low.plain(f"{pfx}.mixer", mx, ("wq", "w_kv_down", "w_k_up", "w_v_up", "wo"))
        elif kind == "attn":
            low.attn(f"{pfx}.mixer", mx)
        elif kind == "mamba":
            low.plain(f"{pfx}.mixer", mx, ("w_in", "w_out"))
        elif kind == "rwkv":
            low.plain(f"{pfx}.mixer", mx, ("wr", "wk", "wv", "wg", "wo"))
        f = lp["ffn"]
        if fk in ("dense", "dense_inner"):
            low.ffn_dense(f"{pfx}.ffn", f)
        elif fk == "moe":
            low.experts(f"{pfx}.ffn.experts", f["experts"])
            if "shared" in f:
                low.plain(f"{pfx}.ffn.shared", f["shared"],
                          tuple(n for n in ("w_gate", "w_up", "w_down") if n in f["shared"]))
        elif fk == "rwkv_channel":
            low.plain(f"{pfx}.ffn", f, ("w_up", "w_down"))


def _lower_vggt(low: _Lowering, q: dict) -> None:
    for blk in ("frame", "global"):
        bp = q["blocks"][blk]
        low.attn(f"{blk}.attn", bp["attn"])
        low.ffn_dense(f"{blk}.ffn", bp["ffn"])


def compile_schedule(
    cfg: ModelConfig,
    plan: PrecisionPlan,
    *,
    tuner=None,
    backend: Optional[str] = None,
) -> KernelSchedule:
    """Lower ``(cfg, plan)`` to an explicit :class:`KernelSchedule`.

    ``tuner`` is an optional :class:`~.tuner.Autotuner`; without it every
    kernel-routed site records its kernel's launch tiles.  ``backend``
    labels the schedule (``cuda``, the default, or ``cpu``; the tuner's,
    when one is given) — it is part of the tuning-DB key but not of the
    lowering itself.
    """
    if not hasattr(plan, "policy_for"):
        raise TypeError(f"compile_schedule needs a PrecisionPlan, got {type(plan)!r}")
    if backend is None:
        backend = tuner.backend if tuner is not None else "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port compiles for one of {BACKENDS}")
    q = _abstract_quantize(cfg, plan)
    low = _Lowering(cfg, plan, tuner)
    (_lower_vggt if cfg.vggt else _lower_lm)(low, q)
    attention = None
    if cfg.vggt or "attn" in cfg.pattern:
        if tuner is not None:
            atiles = tuner.tune_attention(cfg.head_dim)
        else:
            atiles = kernel_ops.launch_tiles("two_stage_attention")
        attention = AttentionSchedule(impl=cfg.attn_impl, tiles=_tiles_tuple(atiles))
    if tuner is not None:
        tuner.flush()
    return KernelSchedule(
        arch=cfg.name,
        plan=plan,
        backend=backend,
        sites=tuple(low.sites),
        groups=tuple(low.groups),
        attention=attention,
    )
