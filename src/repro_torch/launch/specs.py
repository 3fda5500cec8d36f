"""(arch x shape) cell definitions for the multi-pod dry run, and the
serving-precision specs (port of ``repro/launch/specs.py``).

Each cell binds: the step function (a train step, a prefill or a decode
step, VGGT's serve forward or train step), its arguments as DTensors over
``meta`` tensors (shapes only: **nothing is allocated**) placed on a mesh
by ``parallel/sharding.py``'s specs as the reference's ``in_shardings``
place them, and the (arch, shape) names.  Parameters come from
``init_params`` at bf16 on ``meta``, and serve cells quantize them with
``quantize_lm``/``quantize_vggt`` at W4A8 (``--fp-serve``: bf16), as the
reference's ``eval_shape`` does; quantization and the forwards run on
``meta`` as they are (no host round trip in either touches a value).
``launch/dryrun.py`` runs each step under ``roofline_util.StepCounter``.

Shape set (assignment):
  train_4k     seq 4096  x global_batch 256   -> train step (bf16 + AdamW)
  prefill_32k  seq 32768 x global_batch 32    -> serve prefill (W4A8)
  decode_32k   seq 32768 x global_batch 128   -> serve step, 1 new token
  long_500k    seq 524288 x global_batch 1    -> serve step; SSM/hybrid only

``applicable()`` encodes the assignment's skip rules (long_500k needs
sub-quadratic attention -> jamba/rwkv6 only; every assigned arch is
decoder-style so decode shapes always apply).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "VGGT_SHAPES", "VGGT_PATCHES", "SUBQUADRATIC", "applicable",
           "Cell", "make_cell", "reduced_cfg", "place", "held_bytes", "vggt_stream_specs",
           "SERVE_SPEC_GRAMMAR", "ServeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | vggt_serve | vggt_train
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC = {"jamba-v0.1-52b", "rwkv6-1.6b"}


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape.startswith("vggt") != bool(cfg.vggt):
        return False, "vggt shapes pair with the vggt arch only"
    if shape == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, (
            "pure full-attention arch: a 524k dense-softmax KV pass is the "
            "quadratic wall itself (DESIGN.md §4); runs for SSM/hybrid only"
        )
    return True, ""


# --- DTensors over meta tensors ---------------------------------------------


def place(tree: Any, mesh, spec_fn: Callable) -> Any:
    """Every tensor leaf of ``tree`` (on ``meta``) as a DTensor placed by
    ``spec_fn(path, leaf)`` (a ``parallel.sharding`` spec): its local
    tensor is a new ``meta`` tensor of the rank's local shape.  No
    collective runs and nothing is allocated."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.parallel import sharding
    from repro_torch.tree import tree_map_with_path

    def one(path, x):
        pls = sharding.placements(mesh, spec_fn(path, x))
        local, _ = compute_local_shape_and_global_offset(x.shape, mesh, pls)
        return DTensor.from_local(torch.empty(local, dtype=x.dtype, device="meta"), mesh, pls,
                                  run_check=False, shape=x.shape, stride=x.stride())

    return tree_map_with_path(one, tree)


def held_bytes(tree: Any) -> int:
    """The bytes one rank holds of ``tree``: its local shards."""
    from repro_torch.sharded import is_dtensor
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in (
        x.to_local() if is_dtensor(x) else x for x in tree_leaves(tree)))


def _fixed(spec: tuple) -> Callable:
    return lambda path, x: spec


@dataclasses.dataclass
class Cell:
    """Everything ``dryrun.py`` needs to run one (arch x shape x mesh):
    ``fn(*args)`` is the step; ``held`` the bytes one rank holds of each
    argument (parameters, optimizer state, cache, batch)."""

    fn: Callable
    args: tuple  # DTensors over meta tensors
    arch: str
    shape: str
    held: dict = dataclasses.field(default_factory=dict)


def _cfg2(cfg: ModelConfig, attn, attn_bf16: bool = False) -> ModelConfig:
    # attn_use_kernel=False, as the reference: the float emulation's chunk
    # loop is counted rather than one opaque kernel call
    cfg2 = cfg.with_(attn_impl=attn, attn_use_kernel=False) if attn else cfg
    return cfg2.with_(attn_dtype="bf16") if attn_bf16 else cfg2


def _tokens(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.embed_inputs:
        return torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16, device="meta")
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def _train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, seq_sp=True, zero1=False,
                remat=True, attn=None) -> Cell:
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import lm_loss, make_train_step

    dp = sharding.batch_axes(mesh)
    act = sharding.NamedSharding(mesh, sharding.act_pspec(mesh, seq_shard=seq_sp))
    cfg2 = _cfg2(cfg, attn)
    step = make_train_step(cfg2, adamw.AdamWConfig(), loss_fn=functools.partial(
        lm_loss, cfg2, remat=remat, act_sharding=act))

    params = lm.init_params(cfg, torch.Generator(), device="meta", dtype=torch.bfloat16)
    opt = adamw.init(params)
    batch = {"tokens": _tokens(cfg, shape.batch, shape.seq),
             "labels": torch.empty((shape.batch, shape.seq), dtype=torch.int32, device="meta")}
    p_s = place(params, mesh, sharding.param_pspec)
    o_s = adamw.AdamWState(
        step=place(opt.step, mesh, _fixed(())),
        m=place(opt.m, mesh, sharding.zero1_pspec if zero1 else sharding.param_pspec),
        v=place(opt.v, mesh, sharding.zero1_pspec if zero1 else sharding.param_pspec))
    b_s = {"tokens": place(batch["tokens"], mesh, _fixed(
               (dp, None, None) if cfg.embed_inputs else (dp, None))),
           "labels": place(batch["labels"], mesh, _fixed((dp, None)))}
    return Cell(fn=step, args=(p_s, o_s, b_s), arch=cfg.name, shape=shape.name,
                held={"params": held_bytes(p_s), "opt_state": held_bytes(o_s),
                      "batch": held_bytes(b_s)})


def _serve_params(cfg: ModelConfig, fp_serve: bool, vggt: bool = False):
    """Serving parameters on ``meta`` — W4A8 as the port serves it
    (``ServeSpec.parse("w4a8").materialize()``: every site on its kernel) by
    default, bf16 for the unquantized comparison baseline."""
    from repro_torch.core.model_quant import quantize_lm, quantize_vggt
    from repro_torch.models import lm
    from repro_torch.models import vggt as vggt_mod

    model, quant = (vggt_mod, quantize_vggt) if vggt else (lm, quantize_lm)
    p = model.init_params(cfg, torch.Generator(), device="meta", dtype=torch.bfloat16)
    return p if fp_serve else quant(cfg, p, ServeSpec.parse("w4a8").materialize())


def _prefill_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, kv_dtype=None, fp_serve=False,
                  act_sp=False, attn=None, attn_bf16=False) -> Cell:
    from repro_torch.models import lm
    from repro_torch.parallel import sharding

    params = _serve_params(cfg, fp_serve)
    cache = lm.init_cache(cfg, shape.batch, shape.seq, kv_dtype or torch.int8, device="meta")
    cfg2 = _cfg2(cfg, attn, attn_bf16)
    act = (sharding.NamedSharding(mesh, sharding.act_pspec(mesh, seq_shard=True))
           if act_sp else None)

    def prefill_step(params, tokens, cache):
        return lm.forward(cfg2, params, tokens, cache=cache, mode="prefill", act_sharding=act)

    dp = sharding.batch_axes(mesh)
    p_s = place(params, mesh, sharding.param_pspec)
    t_s = place(_tokens(cfg, shape.batch, shape.seq), mesh, _fixed(
        (dp, None, None) if cfg.embed_inputs else (dp, None)))
    c_s = place(cache, mesh, sharding.spec_at(
        sharding.cache_pspecs(cfg, cache, mesh, seq_axis_shard=False)))
    return Cell(fn=prefill_step, args=(p_s, t_s, c_s), arch=cfg.name, shape=shape.name,
                held={"params": held_bytes(p_s), "cache": held_bytes(c_s),
                      "batch": held_bytes(t_s)})


def _decode_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, kv_dtype=None, fp_serve=False,
                 kv_seq_model=False, attn=None) -> Cell:
    from repro_torch.models import lm
    from repro_torch.parallel import sharding

    params = _serve_params(cfg, fp_serve)
    cache = lm.init_cache(cfg, shape.batch, shape.seq, kv_dtype or torch.int8, device="meta")
    tok = _tokens(cfg, shape.batch, 1) if cfg.embed_inputs else torch.empty(
        (shape.batch,), dtype=torch.int32, device="meta")
    cfg2 = _cfg2(cfg, attn)

    def serve_step(params, token, cache):
        token2 = token[:, None] if not cfg.embed_inputs and token.ndim == 1 else token
        return lm.forward(cfg2, params, token2, cache=cache, mode="decode")

    # batch=1 long-context: shard the cache sequence dim (SP flash-decode);
    # batched decode: shard the cache batch dim over DP
    seq_sp = shape.batch == 1
    dp = sharding.batch_axes(mesh)
    p_s = place(params, mesh, sharding.param_pspec)
    t_spec = ((dp, None, None) if cfg.embed_inputs else (dp,)) if not seq_sp else (
        (None, None, None) if cfg.embed_inputs else (None,))
    t_s = place(tok, mesh, _fixed(t_spec))
    c_s = place(cache, mesh, sharding.spec_at(sharding.cache_pspecs(
        cfg, cache, mesh, seq_axis_shard=seq_sp, seq_model_shard=kv_seq_model)))
    return Cell(fn=serve_step, args=(p_s, t_s, c_s), arch=cfg.name, shape=shape.name,
                held={"params": held_bytes(p_s), "cache": held_bytes(c_s),
                      "batch": held_bytes(t_s)})


# --- VGGT (the paper's model): serve = one feed-forward pass per scene
# batch; global attention sequence = S*(P+5) tokens --------------------------

VGGT_SHAPES = {
    "vggt_serve_s8": ShapeSpec("vggt_serve_s8", "vggt_serve", 8, 32),  # seq=S frames, batch=scenes
    "vggt_serve_s32": ShapeSpec("vggt_serve_s32", "vggt_serve", 32, 4),
    "vggt_train_s4": ShapeSpec("vggt_train_s4", "vggt_train", 4, 64),
}
SHAPES.update(VGGT_SHAPES)
VGGT_PATCHES = 1024


def vggt_stream_specs(mesh, batch: int) -> tuple[tuple, tuple]:
    """(the scene stream's spec [B, S, P, d], its act-SP spec): the batch
    over the data axes, or, for scene batches the data axes do not divide,
    the FRAME dim over data (and the batch over ``pod`` where it divides)."""
    from repro_torch.parallel import sharding

    dp = sharding.batch_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.size(names.index(a))
    if batch % dp_size == 0:
        return (sharding.batch_pspec(mesh)[0], None, None, None), (
            sharding.batch_pspec(mesh)[0], None, "model", None)
    pod = "pod" if ("pod" in names and batch % mesh.size(names.index("pod")) == 0) else None
    return (pod, "data", None, None), (pod, "data", "model", None)


def _vggt_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, fp_serve=False, act_sp=False,
               attn=None, **_) -> Cell:
    from repro_torch.models import vggt as vggt_mod
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import make_train_step

    s_frames, batch = shape.seq, shape.batch
    cfg2 = _cfg2(cfg, attn)
    bspec, actspec = vggt_stream_specs(mesh, batch)
    act = sharding.NamedSharding(mesh, actspec) if act_sp else None
    patches = torch.empty((batch, s_frames, VGGT_PATCHES, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
    if shape.kind == "vggt_serve":
        def serve_step(params, patches):
            return vggt_mod.forward(cfg2, params, patches, act_sharding=act)

        p_s = place(_serve_params(cfg, fp_serve, vggt=True), mesh, sharding.param_pspec)
        x_s = place(patches, mesh, _fixed(bspec))
        return Cell(fn=serve_step, args=(p_s, x_s), arch=cfg.name, shape=shape.name,
                    held={"params": held_bytes(p_s), "batch": held_bytes(x_s)})

    # vggt_train
    params = vggt_mod.init_params(cfg, torch.Generator(), device="meta", dtype=torch.bfloat16)
    opt = adamw.init(params)
    f32 = dict(dtype=torch.float32, device="meta")
    batch_t = {"patches": patches, "pose": torch.empty((batch, s_frames, 9), **f32),
               "depth": torch.empty((batch, s_frames, VGGT_PATCHES), **f32),
               "points": torch.empty((batch, s_frames, VGGT_PATCHES, 3), **f32)}
    step = make_train_step(cfg2, adamw.AdamWConfig(), loss_fn=lambda p, b: (
        vggt_mod.reconstruction_loss(cfg2, p, b, remat=True, act_sharding=act)))
    p_s = place(params, mesh, sharding.param_pspec)
    o_s = adamw.AdamWState(step=place(opt.step, mesh, _fixed(())),
                           m=place(opt.m, mesh, sharding.param_pspec),
                           v=place(opt.v, mesh, sharding.param_pspec))
    b_s = {k: place(v, mesh, _fixed(bspec[:2] + (None,) * (v.ndim - 2)))
           for k, v in batch_t.items()}
    return Cell(fn=step, args=(p_s, o_s, b_s), arch=cfg.name, shape=shape.name,
                held={"params": held_bytes(p_s), "opt_state": held_bytes(o_s),
                      "batch": held_bytes(b_s)})


def make_cell(cfg: ModelConfig, shape_name: str, mesh, **kw) -> Cell:
    shape = SHAPES[shape_name]
    if shape.kind.startswith("vggt"):
        kw = {k: v for k, v in kw.items() if k in ("fp_serve", "act_sp", "attn")}
        return _vggt_cell(cfg, shape, mesh, **kw)
    if shape.kind == "train":
        kw = {k: v for k, v in kw.items() if k in ("seq_sp", "zero1", "remat", "attn")}
        return _train_cell(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        kw = {k: v for k, v in kw.items()
              if k in ("kv_dtype", "fp_serve", "act_sp", "attn", "attn_bf16")}
        return _prefill_cell(cfg, shape, mesh, **kw)
    kw = {k: v for k, v in kw.items() if k in ("kv_dtype", "fp_serve", "kv_seq_model", "attn")}
    return _decode_cell(cfg, shape, mesh, **kw)


def reduced_cfg(cfg: ModelConfig, n_groups: int) -> ModelConfig:
    """Same dims, fewer scan groups — the reference's trip-count-exact
    roofline extrapolation (layer stacks are homogeneous, so costs are
    affine in the group count).  The port's dry run executes every layer
    and needs no extrapolation; kept for parity."""
    period = len(cfg.pattern)
    return cfg.with_(n_layers=cfg.first_dense + n_groups * period)


# --- serving precision specs -------------------------------------------------

SERVE_SPEC_GRAMMAR = (
    "fp | w<bits>a<bits>[:fused] | plan[:fused] | schedule=<path> "
    "(e.g. fp, w4a8, w4a16, w4a8:fused, plan, plan:fused, "
    "schedule=out/lm.schedule.json)"
)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One parsed serving-precision spec (the ``--policy`` / ``--tiers``
    value grammar: ``SERVE_SPEC_GRAMMAR``).

    ``parse``/``format`` round-trip exactly, malformed input raises one
    informative ``ValueError``, and ``materialize`` turns the spec into
    what the engine takes — ``None`` (full precision), a
    ``PrecisionPlan`` (uniform, ``:fused`` or the sensitivity planner's
    mixed plan) or a compiled ``KernelSchedule``.

        ServeSpec.parse("w4a8:fused").materialize(cfg, params)
        ServeSpec.parse_tiers("quality=fp,fast=plan:fused")  # name -> ServeSpec
    """

    level: str  # "fp" | "w<bits>a<bits>" | "plan" | "schedule"
    fused: bool = False
    method: str = "versaq"
    path: Optional[str] = None  # schedule file (level == "schedule" only)

    @classmethod
    def parse(cls, s: str, method: str = "versaq") -> "ServeSpec":
        from repro_torch.core.precision.plan import parse_level

        raw = s
        stripped = s.strip()
        # the path operand is case-sensitive — match the key before lowercasing
        if stripped.lower().startswith("schedule="):
            path = stripped[len("schedule="):]
            if not path:
                raise ValueError(
                    f"serve spec {raw!r}: schedule= needs a file path; "
                    f"expected {SERVE_SPEC_GRAMMAR}"
                )
            return cls(level="schedule", method=method, path=path)
        s = stripped.lower()
        base, _, suffix = s.partition(":")
        if suffix and suffix != "fused":
            raise ValueError(
                f"serve spec {raw!r}: unknown suffix {suffix!r} (only ':fused'); "
                f"expected {SERVE_SPEC_GRAMMAR}"
            )
        fused = suffix == "fused"
        if base in ("fp", "bf16"):
            if fused:
                raise ValueError(f"serve spec {raw!r}: nothing to fuse at full precision")
            return cls(level="fp", method=method)
        if base == "plan":
            return cls(level="plan", fused=fused, method=method)
        try:
            if parse_level(base) is None:  # only w<bits>a<bits> reaches here
                raise ValueError(base)
        except ValueError as e:
            raise ValueError(f"serve spec {raw!r}: expected {SERVE_SPEC_GRAMMAR}") from e
        return cls(level=base, fused=fused, method=method)

    def format(self) -> str:
        """The canonical string form; ``parse(format()) == self``."""
        if self.level == "schedule":
            return f"schedule={self.path}"
        return self.level + (":fused" if self.fused else "")

    def __str__(self) -> str:
        return self.format()

    # -- tier maps ("name=spec,name=spec") --------------------------------

    @classmethod
    def parse_tiers(
        cls, s: Optional[str], method: str = "versaq"
    ) -> Optional[dict[str, "ServeSpec"]]:
        """Parse ``name=spec[,name=spec...]`` into an ordered tier map
        (None for empty input — the single-policy path)."""
        if not s:
            return None
        tiers: dict[str, ServeSpec] = {}
        for part in s.split(","):
            name, eq, spec = part.partition("=")
            name, spec = name.strip(), spec.strip()
            if not eq or not name or not spec:
                raise ValueError(
                    f"tiers entry {part.strip()!r}: expected name=spec with "
                    f"spec in {SERVE_SPEC_GRAMMAR}"
                )
            if name in tiers:
                raise ValueError(f"tiers names tier {name!r} twice")
            tiers[name] = cls.parse(spec, method)
        return tiers

    @staticmethod
    def format_tiers(tiers: dict[str, "ServeSpec"]) -> str:
        """Inverse of ``parse_tiers``: ``parse_tiers(format_tiers(t)) == t``."""
        return ",".join(f"{name}={spec}" for name, spec in tiers.items())

    # -- materialization ---------------------------------------------------

    def materialize(
        self, cfg: Optional[ModelConfig] = None, params: Any = None,
        *, name: str = "default", verbose: bool = False,
    ):
        """What the serving engine takes: ``None`` (fp), a
        ``PrecisionPlan`` or a ``KernelSchedule``.

        A uniform ``w<bits>a<bits>`` level becomes a one-level plan with
        ``use_kernel=True``, where the reference returns the level's
        ``QuantPolicy``: every site is the same, but the port's
        kernel-ready sites (bits <= 8) then run the ``quant_matmul``
        kernel rather than the float emulation of the integer matmul.
        ``plan`` runs the sensitivity planner against ``(cfg, params)`` —
        both required for that level only — and stamps its plan
        ``use_kernel=True`` for the same reason.  ``:fused`` adds
        ``fuse=True`` as in the reference.  ``schedule=<path>`` loads a
        compiled schedule, refusing one the JAX package compiled."""
        from repro_torch.core.precision.plan import PrecisionPlan

        if self.level == "fp":
            return None
        if self.level == "schedule":
            # a compiled KernelSchedule (launch/compile.py output); the
            # engine also accepts the raw path via its ``schedule=`` kwarg,
            # which additionally applies attention tiles + bucket hashing
            from repro_torch.serving.batching import load_schedule

            return load_schedule(self.path)[0]
        if self.level == "plan":
            if cfg is None or params is None:
                raise ValueError(
                    f"serve spec {self.format()!r} needs a model to plan "
                    f"against (cfg and params)"
                )
            from repro_torch.core.precision import plan_model

            plan, report = plan_model(cfg, params, method=self.method, name=name,
                                      use_kernel=True, fuse=self.fused)
            if verbose:
                print(f"tier {name!r}: planned mixed precision "
                      f"{report['level_counts']} "
                      f"({report['weight_bytes']/1e6:.2f}MB modeled weights)")
            return plan
        return PrecisionPlan(default=self.level, method=self.method, use_kernel=True,
                             fuse=self.fused, name=self.level)
