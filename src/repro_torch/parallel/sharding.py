"""Partition rules over a ``DeviceMesh`` (port of ``repro/parallel/sharding.py``):
parameter, optimizer and cache specs (DP/TP/EP/SP), their DTensor
placements, and the sharded tree.

TP layout (Megatron-style, on the ``model`` axis):
  * column-parallel (input replicated, output sharded): wq/wk/wv, FFN
    up/gate, Mamba in-proj, RWKV r/k/v/g, lm_head
  * row-parallel (input sharded, output reduced): wo, FFN down, Mamba
    out-proj, RWKV o
  * EP: MoE expert stacks shard their leading expert dim over ``model``
  * embeddings shard the vocab dim over ``model``
  * everything 1-D (norms, scales-per-token, biases of row-parallel) is
    replicated unless it is the bias of a column-parallel projection.

Quantized params follow their parent projection: ``qw.values`` like ``w``,
``qw.scale`` ([1, N]) shards N the same way, ``bias`` likewise.

DP: the batch dim of inputs/caches shards over ``("pod", "data")``.
SP (sequence): long-context KV caches shard the *sequence* dim over
``data`` and the head_dim over ``model``.

ZeRO-1: optimizer state leaves additionally shard their largest
replicated axis over ``data`` when divisible.

A spec is a tuple with one entry per tensor dimension, as a JAX
``PartitionSpec`` reads: a mesh-axis name, a tuple of names, or None (a
one-name tuple is written as the name, an empty one as None).
A leaf's path is the port's dotted path (``tree.tree_map_with_path``:
``blocks.l0.mixer.wq.qw.values``).  :func:`placements` turns a spec into
DTensor placements, one per mesh dimension (``Shard(i)`` where the spec
names that mesh axis at tensor dim ``i``, else ``Replicate()``), and
:func:`distribute_tree` builds the sharded tree that the port's forwards
and train step then run on (under ``implicit_replication()``; the kernel
sites take local shards, ``parallel/sites.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.tree import tree_map_with_path

__all__ = [
    "param_pspec",
    "make_param_pspecs",
    "zero1_pspec",
    "make_opt_pspecs",
    "batch_axes",
    "batch_pspec",
    "act_pspec",
    "cache_pspecs",
    "NamedSharding",
    "placements",
    "make_param_shardings",
    "distribute_tree",
    "constrain",
    "full_tensor",
]

# projection name -> parallel style
_COL = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_in", "wr", "wg",
    "w_k_up", "w_v_up", "lm_head", "in_proj", "w_dt", "patch_proj",
    "w_decay_b",
}
_ROW = {"wo", "w_down", "w_out", "w_xproj"}
_REPL = {"router", "w_kv_down", "w_decay_a", "fc1", "fc2"}  # small / precision-sensitive


def _style_for(path_names: list[str]) -> str:
    for name in reversed(path_names):
        if name in _COL:
            return "col"
        if name in _ROW:
            return "row"
        if name in _REPL:
            return "repl"
    if "embed" in path_names:
        return "embed"
    if "experts" in path_names:
        return "expert"
    return "repl"


def _leaf_kind(path_names: list[str]) -> str:
    last = path_names[-1]
    if last in ("values",):
        return "values"
    if last in ("scale",):
        return "scale"
    if last in ("b", "bias"):
        return "bias"
    return "w"


def _path_names(path) -> list[str]:
    return path.split(".") if isinstance(path, str) else [str(k) for k in path]


def _spec(*entries) -> tuple:
    """A spec as ``PartitionSpec`` normalizes it: a one-name tuple entry is
    that name, an empty one None."""
    return tuple((e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e
                 for e in entries)


def _pad(spec: tuple, ndim: int) -> tuple:
    """Left-pad with None for stacked leading dims (scan groups, experts)."""
    if len(spec) > ndim:
        # drop leading Nones if the leaf is lower-rank (e.g. scale [1, N])
        spec = spec[len(spec) - ndim:]
    return _spec(*((None,) * (ndim - len(spec)) + tuple(spec)))


def param_pspec(path, leaf, *, model_axis: str = "model") -> tuple:
    names = _path_names(path)
    ndim = leaf.ndim
    style = _style_for(names)
    kind = _leaf_kind(names)
    m = model_axis
    if style == "expert" or "experts" in names:
        # expert stacks are [..., E, d_in, d_out] (possibly with leading
        # scan-group dims and packed/scale variants): the E axis is always
        # 3rd-from-last — shard it over ``model`` (EP)
        if ndim < 3:
            return (None,) * ndim
        dims = [None] * ndim
        dims[ndim - 3] = m
        return tuple(dims)
    if style == "embed":
        return _pad((m, None), ndim)
    if style == "col":
        if kind in ("w", "values", "scale"):
            return _pad((None, m), ndim)
        if kind == "bias":
            return _pad((m,), ndim)
    if style == "row":
        if kind in ("w", "values"):
            return _pad((m, None), ndim)
        return _pad((None,) * min(ndim, 2), ndim)
    return (None,) * ndim


def make_param_pspecs(params: Any, *, model_axis: str = "model") -> Any:
    return tree_map_with_path(lambda p, x: param_pspec(p, x, model_axis=model_axis), params)


def zero1_pspec(path, leaf, *, data_axis: str = "data", model_axis: str = "model") -> tuple:
    """ZeRO-1: shard the first replicated axis of optimizer moments over
    ``data`` when its size divides; fall back to the param spec."""
    base = param_pspec(path, leaf, model_axis=model_axis)
    ndim = leaf.ndim
    if ndim == 0:
        return base
    dims = list(base) + [None] * (ndim - len(base))
    for i, (ax, sz) in enumerate(zip(dims, leaf.shape)):
        if ax is None and sz % 16 == 0 and sz >= 16:
            dims[i] = data_axis
            break
    return tuple(dims)


def make_opt_pspecs(params: Any, *, zero1: bool, model_axis: str = "model",
                    data_axis: str = "data") -> Any:
    """Specs for the AdamW moments (the m and v trees mirror params)."""
    if not zero1:
        return make_param_pspecs(params, model_axis=model_axis)
    return tree_map_with_path(
        lambda p, x: zero1_pspec(p, x, data_axis=data_axis, model_axis=model_axis), params)


# ---------------------------------------------------------------------------
# activations / caches
# ---------------------------------------------------------------------------


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _model_size(mesh) -> int:
    names = _axis_names(mesh)
    return int(mesh.size(names.index("model"))) if "model" in names else 1


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def batch_pspec(mesh) -> tuple:
    return _spec(batch_axes(mesh))


def act_pspec(mesh, *, seq_shard: bool) -> tuple:
    """Residual-stream constraint [B, L, d]: batch over DP, optionally the
    sequence over ``model`` (TP-SP, Megatron sequence parallelism)."""
    return _spec(batch_axes(mesh), "model" if seq_shard else None, None)


def cache_pspecs(cfg, cache: Any, mesh, *, seq_axis_shard: bool,
                 seq_model_shard: bool = False) -> Any:
    """KV/state cache specs: batch over DP (when divisible) else sequence
    over ``data`` (SP flash-decode for batch=1 long-context); head_dim /
    state channels over ``model`` — or, with ``seq_model_shard``, the
    cache SEQUENCE over ``model`` (flash-decode partial-softmax combine)."""
    dp = batch_axes(mesh)
    msize = _model_size(mesh)

    def f(path, leaf):
        names = _path_names(path)
        ndim = leaf.ndim
        last = names[-1]
        if ndim <= 1:
            return ()
        bdim = None if seq_axis_shard else dp
        if last in ("k", "v", "k_scale", "v_scale"):
            # [(groups,) B, S, Hkv, dh(or 1)] — rank 4 for prefix layers
            if seq_model_shard:
                return _pad((bdim, "model", None, None), ndim)
            seq = "data" if seq_axis_shard else None
            dh = leaf.shape[-1]
            model = "model" if (dh % msize == 0 and dh > 1) else None
            return _pad((bdim, seq, None, model), ndim)
        if last == "conv":  # [(groups,) B, dc-1, di]
            return _pad((bdim, None, "model"), ndim)
        if last == "ssm":  # [(groups,) B, di, ds]
            return _pad((bdim, "model", None), ndim)
        if last == "wkv":  # [(groups,) B, nh, hd, hd]
            return _pad((bdim, "model", None, None), ndim)
        if last in ("tshift", "cshift"):  # [(groups,) B, 1, d]
            return _pad((bdim, None, "model"), ndim)
        return (None,) * ndim

    return tree_map_with_path(f, cache)


# ---------------------------------------------------------------------------
# specs -> DTensor placements -> the sharded tree
# ---------------------------------------------------------------------------


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(i)`` where the spec names that axis at tensor dim ``i`` (alone
    or in a tuple: several mesh axes may split one dim, major first), else
    ``Replicate()``.  A spec axis the mesh lacks is left out, as
    :func:`batch_axes` leaves out ``pod`` on a 2-D mesh."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for ax in _axis_names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def make_param_shardings(mesh, params: Any, *, model_axis: str = "model") -> Any:
    """Tree of :class:`NamedSharding` matching ``params`` (meta or real)."""
    return tree_map_with_path(
        lambda p, x: NamedSharding(mesh, param_pspec(p, x, model_axis=model_axis)), params)


def distribute_tree(tree: Any, mesh, spec_fn=param_pspec) -> Any:
    """Every tensor leaf as a DTensor placed by ``spec_fn(path, leaf)``
    (default: the parameter rules).  Every rank passes the same full
    tree; rank 0's values are the ones kept."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map_with_path(
        lambda p, x: distribute_tensor(x, mesh, placements(mesh, spec_fn(p, x))), tree)


def constrain(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``with_sharding_constraint``: ``x`` redistributed to ``sharding``
    (a plain tensor, the same on every rank, is taken as replicated).
    Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = sharding.mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, sharding.placements)


def full_tensor(tree: Any) -> Any:
    """Every DTensor leaf gathered to a plain full tensor (others as they
    are)."""
    from torch.distributed.tensor import DTensor

    return tree_map_with_path(
        lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)
