"""Parameter-tree helpers: the port's stand-in for ``jax.tree_util``.

Parameter trees are nested dicts, lists and frozen dataclasses
(``QTensor``, ``QuantLinear``, ``Norm``, ``FoldedNorm``) whose tensor
fields are the leaves; every other field (bits, flags, kinds) is static
and carried over unchanged.  NamedTuples (``KVCache``, the recurrent
states, ``optim.adamw.AdamWState``) are rebuilt field by field.  The
stacked scan-group axis of ``params["blocks"]`` is a leading tensor dim, as
in the reference tree.

A leaf's *path* names it by the keys, indices and field names that lead to
it, joined by dots (``blocks.l0.mixer.wq.w``, ``opt.m.embed.w``): the
checkpoint manager matches leaves by path, never by position, since dicts
here keep insertion order where ``jax.tree`` sorts their keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_map_with_path", "tree_paths", "tree_stack", "tree_index",
           "tree_leaves", "to_device"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf (zipping ``rest`` trees of the
    same structure); static fields and None pass through from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
        return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(items)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)
        })
    return tree


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """:func:`tree_map` with ``fn(path, leaf)``: each leaf's dotted path
    (module docstring), under ``prefix``."""

    def join(key) -> str:
        return f"{prefix}.{key}" if prefix else str(key)

    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map_with_path(fn, getattr(tree, f), join(f))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), join(f.name))
            for f in dataclasses.fields(tree)
        })
    return tree


def tree_paths(tree: Any) -> dict[str, torch.Tensor]:
    """Every tensor leaf by its dotted path."""
    out: dict[str, torch.Tensor] = {}
    tree_map_with_path(lambda path, x: out.setdefault(path, x), tree)
    return out


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(lambda x: out.append(x), tree)
    return out


def tree_stack(trees: list) -> Any:
    """Stack same-structure trees along a new leading axis (the port of
    ``vmap`` over scan groups: prepare per group, then stack).  One tree
    gains the axis as a view, as the reference's ``x[None]`` does: a copy
    would hold the tree twice (jamba's 8-layer group is 53 GB of f32)."""
    if len(trees) == 1:
        return tree_map(lambda x: x.unsqueeze(0), trees[0])
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def tree_index(tree: Any, i: int) -> Any:
    """One scan group's slice of a stacked tree (the port of ``lax.scan``'s
    per-step view)."""
    return tree_map(lambda x: x[i], tree)


def to_device(tree: Any, device) -> Any:
    return tree_map(lambda x: x.to(device), tree)
