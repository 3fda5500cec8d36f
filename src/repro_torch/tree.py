"""Parameter-tree helpers: the port's stand-in for ``jax.tree_util``.

Parameter trees are nested dicts, lists and frozen dataclasses
(``QTensor``, ``QuantLinear``, ``Norm``, ``FoldedNorm``) whose tensor
fields are the leaves; every other field (bits, flags, kinds) is static
and carried over unchanged.  The stacked scan-group axis of
``params["blocks"]`` is a leading tensor dim, as in the reference tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_stack", "tree_index", "tree_leaves", "to_device"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf (zipping ``rest`` trees of the
    same structure); static fields and None pass through from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)
        })
    return tree


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
