"""Weight bridge between the JAX reference and the port.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so parity tests hand the reference's own ``vggt.init_params``
tree over as plain numpy: nested dicts of arrays, with each ``Norm``
flattened to ``{"g", "b", "kind", "eps"}`` (the flattening happens on the
JAX side, so this module imports no JAX).  :func:`vggt_params_from_numpy`
builds the port's tree from it; :func:`params_to_numpy` is its inverse.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.versaq import Norm

__all__ = ["vggt_params_from_numpy", "params_to_numpy"]


def _is_norm(d: dict) -> bool:
    return "g" in d and "kind" in d


def vggt_params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays (norms as ``{"g","b","kind","eps"}``)
    -> the port's parameter tree (tensors on ``device``, ``Norm``
    dataclasses).  Arrays are copied; dtypes are kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if _is_norm(tree):
            return Norm(
                g=vggt_params_from_numpy(tree["g"], device),
                b=vggt_params_from_numpy(tree.get("b"), device),
                kind=str(tree["kind"]),
                eps=float(tree.get("eps", 1e-6)),
            )
        return {k: vggt_params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`vggt_params_from_numpy` for a raw (unquantized)
    parameter tree."""
    if tree is None:
        return None
    if isinstance(tree, Norm):
        return {"g": params_to_numpy(tree.g), "b": params_to_numpy(tree.b),
                "kind": tree.kind, "eps": tree.eps}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
