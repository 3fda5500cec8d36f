"""Weight bridge between the JAX reference and the port.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so parity tests hand the reference's own ``init_params`` trees
(``vggt.init_params``, ``lm.init_params``) over as plain numpy: nested
dicts and lists of arrays, with each ``Norm`` flattened to ``{"g", "b",
"kind", "eps"}`` (the flattening happens on the JAX side, so this module
imports no JAX).  :func:`params_from_numpy` builds the port's tree from it;
:func:`params_to_numpy` is its inverse.  An LM tree keeps the reference's
layout: the stacked ``blocks.l{j}`` with a leading scan-group axis, and
the ``prefix`` list.

:func:`kv_cache_from_numpy` and :func:`kv_cache_to_numpy` carry a decode
cache (``models/lm.py::init_cache`` layout) across, each ``KVCache`` as a
``{"k", "v", "k_scale", "v_scale", "length"}`` dict, each ``RWKVState``
as a ``{"tshift", "cshift", "wkv"}`` dict and each ``MambaState`` as a
``{"conv", "ssm"}`` dict.

A quantized tree (``quantize_lm``'s output: ``QuantLinear`` with its
``QTensor``, ``FoldedNorm``, ``FusedFFN`` leaves; a MoE layer's
expert-stacked ``QuantLinear`` with values [G, E, K/2, N]) crosses the same
way, each dataclass as a dict of its fields with its class name under
``"__class__"``: array fields become tensors, every other field (bits,
flags, kinds, tiles, site names) is kept as it is.  The two packages'
dataclasses have the same names and fields.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.quantize import QTensor
from repro_torch.core.versaq import Epilogue, FoldedNorm, FusedFFN, Norm, Prologue, QuantLinear
from repro_torch.models.attention import KVCache
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.ssm import MambaState

__all__ = ["params_from_numpy", "params_to_numpy", "kv_cache_from_numpy", "kv_cache_to_numpy"]

_KV_FIELDS = ("k", "v", "k_scale", "v_scale")
_STATES = (RWKVState, MambaState)  # recognised by their first field
_CLASSES = {c.__name__: c for c in (QTensor, QuantLinear, FoldedNorm, FusedFFN, Norm, Prologue,
                                    Epilogue)}


def _is_norm(d: dict) -> bool:
    return "g" in d and "kind" in d


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts/lists of numpy arrays (norms as ``{"g","b","kind",
    "eps"}``) -> the port's parameter tree (tensors on ``device``, ``Norm``
    dataclasses).  Arrays are copied; dtypes are kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if "__class__" in tree:
            return _CLASSES[tree["__class__"]](**{
                k: params_from_numpy(v, device) if isinstance(v, (dict, list, np.ndarray)) else v
                for k, v in tree.items() if k != "__class__"})
        if _is_norm(tree):
            return Norm(
                g=params_from_numpy(tree["g"], device),
                b=params_from_numpy(tree.get("b"), device),
                kind=str(tree["kind"]),
                eps=float(tree.get("eps", 1e-6)),
            )
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy`."""
    if tree is None:
        return None
    if isinstance(tree, Norm):
        return {"g": params_to_numpy(tree.g), "b": params_to_numpy(tree.b),
                "kind": tree.kind, "eps": tree.eps}
    if type(tree).__name__ in _CLASSES:
        out = {"__class__": type(tree).__name__}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            nested = isinstance(v, (dict, list, torch.Tensor)) or dataclasses.is_dataclass(v)
            out[f.name] = params_to_numpy(v) if nested else v
        return out
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def _kv_from(d: dict, device) -> KVCache:
    length = np.asarray(d["length"])
    if length.size and not (length == length.flat[0]).all():
        raise ValueError(f"the port's cache keeps one clock for every group, got {length}")
    return KVCache(*[torch.tensor(np.asarray(d[f]), device=device) for f in _KV_FIELDS],
                   length=int(length.flat[0]) if length.size else 0)


def _entry_from(d: dict, device):
    for cls in _STATES:
        if cls._fields[0] in d:
            return cls(*[torch.tensor(np.asarray(d[f]), device=device) for f in cls._fields])
    return _kv_from(d, device)


def kv_cache_from_numpy(cache: dict, device=None) -> dict:
    """A decode cache as numpy (``prefix`` list and ``blocks`` dict of
    ``KVCache``, ``RWKVState`` or ``MambaState`` dicts, ``pos``) -> the
    port's cache.  The reference keeps one length per scan group; the
    port's single host clock must equal all of them."""
    return {
        "prefix": [None if c is None else _entry_from(c, device) for c in cache["prefix"]],
        "blocks": {n: _entry_from(c, device) for n, c in cache["blocks"].items()},
        "pos": int(np.asarray(cache["pos"])),
    }


def kv_cache_to_numpy(cache: dict) -> dict:
    """Inverse of :func:`kv_cache_from_numpy`."""

    def one(c) -> dict:
        if isinstance(c, _STATES):
            return {f: getattr(c, f).detach().cpu().numpy() for f in c._fields}
        d = {f: getattr(c, f).detach().cpu().numpy() for f in _KV_FIELDS}
        d["length"] = int(c.length)
        return d

    return {"prefix": [None if c is None else one(c) for c in cache["prefix"]],
            "blocks": {n: one(c) for n, c in cache["blocks"].items()},
            "pos": int(cache["pos"])}
