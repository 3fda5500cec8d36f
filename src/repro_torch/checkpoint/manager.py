"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``).

Guarantees, as the reference's:

* **Atomicity**: a save writes ``step_XXXXXXXXX.tmp-<pid>`` and renames it
  into place, so a crash mid-write never corrupts the newest checkpoint.
* **Integrity**: every leaf's bytes carry a crc32; a load verifies each
  and falls back to the previous checkpoint on a mismatch.
* **Retention**: the newest ``keep`` checkpoints are kept.

Layout:  ``<dir>/step_000000123/``
            ``manifest.json``  (paths, shapes, dtypes, checksums, meta)
            ``arrays.npz``     (leaf arrays, key = leaf index)

Two differences from the reference, both because the card machine lacks
the packages: the manifest is JSON, not msgpack; and bfloat16 (or any
dtype numpy cannot hold) is stored as a ``uint8`` view and restored
through a ``torch`` view, not ``ml_dtypes``.  Arrays are saved from the
host, so a restore may put them on another device than the save's.

Leaves are matched by their path in the tree (``params.blocks.l0.mixer.wq.w``,
``opt.m.embed.w``; ``tree.py``), never by position: two trees built in
other key orders restore into each other.  A restore whose paths, shapes
or dtypes differ from the template raises :class:`CheckpointMismatch`
(at once: an older checkpoint of the same run would not fit either).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path, tree_paths

__all__ = ["CheckpointManager", "CheckpointMismatch"]

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointMismatch(ValueError):
    """The template's paths, shapes or dtypes are not the checkpoint's."""


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """Host bytes of a leaf; True when stored as a uint8 view."""
    t = t.detach().to("cpu").contiguous()
    try:
        return t.numpy(), False
    except TypeError:  # bfloat16 and the like: numpy has no such dtype
        return t.reshape(-1).view(torch.uint8).numpy(), True


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> str:
        arrays, entries = {}, []
        for i, (path, leaf) in enumerate(tree_paths(tree).items()):
            a, as_u8 = _to_numpy(leaf)
            entries.append({"path": path, "shape": list(leaf.shape), "dtype": _dtype_name(leaf),
                            "crc": zlib.crc32(a.tobytes()), "stored_as_u8": as_u8})
            arrays[f"a{i}"] = a
        manifest = {"n_leaves": len(entries), "entries": entries, "meta": meta or {},
                    "step": step}
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.write(buf.getvalue())
        if os.path.exists(final):  # re-save of the same step: replace atomically
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    # ------------------------------------------------------------------ load
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "arrays.npz")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _load_step(self, step: int, like: Any) -> tuple[Any, dict]:
        path = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        entries = {e["path"]: (i, e) for i, e in enumerate(manifest["entries"])}
        want = tree_paths(like)
        if set(entries) != set(want):
            raise CheckpointMismatch(
                f"step {step}: checkpoint paths {sorted(set(entries) - set(want))[:4]} "
                f"not in the template, template paths {sorted(set(want) - set(entries))[:4]} "
                "not in the checkpoint")
        for p, t in want.items():
            e = entries[p][1]
            if e["shape"] != list(t.shape) or e["dtype"] != _dtype_name(t):
                raise CheckpointMismatch(
                    f"step {step}: {p} is {e['dtype']}{e['shape']} in the checkpoint, "
                    f"{_dtype_name(t)}{list(t.shape)} in the template")
        data = np.load(os.path.join(path, "arrays.npz"))

        def load(p: str, t: torch.Tensor) -> torch.Tensor:
            i, e = entries[p]
            a = data[f"a{i}"]
            if zlib.crc32(np.ascontiguousarray(a).tobytes()) != e["crc"]:
                raise IOError(f"checksum mismatch for {p} at step {step}")
            x = torch.from_numpy(np.array(a))
            if e["stored_as_u8"]:
                x = x.view(t.dtype).reshape(e["shape"])
            return x.to(t.device)

        return tree_map_with_path(load, like), manifest["meta"]

    def restore(self, like: Any, step: Optional[int] = None) -> tuple[Any, dict, int]:
        """Restore the newest valid checkpoint (or ``step``) into the
        structure of ``like``: verify checksums, fall back to older
        checkpoints on corruption."""
        candidates = [step] if step is not None else list(reversed(self.steps()))
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                tree, meta = self._load_step(s, like)
                return tree, meta, s
            except CheckpointMismatch:
                raise
            except Exception as e:  # corrupt -> try the previous one
                last_err = e
        raise FileNotFoundError(f"no restorable checkpoint in {self.directory}: {last_err}")

    # -------------------------------------------------------------------- gc
    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)
