"""Deterministic synthetic data (the port's own copy of
``repro/data/pipeline.py::scene_batch`` and ``mixed_len_prompts``; numpy
only).

Every batch is a pure function of (seed, step): random camera poses plus a
point cloud projected into per-frame patch embeddings by a fixed random
projection — structured enough that the heads must regress geometry; and
serving traffic of mixed-length prompts.
"""
from __future__ import annotations

import numpy as np

__all__ = ["scene_batch", "mixed_len_prompts"]


def scene_batch(
    batch: int, n_frames: int, n_patches: int, d_model: int, step: int, seed: int = 0
) -> dict:
    """Synthetic multi-view geometry for the VGGT engine and benchmarks."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1000 + step]))
    # world points per scene (grid-ish cloud), one point per patch
    pts = rng.normal(size=(batch, 1, n_patches, 3)).astype(np.float32)
    pts = np.repeat(pts, n_frames, axis=1)
    # per-frame pose: translation + small rotation angles + focal
    pose = rng.normal(size=(batch, n_frames, 9)).astype(np.float32) * 0.3
    # camera-space points: world + translation (toy projective model)
    cam = pts + pose[:, :, None, :3]
    depth = 2.0 + np.abs(cam[..., 2])
    # fixed random projection -> patch embeddings ("DINO features" stub)
    proj_rng = np.random.default_rng(seed + 123)
    w = proj_rng.normal(size=(7, d_model)).astype(np.float32) / np.sqrt(7)
    feats = np.concatenate(
        [cam, depth[..., None], pose[:, :, None, :3].repeat(n_patches, 2)], axis=-1
    )
    patches = feats @ w
    patches += 0.05 * rng.normal(size=patches.shape).astype(np.float32)
    return {
        "patches": patches.astype(np.float32),
        "pose": pose,
        "depth": depth.astype(np.float32),
        "points": cam.astype(np.float32),
    }


def mixed_len_prompts(
    vocab_size: int, requests: int, prompt_len: int, seed: int = 0
) -> list[np.ndarray]:
    """Serving demo traffic: alternating full and 3/4-length prompts.

    The short length is deliberately NOT a power of two, so it pads into
    the full prompt's length bucket and exercises the serving engine's
    masked (length-padded) variants alongside warm bucket reuse.
    Deterministic per (seed, request index)."""
    lens = [prompt_len if r % 2 == 0 else max(prompt_len * 3 // 4, 1)
            for r in range(requests)]
    return [
        np.random.default_rng(np.random.SeedSequence([seed, r]))
        .integers(0, vocab_size, (n,)).astype(np.int32)
        for r, n in enumerate(lens)
    ]
