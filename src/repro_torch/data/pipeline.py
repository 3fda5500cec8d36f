"""Deterministic synthetic data (the port's own copy of
``repro/data/pipeline.py``; numpy only, the same arrays as the reference).

Every batch is a pure function of (seed, step), so a trainer resuming from
step k reproduces the stream the uninterrupted run would have seen, with
no iterator state to checkpoint.  Three generators: token streams with a
Markov structure (so tiny LMs have something learnable); multi-view
"scenes", random camera poses plus a point cloud projected into per-frame
patch embeddings by a fixed random projection (structured enough that the
heads must regress geometry); and serving traffic of mixed-length prompts.

:class:`ShardedLoader` slices each batch's rows by rank: the rank and world
size of ``torch.distributed`` when it is initialised, else rank 0 of 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "token_batch", "scene_batch", "ShardedLoader", "mixed_len_prompts"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0


def _rng_for_step(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def token_batch(cfg: DataConfig, step: int) -> dict:
    """[B, L] int32 ``tokens`` and ``labels`` (the next tokens) of a Markov
    chain: next = (a * cur + 7 + noise) % vocab."""
    rng = _rng_for_step(cfg, step)
    v = cfg.vocab_size
    a = 31 % v or 1
    x = np.empty((cfg.batch, cfg.seq_len + 1), np.int32)
    x[:, 0] = rng.integers(0, v, cfg.batch)
    noise = (rng.random((cfg.batch, cfg.seq_len)) < 0.15) * rng.integers(
        0, v, (cfg.batch, cfg.seq_len)
    )
    for t in range(cfg.seq_len):
        x[:, t + 1] = (a * x[:, t] + 7 + noise[:, t]) % v
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


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


class ShardedLoader:
    """Step-indexed loader yielding this rank's rows of each batch."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        import torch.distributed as dist

        self.cfg = cfg
        self.step = start_step
        ready = dist.is_available() and dist.is_initialized()
        n_proc = dist.get_world_size() if ready else 1
        if cfg.batch % n_proc:
            raise ValueError(f"batch {cfg.batch} does not split over {n_proc} ranks")
        self._rows = cfg.batch // n_proc
        self._row0 = (dist.get_rank() if ready else 0) * self._rows

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = token_batch(self.cfg, self.step)
        self.step += 1
        return {k: v[self._row0:self._row0 + self._rows] for k, v in b.items()}


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
