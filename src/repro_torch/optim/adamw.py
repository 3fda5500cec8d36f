"""AdamW + global-norm clipping + warmup-cosine schedule over the port's
parameter trees (port of ``repro/optim/adamw.py``).

The optimizer state mirrors the parameter tree (``m`` and ``v`` float32,
whatever the leaf's dtype), and every number is float32 as in the
reference: the learning rate from a float32 step, the cosine in float32,
the bias corrections ``1 - b ** step`` in float32.

:func:`apply` updates the parameter leaves and the moments in place (under
``torch.no_grad()``), so that a full-width model's state is never held
twice, and returns the same ``(params, state, metrics)`` triple as the
reference.  ``params`` and ``grads`` must have the same structure; ``grads``
may hold ``None`` where a leaf got no gradient, which counts as zero.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWState", "AdamWConfig", "schedule", "init", "global_norm", "apply"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (float32)."""
    step = step.to(torch.float32)
    dev = step.device
    warm = step / _f32(max(1.0, cfg.warmup_steps), dev)
    prog = (step - _f32(cfg.warmup_steps, dev)) / _f32(
        max(1.0, cfg.total_steps - cfg.warmup_steps), dev)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = _f32(cfg.min_lr_ratio, dev) + _f32(1 - cfg.min_lr_ratio, dev) * _f32(0.5, dev) * (
        1 + torch.cos(_f32(math.pi, dev) * prog))
    return _f32(cfg.lr, dev) * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros,
                      v=tree_map(torch.clone, zeros))


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [x for x in tree_leaves(tree) if x is not None]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params: Any, grads: Any
          ) -> tuple[Any, AdamWState, dict]:
    """One AdamW step, in place: returns ``(params, state, {"grad_norm",
    "lr"})`` with ``params`` and the moments updated where they lie."""
    quads: list = []  # (param, grad or None, m, v) leaf by leaf
    tree_map(lambda *leaves: quads.append(leaves), params, grads, state.m, state.v)
    dev = quads[0][0].device
    gnorm = global_norm([g for _, g, _, _ in quads if g is not None])
    clip = torch.minimum(_f32(1.0, dev), _f32(cfg.clip_norm, dev) / torch.clamp_min(gnorm, 1e-9))
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, dev), stepf)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)
    for p, g, m, v in quads:
        g = torch.zeros_like(m) if g is None else g.to(torch.float32) * clip
        m.copy_(b1 * m + c1 * g)
        v.copy_(b2 * v + c2 * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + wd * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics

