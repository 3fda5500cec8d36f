"""GPipe pipeline parallelism: stages over a mesh axis, microbatches
passed from stage to stage (port of ``repro/parallel/pipeline.py``).

For the regime where a model's layers do not fit one device.  Every stage
applies its own slice of a homogeneous layer stack: ``stage_params``
leaves carry a leading dim S, and the rank at coordinate s of the ``pipe``
axis uses slice s.

Schedule: GPipe fill-drain with M microbatches over S stages: tick
t in [0, M+S-1); stage s computes microbatch t-s when 0 <= t-s < M and
sends its output to stage s+1 (``batch_isend_irecv``), which computes on it
at tick t+1.  The last stage's outputs are then broadcast, so every rank
returns them (the reference's masked ``psum``).  Bubble fraction
(S-1)/(M+S-1), reported by :func:`bubble_fraction`.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

__all__ = ["bubble_fraction", "pipeline_apply"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    n_micro: int,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline over microbatches of ``x``.

    ``stage_params`` leaves have leading dim S (one slice per stage); ``x``
    is [B, ...] with B % n_micro == 0, the same on every rank.  Returns
    ``stage_fn`` of the last stage over the whole batch, on every rank.
    """
    dim = mesh.mesh_dim_names.index(axis)
    n_stages, s = mesh.size(dim), mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    xs = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    params = tree_map(lambda p: p[s], stage_params)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < n_stages - 1 else None
    outs = torch.zeros_like(xs)
    buf = torch.zeros_like(xs[0])
    for t in range(n_micro + n_stages - 1):
        mb = t - s  # the microbatch this stage works on
        y = None
        if 0 <= mb < n_micro:
            y = stage_fn(params, xs[mb] if s == 0 else buf)
            if s == n_stages - 1:
                outs[mb] = y
        ops = []
        if nxt is not None and y is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group=group))
        if prev is not None and 0 <= t - (s - 1) < n_micro:  # stage s-1 sent this tick
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf, prev, group=group))
        for req in dist.batch_isend_irecv(ops) if ops else []:
            req.wait()
    if n_stages > 1:
        dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return outs.reshape(b, *outs.shape[2:])
