"""INT8 gradient compression for the data-parallel all-reduce, with error
feedback (port of ``repro/parallel/compression.py``).

The DP gradient all-reduce moves int8 on the wire instead of f32.  Per
leaf, on every rank of the process group:
  1. error feedback:  g' = g + e          (e = residual from last step)
  2. shared scale:    s = max over ranks of amax(g') / 127, floored at 1e-20
  3. quantize:        q = round(g'/s) int8;  e_new = g' - q·s
  4. reduce-scatter as int8 through ``all_to_all_single``, the shards
     summed in int32 (exact: at most 127 · n_dev),
  5. all-gather the int8-requantized sums (``r`` = max over ranks of the
     sums' amax / 127, floored at 1: the sums are integers).
The result, ``(q-unit sums) · r · s / n_dev``, is the same on every rank.
Rounding is ``torch.round``, half to even, as ``jnp.round`` is.

Wire bytes a rank sends for N entries: N·(1 + 1/n_dev) int8
(:func:`wire_bytes`), against 2·N·4 for a ring all-reduce of f32.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["compressed_psum", "init_error_state", "compressed_tree_psum", "wire_bytes",
           "SMALL_LEAF"]

SMALL_LEAF = 256  # leaves under this many entries take a plain f32 mean
# the divisions by 127 as XLA compiles the reference's: a multiply
# by the float32 reciprocal (a division would round some scales an ulp off)
_INV127 = float(torch.tensor(1 / 127.0, dtype=torch.float32))


def _pad_to(x: torch.Tensor, mult: int) -> tuple[torch.Tensor, int]:
    """x flattened (a view where no padding is needed) and zero-padded to a
    multiple of ``mult``, and its entry count."""
    n = x.numel()
    rem = (-n) % mult
    flat = x.reshape(-1)
    if rem:
        flat = torch.cat([flat, flat.new_zeros((rem,))])
    return flat, n


def _amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| without an |x| copy of the whole tensor."""
    lo, hi = torch.aminmax(x)
    return torch.maximum(hi, -lo)


def _pmax(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _reduce_into(g: torch.Tensor, err: torch.Tensor, group, n_dev: int) -> None:
    """The algorithm on one float32 leaf, in place: ``g`` becomes the mean
    over the ranks, ``err`` the new error state.  Each step makes one
    temporary at a time, so that a leaf of N entries costs ~2N float32
    beside itself (qwen3-14b's embedding is 778 M entries)."""
    g.add_(err)  # g' = g + e
    flat, n = _pad_to(g, n_dev)
    rem = flat.numel() - n
    scale = torch.clamp_min(_pmax(_amax(flat), group) * _INV127, 1e-20)
    t = flat / scale
    t.round_().clamp_(-127, 127)  # q, in float32
    # g' - q·s rounded once, as the reference's (XLA contracts it into a
    # fused multiply-add): addcmul's multiply-add is one rounding too
    if rem:
        err.view(-1).copy_(torch.addcmul(flat, t, scale.expand_as(flat), value=-1.0)[:n])
    else:
        torch.addcmul(flat, t, scale.expand_as(flat), value=-1.0, out=err.view(-1))
    q = t.to(torch.int8)
    del t, flat
    # reduce-scatter phase, int8 on the wire: rank d receives chunk d
    # from every peer
    chunks = q.view(n_dev, -1)
    gathered = torch.empty_like(chunks)
    dist.all_to_all_single(gathered, chunks, group=group)
    del q, chunks
    local_sum = gathered.sum(dim=0, dtype=torch.int32)  # exact (<= 127 n_dev)
    del gathered
    # requantize the per-chunk sum (in units of ``scale``) for the int8 gather
    r = _pmax(_amax(local_sum).to(torch.float32), group) * _INV127
    r = torch.clamp_min(r, 1.0)  # sums are integers; never upscale below 1 q-unit
    t = local_sum.to(torch.float32)
    del local_sum
    t.div_(r).round_().clamp_(-127, 127)
    q2 = t.to(torch.int8)
    del t
    parts = [torch.empty_like(q2) for _ in range(n_dev)]
    dist.all_gather(parts, q2, group=group)
    full = torch.cat(parts)
    del parts, q2
    # value = (q-units sum) · r · scale;  mean over the ranks
    torch.mul(full[:n], r * scale, out=g.view(-1))
    g.div_(n_dev)


def compressed_psum(g: torch.Tensor, group, n_dev: int, err: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce of ``g`` over ``group`` (``n_dev`` ranks) with the
    error-feedback state ``err``.  Returns (the mean of g over the ranks,
    the new error state), both float32 of g's shape; ``g`` and ``err`` are
    left as they are."""
    out = g.to(torch.float32, copy=True)
    new_err = err.to(torch.float32, copy=True)
    _reduce_into(out, new_err, group, n_dev)
    return out, new_err


def init_error_state(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)


def compressed_tree_psum(grads: Any, err: Any, group, n_dev: int) -> tuple[Any, Any]:
    """:func:`compressed_psum` leaf by leaf; leaves under ``SMALL_LEAF``
    entries go uncompressed, as an f32 mean (their scalar collectives would
    cost more than they save).  Returns (mean gradients, new error state):
    ``grads`` and ``err`` themselves, their leaves overwritten in place, so
    that a full-width model's gradients and error state are never held
    twice (``grads`` and ``err`` leaves must be float32, as
    ``torch.autograd`` gives them for float32 parameters)."""

    def f(g, e):
        if g.numel() < SMALL_LEAF:
            dist.all_reduce(g, group=group)
            g.div_(n_dev)
        else:
            _reduce_into(g, e, group, n_dev)

    tree_map(f, grads, err)
    return grads, err


def wire_bytes(grads: Any, n_dev: int) -> float:
    """int8 bytes one rank sends per step for the compressed leaves:
    N·(1 + 1/n_dev) for N padded entries (the small leaves' f32 means are
    not counted)."""
    total = 0
    for g in tree_leaves(grads):
        if g.numel() >= SMALL_LEAF:
            total += g.numel() + (-g.numel()) % n_dev
    return total * (1 + 1 / n_dev)
