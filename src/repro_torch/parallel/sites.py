"""The sharded route: the ops of a sharded path, on local shards.

A kernel takes the ``data_ptr`` of local tensors, and every kernel wrapper
refuses a DTensor; some reshapes of a sharded dim are refused by DTensor's
view rules.  So on a sharded path (a tree placed by
``parallel/sharding.py``) those ops run here instead, each through
``torch.distributed.tensor.experimental.local_map``: the inputs are
redistributed to the placements below, the op runs on each rank's local
shards, and its output is wrapped back.  Model code reaches this module
only through ``repro_torch.sharded``: a kernel site's wrappers come from
``sharded.kernels_for`` (``kernels.ops``, or the functions of the same
names here), and an op decorated with ``sharded.routed`` (``fast_wht``,
``apply_blocked``, ``split_dim``, ``sdpa_dispatch``, ``write_slots``) runs
the function of its name here, handed the op.  On the CPU the kernel wrappers run their
plain versions, so CPU runs take the same route as the card.

Placements on the ``model`` mesh axis (on the batch axes an input keeps
its own placement when it shards the batch, dim 0, else is replicated;
an output keeps the input's):

======================  ===========  ==============  ============  =========
site                    input        weight values   weight scale  output
======================  ===========  ==============  ============  =========
column-parallel linear  Replicate    Shard(-1)       Shard(-1)     Shard(-1)
row-parallel linear     Replicate    Shard(-2)       Replicate     Partial,
                                                                   reduced to
                                                                   Replicate
two_stage_mha           Shard(1)     (q, k, v: heads)              Shard(1)
sdpa_dispatch           Shard(2)     (q, k, v: heads)              Shard(2)
any other kernel site   Replicate    Replicate       Replicate     Replicate
======================  ===========  ==============  ============  =========

A site's style is read off its weight's placement.  A dimension that the
model axis does not divide evenly takes the replicated route, as do
expert stacks and the fused sites (``fused_linear``, ``fused_ffn_apply``:
one launch runs a whole site or FFN, whose requantized hidden needs the
full row), which gather their weights.  The blocked transforms run on each
rank's rows with whole blocks (:func:`local_rows`), and a head split keeps
the sharding where the model axis divides the heads (:func:`split_dim`).

**Row-parallel sites gather their input.**  Two things keep a row shard
from quantizing its own slice of the input: the per-token activation scale
is an amax over the whole K, and a W4 weight packs K-rows ``[0, K/2)`` in
the low nibbles and ``[K/2, K)`` in the high ones
(``core/quantize.py::pack_int4``), so rank r's packed rows
``[r K/2m, (r+1) K/2m)`` hold two separate runs of K.  Each rank therefore
gathers the input, quantizes it per token over all of K exactly as the
unsharded site does, and multiplies only its K columns (the two runs, or
one run ``[r K/m, (r+1) K/m)`` for a W8 weight) against its packed rows
(:func:`row_partial`).  The partial outputs are summed over the model
axis: the integer products are exact, the scaled float partial sums are
added in rank order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.quantize import QTensor, quantize_per_token
from repro_torch.core.transforms import block_size_for
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.sharded import is_dtensor
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["quant_linear_matmul", "two_stage_mha", "fused_linear", "fused_ffn_apply",
           "fast_wht", "apply_blocked", "split_dim", "sdpa_dispatch", "write_slots",
           "row_columns",
           "row_partial", "gather_dim", "local_rows"]


def _mesh(*xs):
    """The mesh of the first DTensor, and its ``model`` dim (or None)."""
    mesh = next(x for x in xs if is_dtensor(x)).device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    return mesh, (names.index("model") if "model" in names else None)


def _dt(x: torch.Tensor, mesh):
    """``x`` as a DTensor; a plain tensor is the same on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _batch(x, mesh, model_dim, on_model=None) -> list:
    """``x``'s placements off the model axis (a Shard of the batch, dim 0,
    that divides evenly, else Replicate), with ``on_model`` on it."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for i, pl in enumerate(x.placements):
        if i == model_dim:
            out.append(on_model if on_model is not None else Replicate())
        elif isinstance(pl, Shard) and pl.dim == 0 and x.shape[0] % mesh.size(i) == 0:
            out.append(pl)
        else:
            out.append(Replicate())
    return out


def _on_model(mesh, model_dim, placement) -> list:
    from torch.distributed.tensor import Replicate

    return [placement if i == model_dim else Replicate() for i in range(mesh.ndim)]


def _shard_dim(w, model_dim):
    """The tensor dim ``w`` shards over the model axis, or None."""
    from torch.distributed.tensor import Shard

    if model_dim is None:
        return None
    pl = w.placements[model_dim]
    return pl.dim if isinstance(pl, Shard) else None


def row_columns(k: int, rows: int, rank: int, *, packed: bool, device=None) -> torch.Tensor:
    """The K columns of the input that rank ``rank``'s ``rows`` weight rows
    multiply: for packed W4, the low-nibble run ``[rank rows, (rank+1)
    rows)`` and the same run past ``k / 2`` (the high nibbles); else the
    one run ``[rank rows, (rank+1) rows)``."""
    run = torch.arange(rank * rows, (rank + 1) * rows, device=device)
    return torch.cat([run, run + k // 2]) if packed else run


def row_partial(x: torch.Tensor, wq: QTensor, rank: int, size: int, a_bits: int = 8
                ) -> torch.Tensor:
    """Rank ``rank``'s partial output of a row-parallel site over ``size``
    ranks: ``x`` [..., K] whole, ``wq`` the rank's K rows (``values`` [K/m,
    N], or [K/2m, N] packed) with the whole scale.  ``x`` is quantized per
    token over all of K, as the unsharded site quantizes it, and only the
    columns of the rank's rows (:func:`row_columns`) enter the kernel.
    Returns [..., N] float32; summed over the ranks it is the site's
    output."""
    if x.requires_grad or wq.values.requires_grad or wq.scale.requires_grad:
        raise RuntimeError("row_partial: got a tensor that requires grad, but no kernel has "
                           "a backward; detach the inputs and parameters first")
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    xq = quantize_per_token(x.reshape(-1, k), a_bits)
    xv = xq.values
    if size > 1:
        xv = xv.index_select(1, row_columns(k, wq.values.shape[0], rank, packed=wq.packed,
                                            device=x.device))
    y = _qm.quant_matmul(xv, xq.scale, wq.values, wq.scale.reshape(1, -1).to(torch.float32),
                         packed=wq.packed)
    return y.reshape(lead + (y.shape[-1],))


def _replicated(fn: Callable, x, site: Any, mesh, model_dim):
    """``fn(x, site)`` with every leaf of ``site`` gathered: the route of a
    site with no tensor-parallel rule."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    leaves = [_dt(t, mesh) for t in tree_leaves(site)]
    rep = [Replicate()] * mesh.ndim
    io = _batch(x, mesh, model_dim)

    def local(xl, *ls):
        it = iter(ls)
        return fn(xl, tree_map(lambda _: next(it), site))

    return local_map(local, out_placements=io, in_placements=(io, *[rep] * len(leaves)),
                     device_mesh=mesh, redistribute_inputs=True)(x, *leaves)


def quant_linear_matmul(x, wq, a_bits: int = 8, *, tiles=None):
    """``kernels.ops.quant_linear_matmul`` on local shards (module
    docstring: column- and row-parallel, else replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(x, wq.values, wq.scale)
    x, vals, scale = _dt(x, mesh), _dt(wq.values, mesh), _dt(wq.scale, mesh)
    size = mesh.size(md) if md is not None else 1
    dim = _shard_dim(vals, md) if vals.ndim == 2 else None

    if dim == 1 and vals.shape[1] % size == 0:  # column-parallel
        def col(xl, vl, sl):
            return kernel_ops.quant_linear_matmul(
                xl, dataclasses.replace(wq, values=vl, scale=sl), a_bits, tiles=tiles)

        return local_map(
            col, out_placements=_batch(x, mesh, md, Shard(x.ndim - 1)),
            in_placements=(_batch(x, mesh, md), _on_model(mesh, md, Shard(1)),
                           _on_model(mesh, md, Shard(scale.ndim - 1))),
            device_mesh=mesh, redistribute_inputs=True)(x, vals, scale)

    if dim == 0 and vals.shape[0] % size == 0 and (not wq.packed or wq.pack_axis == 0):
        kernel_ops.launch_tiles("quant_matmul", tiles)
        rank = mesh.get_local_rank(md)

        def row(xl, vl, sl):
            return row_partial(xl, dataclasses.replace(wq, values=vl, scale=sl), rank, size,
                               a_bits)

        y = local_map(
            row, out_placements=_batch(x, mesh, md, Partial()),
            in_placements=(_batch(x, mesh, md), _on_model(mesh, md, Shard(0)),
                           [Replicate()] * mesh.ndim),
            device_mesh=mesh, redistribute_inputs=True)(x, vals, scale)
        return y.redistribute(mesh, _batch(y, mesh, md))

    return _replicated(
        lambda xl, w: kernel_ops.quant_linear_matmul(xl, w, a_bits, tiles=tiles),
        x, wq, mesh, md)


def two_stage_mha(q, k, v, *, causal: bool = False, tiles=None):
    """``kernels.ops.two_stage_mha`` on local shards: each rank attends
    with its own heads (q [B, H, L, dh] and k/v [B, Hkv, L, dh] split on
    dim 1) when the model axis divides both head counts, else replicated."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(q, k, v)
    q, k, v = (_dt(t, mesh) for t in (q, k, v))
    size = mesh.size(md) if md is not None else 1
    heads = md is not None and q.shape[1] % size == 0 and k.shape[1] % size == 0
    io = _batch(q, mesh, md, Shard(1) if heads else None)

    def attend(ql, kl, vl):
        return kernel_ops.two_stage_mha(ql, kl, vl, causal=causal, tiles=tiles)

    return local_map(attend, out_placements=io, in_placements=(io, io, io),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def sdpa_dispatch(fn, cfg, q, k, v, *, kv_mask=None, **kw):
    """``fn(cfg, q, k, v, kv_mask=, **kw)`` (the float attention of
    ``models/attention.py``) on local shards: q [B, L, H, dh] and k/v [B,
    Lk, Hkv, dh] split on their heads (dim 2) when the model axis divides
    both head counts, else replicated; the batch and ``kv_mask`` [B, Lk]
    keep the batch's sharding.  Megatron's attention: every head is local,
    so no einsum over sharded heads meets DTensor's sharding rules."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(q, k, v)
    q, k, v = (_dt(t, mesh) for t in (q, k, v))
    size = mesh.size(md) if md is not None else 1
    heads = md is not None and q.shape[2] % size == 0 and k.shape[2] % size == 0
    io = _batch(q, mesh, md, Shard(2) if heads else None)
    args, places = [q, k, v], [io, io, io]
    if kv_mask is not None:
        args.append(_dt(kv_mask, mesh))
        places.append(_batch(q, mesh, md))

    def attend(ql, kl, vl, ml=None):
        return fn(cfg, ql, kl, vl, kv_mask=ml, **kw)

    return local_map(attend, out_placements=io, in_placements=tuple(places),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def fused_linear(x, p, *, tiles=None):
    """``kernels.ops.fused_linear`` on the replicated route."""
    mesh, md = _mesh(x, *tree_leaves(p))
    return _replicated(lambda xl, site: kernel_ops.fused_linear(xl, site, tiles=tiles),
                       _dt(x, mesh), p, mesh, md)


def fused_ffn_apply(x, f, *, tiles=None):
    """``kernels.ops.fused_ffn_apply`` on the replicated route."""
    mesh, md = _mesh(x, *tree_leaves(f))
    return _replicated(lambda xl, site: kernel_ops.fused_ffn_apply(xl, site, tiles=tiles),
                       _dt(x, mesh), f, mesh, md)


def gather_dim(x, dim: int, keep: int = 0):
    """DTensor ``x`` with every mesh dim that shards tensor dim ``dim`` and
    does not divide ``keep`` (0: none divides) replicated; other tensors
    as they are."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x
    d = dim % x.ndim
    pls = [Replicate() if isinstance(pl, Shard) and pl.dim == d
           and (keep == 0 or keep % x.device_mesh.size(i)) else pl
           for i, pl in enumerate(x.placements)]
    return x if pls == list(x.placements) else x.redistribute(x.device_mesh, pls)


def split_dim(fn, x, dim: int, sizes):
    """``fn(x, dim, sizes)``, a reshape of dim ``dim`` into ``sizes``.  A
    DTensor sharded on that dim keeps the sharding on the first new dim
    where the mesh dim divides ``sizes[0]``, and is gathered on that mesh
    dim first where it does not (a reshape cannot split uneven shards;
    GSPMD regathers so implicitly, e.g. 2 KV heads on a 4-way model axis)."""
    return fn(gather_dim(x, dim, keep=sizes[0]), dim, sizes)


def local_rows(fn, x, block: int = 0):
    """``fn(x)`` for a DTensor ``x``, computed on each rank's local shard:
    ``fn`` must act on each row of the last dim alone (on each run of
    ``block`` entries, with ``block``), as a blocked WHT or IDCT does.  A
    sharding of the last dim that would split a block (any, without
    ``block``) is gathered first; the result keeps ``x``'s placements.
    Reshapes that flatten sharded dims (a matmul over [..., blocks, block])
    then never meet DTensor's sharding rules."""
    from torch.distributed.tensor.experimental import local_map

    x = gather_dim(x, -1, keep=x.shape[-1] // block if block else 0)
    pls = list(x.placements)  # a list: local_map reads a tuple as one entry an output
    return local_map(fn, out_placements=pls, in_placements=(pls,), device_mesh=x.device_mesh)(x)


def fast_wht(fn, x, block=None):
    """``fn(x, block)``, the blocked WHT, on each rank's rows."""
    b = block or block_size_for(x.shape[-1])
    return local_rows(lambda t: fn(t, b), x, b)


def apply_blocked(fn, x, mat, block: int):
    """``fn(x, mat, block)``, a block-diagonal matmul, on each rank's rows."""
    return local_rows(lambda t: fn(t, mat, block), x, block)


def write_slots(fn, buf, start: int, new):
    """``fn(buf, start, new)``, a cache write into slots ``[start, start +
    L)`` of dim 1, on a cache placed whole on that dim (batch or channels
    sharded, or replicated).  A cache sharded on its slots (the
    ``seq_axis_shard``/``seq_model_shard`` specs of
    ``sharding.cache_pspecs``) raises: DTensor would write into a gathered
    copy and drop the write; so does a plain cache."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(buf):
        raise TypeError("a sharded forward writes a plain cache: place the cache with "
                        "sharding.distribute_tree (specs from sharding.cache_pspecs)")
    if any(isinstance(pl, Shard) and pl.dim % buf.ndim == 1 for pl in buf.placements):
        raise NotImplementedError(
            f"a KV cache sharded on its sequence dim ({buf.placements}) is not supported "
            "yet; place the cache with seq_axis_shard=False and seq_model_shard=False")
    fn(buf, start, new)
