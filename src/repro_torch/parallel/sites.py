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
``apply_blocked``, ``split_dim``, ``reshape``, ``embed``, ``matmul``,
``moe_dispatch``, ``sdpa_dispatch``, ``absorbed_attend``, ``token_nll``,
``_selective_scan``, ``write_slots``) runs the function of its name here,
handed the op.  On the CPU the kernel wrappers run their plain versions,
so CPU runs take the same route as the card.

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
float matmul            as above, by its weight's placement (float)   as above
any other kernel site   Replicate    Replicate       Replicate     Replicate
======================  ===========  ==============  ============  =========

The float matmul (:func:`matmul`) keeps every sharding of the input's
leading dims, on the model axis too when its weight is replicated there
(the DPT and camera heads on the act-SP stream), so no row of a [B, S, P,
d] stream is flattened across shards.  A reshape (:func:`reshape`) runs
on each rank's local block where the sharded dim is the major one of the
dims it merges or splits, and gathers that mesh dim first where it is not.

A KV cache sharded on its sequence (``cache_pspecs(seq_axis_shard=True)``
or ``seq_model_shard=True``) is written slot by slot on the rank that
holds the slot (:func:`write_slots`), and decode attention over it
combines the ranks' partial softmaxes (:func:`sdpa_dispatch`, and
:func:`absorbed_attend` for MLA's compressed cache): no rank gathers the
cache.

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
           "fast_wht", "apply_blocked", "split_dim", "reshape", "embed", "matmul", "moe_dispatch",
           "sdpa_dispatch", "absorbed_attend", "token_nll", "_selective_scan",
           "write_slots", "row_columns", "row_partial", "gather_dim", "local_rows"]


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


def _seq_dims(k) -> list:
    """The mesh dims that shard k's sequence (dim 1) into even shards."""
    from torch.distributed.tensor import Shard

    dims = [i for i, pl in enumerate(k.placements) if isinstance(pl, Shard) and pl.dim == 1]
    return dims if dims and k.shape[1] % _shards(k, 1, k.placements) == 0 else []


def sdpa_dispatch(fn, cfg, q, k, v, *, kv_mask=None, **kw):
    """``fn(cfg, q, k, v, kv_mask=, **kw)`` (the float attention of
    ``models/attention.py``) on local shards: q [B, L, H, dh] and k/v [B,
    Lk, Hkv, dh] split on their heads (dim 2) when the model axis divides
    both head counts, else replicated; the batch and ``kv_mask`` [B, Lk]
    keep the batch's sharding.  Megatron's attention: every head is local,
    so no einsum over sharded heads meets DTensor's sharding rules.

    Keys sharded on their sequence (a sequence-sharded decode cache) stay
    where they are: each rank attends over its own keys (``fn`` with
    ``k_offset``, their first global position, and ``stats=True``) and the
    ranks combine their partial softmaxes over the mesh dims of the
    sequence (:func:`_combine`).  A head_dim sharded over ``model`` is
    moved to the heads for the local chunk only.  On a cache-masked call
    (decode) whose heads the model axis does not divide, the model axis
    splits the keys the same way rather than gathering them."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(q, k, v)
    q, k, v = (_dt(t, mesh) for t in (q, k, v))
    seq = _seq_dims(k)
    size = mesh.size(md) if md is not None and md not in seq else 1
    heads = md is not None and md not in seq and q.shape[2] % size == 0 \
        and k.shape[2] % size == 0
    if (not heads and size > 1 and kw.get("kv_len") is not None
            and k.shape[1] % (_shards(k, 1, k.placements) * size) == 0):
        seq = sorted(seq + [md])  # decode: the model axis splits the keys instead
    io = _batch(q, mesh, md, Shard(2) if heads else None)
    if seq:
        io = [Replicate() if i in seq else pl for i, pl in enumerate(io)]
    kvp = [Shard(1) if i in seq else pl for i, pl in enumerate(io)]
    mp = [Shard(1) if i in seq else (Replicate() if i == md else pl)
          for i, pl in enumerate(io)]
    args, places = [q, k, v], [io, kvp, kvp]
    if kv_mask is not None:
        args.append(_dt(kv_mask, mesh))
        places.append(mp)
    if seq:
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        kw = dict(kw, k_offset=int(compute_local_shape_and_global_offset(
            k.shape, mesh, kvp)[1][1]), stats=True)

    def attend(ql, kl, vl, ml=None):
        out = fn(cfg, ql, kl, vl, kv_mask=ml, **kw)
        return _combine(*out, [mesh.get_group(i) for i in seq]) if seq else out

    return local_map(attend, out_placements=io, in_placements=tuple(places),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def absorbed_attend(fn, q_lora, q_rope, ck, *, kv_mask=None, **kw):
    """``fn(q_lora, q_rope, ck, kv_mask=, **kw)``, MLA's absorbed decode
    attention (``models/attention.py``), with the compressed cache's slots
    split over the ranks: over the mesh dims that shard them already, and
    over the model axis too (the cache's channels, sharded there by
    ``cache_pspecs``, move to its slots for the local chunk), each rank
    attends over its own slots (``k_offset``, ``stats=True``) and the
    ranks combine their partial softmaxes (:func:`_combine`).  The queries
    keep the batch's sharding and are whole on the other axes.  No rank
    gathers the cache."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(q_lora, q_rope, ck)
    q_lora, q_rope, ck = (_dt(t, mesh) for t in (q_lora, q_rope, ck))
    seq = _seq_dims(ck)
    if (md is not None and md not in seq and mesh.size(md) > 1
            and ck.shape[1] % (_shards(ck, 1, ck.placements) * mesh.size(md)) == 0):
        seq = sorted(seq + [md])
    io = [Replicate() if i in seq else pl for i, pl in enumerate(_batch(q_lora, mesh, md))]
    ckp = [Shard(1) if i in seq else pl for i, pl in enumerate(io)]
    args, places = [q_lora, q_rope, ck], [io, io, ckp]
    if kv_mask is not None:
        args.append(_dt(kv_mask, mesh))
        places.append(ckp)
    if seq:
        kw = dict(kw, k_offset=int(compute_local_shape_and_global_offset(
            ck.shape, mesh, ckp)[1][1]), stats=True)

    def attend(ql, qr, cl, ml=None):
        out = fn(ql, qr, cl, kv_mask=ml, **kw)
        return _combine(*out, [mesh.get_group(i) for i in seq]) if seq else out

    return local_map(attend, out_placements=io, in_placements=tuple(places),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _combine(o, m, l, groups):
    """The attention output over every rank's keys, from each rank's own
    (o, m, l): its output normalized over its keys, its row max and its sum
    of exponentials ([B, Lq, H, 1] each).  The log-sum-exp rule: the global
    max M (an all-reduce max), each rank's weight ``l exp(m - M)`` over
    their sum (an all-reduce sum), and the weighted outputs summed (another).
    Over one rank the weight is exactly 1, and the output is ``o`` itself."""
    from torch.distributed import _functional_collectives as funcol

    def reduce(t, op):
        for g in groups:
            t = funcol.all_reduce(t, op, g)
        return funcol.wait_tensor(t)

    w = l * torch.exp(m - reduce(m, "max"))
    return reduce(o * (w / reduce(w, "sum")), "sum")


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


def moe_dispatch(fn, p, cfg, xt, mask=None):
    """``fn(p, cfg, xt, mask)``, the MoE dispatch of blocks ``xt`` [nb, tb,
    d], on each rank's blocks: ``xt`` and ``mask`` [nb, tb] keep a sharding
    of the blocks (dim 0) and are whole on the model axis, and every leaf of
    ``p`` (router, expert stacks, their scales) is gathered, as an expert
    stack's kernel site is (module docstring).  Each rank routes its own
    tokens through every expert: capacity and rank order are block-local,
    so the blocks split across ranks as they are."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    leaves = tree_leaves(p)
    mesh, md = _mesh(xt, *leaves)
    xt = _dt(xt, mesh)
    io = _batch(xt, mesh, md)
    rep = [Replicate()] * mesh.ndim
    args, places = [xt] + [_dt(t, mesh) for t in leaves], [io] + [rep] * len(leaves)
    if mask is not None:
        args.append(_dt(mask, mesh))
        places.append(io)

    def local(xl, *ls):
        it = iter(ls)
        return fn(tree_map(lambda _: next(it), p), cfg, xl, next(it, None))

    return local_map(local, out_placements=io, in_placements=tuple(places), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


class _AllReduce(torch.autograd.Function):
    """``t`` summed (``op`` "sum") or averaged ("avg") over ``group``; the
    backward hands each rank the gradient of the reduced value (divided by
    the group's size for "avg"), which every rank holds whole."""

    @staticmethod
    def forward(ctx, t, op, group):
        from torch.distributed import _functional_collectives as funcol

        ctx.scale = 1.0 / group.size() if op == "avg" else 1.0
        return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op, group))

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def token_nll(fn, logits, labels):
    """``fn(logits, labels)``, the mean token cross entropy, vocab-parallel
    (Megatron's): each rank keeps its rows of the batch and its slice of the
    vocabulary, takes its row max, sum of exponentials and gold logit (where
    the label falls in its slice), and the model axis combines them (a max,
    then two sums); the batch axes average the ranks' means.  No rank
    gathers the logits.  The loss is replicated; differentiable."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(logits, labels)
    logits, labels = _dt(logits, mesh), _dt(labels, mesh)
    io = _batch(logits, mesh, md)
    vocab = md is not None and logits.shape[-1] % mesh.size(md) == 0
    lp = list(io)
    if vocab:
        lp[md] = Shard(logits.ndim - 1)
    rows = [mesh.get_group(i) for i, pl in enumerate(io) if isinstance(pl, Shard)]
    group = mesh.get_group(md) if vocab else None
    v0 = mesh.get_local_rank(md) * (logits.shape[-1] // mesh.size(md)) if vocab else 0

    def local(xl, yl):
        xl = xl.to(torch.float32)
        if group is None:
            nll = torch.logsumexp(xl, dim=-1) - torch.gather(
                xl, -1, yl.long()[..., None])[..., 0]
        else:
            m = funcol.wait_tensor(funcol.all_reduce(xl.detach().amax(dim=-1), "max", group))
            z = _AllReduce.apply(torch.exp(xl - m[..., None]).sum(dim=-1), "sum", group)
            idx = yl.long() - v0
            mine = (idx >= 0) & (idx < xl.shape[-1])
            gold = torch.gather(xl, -1, idx.clamp(0, xl.shape[-1] - 1)[..., None])[..., 0]
            gold = _AllReduce.apply(torch.where(mine, gold, 0.0), "sum", group)
            nll = torch.log(z) + m - gold
        loss = torch.mean(nll)
        for g in rows:
            loss = _AllReduce.apply(loss, "avg", g)
        return loss

    return local_map(local, out_placements=[Replicate()] * mesh.ndim,
                     in_placements=(lp, io), device_mesh=mesh, redistribute_inputs=True)(
        logits, labels)


def _selective_scan(fn, u, dt, a, b_in, c_in, d_skip, init_state=None):
    """``fn(u, dt, a, b_in, c_in, d_skip, init_state)``, the Mamba selective
    scan over time, on each rank's (batch, channel) block: every channel
    of the scan runs alone, so u/dt [B, L, di], a [di, ds], d_skip [di] and
    the state [B, di, ds] split their channels over the model axis where it
    divides d_inner, b/c [B, L, ds] are whole there, and the batch keeps its
    sharding.  Differentiable: b/c's gradients are summed over the model
    axis, the parameters' over the mesh dims that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(u, dt, a, b_in, c_in, d_skip)
    u, dt, a, b_in, c_in, d_skip = (_dt(t, mesh) for t in (u, dt, a, b_in, c_in, d_skip))
    chan = md is not None and u.shape[-1] % mesh.size(md) == 0
    io = _batch(u, mesh, md)

    def on_model(pl, dim):
        return [Shard(dim) if i == md and chan else p for i, p in enumerate(pl)]

    rows = on_model(io, 2)
    bc = list(io)
    params = on_model([Replicate()] * mesh.ndim, 0)
    pgrad = [Partial() if isinstance(p, Shard) else q for p, q in zip(io, params)]
    bgrad = [Partial() if i == md and chan else p for i, p in enumerate(io)]
    state = on_model(io, 1)
    args = [u, dt, a, b_in, c_in, d_skip]
    places = [rows, rows, params, bc, bc, params]
    grads = [rows, rows, pgrad, bgrad, bgrad, pgrad]
    if init_state is not None:
        args.append(_dt(init_state, mesh))
        places.append(state)
        grads.append(state)
    return local_map(fn, out_placements=(rows, state), in_placements=tuple(places),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


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


def _shards(x, dim: int, pls) -> int:
    """The number of shards the mesh dims of ``pls`` split tensor dim
    ``dim`` of ``x`` into."""
    from torch.distributed.tensor import Shard

    n = 1
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim == dim:
            n *= x.device_mesh.size(i)
    return n


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``
    (Megatron's copy into the tensor-parallel region: every rank of a
    column-parallel site holds only its columns' share of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


def embed(fn, table, ids):
    """``fn(table, ids)``, an embedding lookup, vocab-parallel (Megatron's)
    where the model axis shards the table's rows evenly: ``ids`` keep their
    batch sharding and are whole on the model axis, each rank looks up the
    ids that fall in its rows (zeros elsewhere), and the partial rows are
    summed over the model axis.  No rank gathers the table.
    Differentiable: the table's gradient is each rank's rows, summed over
    the mesh dims that split the ids."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(table, ids)
    table, ids = _dt(table, mesh), _dt(ids, mesh)
    io = _batch(ids, mesh, md)
    vocab = _shard_dim(table, md) == 0 and table.shape[0] % mesh.size(md) == 0
    tin = _on_model(mesh, md, Shard(0)) if vocab else [Replicate()] * mesh.ndim
    tgrad = [Partial() if isinstance(pl, Shard) else t for pl, t in zip(io, tin)]
    out = list(io)
    local = fn
    if vocab:
        out[md] = Partial()
        v0 = mesh.get_local_rank(md) * (table.shape[0] // mesh.size(md))

        def local(tl, il):
            idx = il.long() - v0
            mine = (idx >= 0) & (idx < tl.shape[0])
            return fn(tl, idx.clamp(0, tl.shape[0] - 1)) * mine[..., None].to(tl.dtype)

    y = local_map(local, out_placements=out, in_placements=(tin, io),
                  in_grad_placements=(tgrad, io), device_mesh=mesh,
                  redistribute_inputs=True)(table, ids)
    if vocab:
        out[md] = Replicate()
        y = y.redistribute(mesh, out)
    return y


def matmul(fn, x, w):
    """``fn(x, w)``, a float site's ``x @ w`` (x [..., K], w [K, N] or a
    vector [K]), on each rank's rows: the leading dims of ``x`` keep their
    sharding, and the weight's placement on the model axis picks the style
    (module docstring): column-parallel (x whole on K, output sharded on
    N), row-parallel (x sharded on K, partial sums reduced), or, for a
    replicated weight, x's own placement on that axis too.  A sharding that
    splits a dim unevenly is gathered first.  Differentiable: a weight used
    on a rank's rows gets that rank's partial gradient (``Partial`` over the
    mesh dims that split the rows), and a column-parallel input's gradient
    is summed over the model axis inside the site (:class:`_SumGrad`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, md = _mesh(x, w)
    x, w = _dt(x, mesh), _dt(w, mesh)
    last = x.ndim - 1
    wd = _shard_dim(w, md)
    if wd is not None and w.shape[wd] % mesh.size(md):
        wd = None  # an uneven weight shard takes the replicated route
    xin = [pl if isinstance(pl, Shard) and pl.dim < last and (i != md or wd is None)
           else Replicate() for i, pl in enumerate(x.placements)]
    xin = [Replicate() if isinstance(pl, Shard) and x.shape[pl.dim] % _shards(x, pl.dim, xin)
           else pl for pl in xin]
    out, win = list(xin), [Replicate()] * mesh.ndim
    wgrad = [Partial() if isinstance(pl, Shard) else Replicate() for pl in xin]
    local = fn
    if wd is not None:
        win[md] = wgrad[md] = Shard(wd)
        if wd == 0:  # row-parallel
            xin[md] = Shard(last)
            out[md] = Partial()
        else:  # column-parallel
            out[md] = Shard(last)
            group = mesh.get_group(md)

            def local(xl, wl):
                return fn(_SumGrad.apply(xl, group), wl)

    y = local_map(local, out_placements=out, in_placements=(xin, win),
                  in_grad_placements=(xin, wgrad), device_mesh=mesh,
                  redistribute_inputs=True)(x, w)
    if wd == 0:  # the row-parallel partial sums, reduced
        out[md] = Replicate()
        y = y.redistribute(mesh, out)
    return y


def _groups(old, new) -> list:
    """The dims of a reshape from ``old`` to ``new`` in aligned groups:
    [(old dims, new dims)], each pair of runs of equal product."""
    out, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        a, b, po, pn = i, j, 1, 1
        if i < len(old):
            po, i = old[i], i + 1
        if j < len(new):
            pn, j = new[j], j + 1
        while po != pn:
            if po < pn:
                po, i = po * old[i], i + 1
            else:
                pn, j = pn * new[j], j + 1
        out.append((range(a, i), range(b, j)))
    return out


def reshape(fn, x, shape):
    """``fn(x, shape)``, a reshape, on each rank's local block.  A mesh
    dim sharding tensor dim ``d`` keeps its sharding, on the first dim of
    ``d``'s group in the new shape that is not 1, where ``d`` is the major
    dim of its group (every dim before it in the group is 1) and both dims
    split evenly; otherwise that mesh dim is gathered first.  The local
    block is then one contiguous run of the group in both shapes, and the
    local reshape is the global one's block."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    old = tuple(x.shape)
    shape = tuple(int(n) for n in shape)
    if -1 in shape:
        known = -1 * torch.Size(shape).numel()
        shape = tuple(x.numel() // known if n == -1 else n for n in shape)
    where = {d: g for g in _groups(old, shape) for d in g[0]}
    xin, out = [], []
    for pl in x.placements:
        if isinstance(pl, Shard):
            olds, news = where[pl.dim]
            major = [e for e in news if shape[e] != 1]
            n = _shards(x, pl.dim, x.placements)
            if (major and all(old[d] == 1 for d in olds if d < pl.dim)
                    and old[pl.dim] % n == 0 and shape[major[0]] % n == 0):
                xin.append(pl)
                out.append(Shard(major[0]))
                continue
            pl = Replicate()
        xin.append(pl)
        out.append(pl)
    local = tuple(n // _shards(x, e, out) for e, n in enumerate(shape))
    return local_map(lambda t: fn(t, local), out_placements=out, in_placements=(xin,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def fast_wht(fn, x, block=None):
    """``fn(x, block)``, the blocked WHT, on each rank's rows."""
    b = block or block_size_for(x.shape[-1])
    return local_rows(lambda t: fn(t, b), x, b)


def apply_blocked(fn, x, mat, block: int):
    """``fn(x, mat, block)``, a block-diagonal matmul, on each rank's rows."""
    return local_rows(lambda t: fn(t, mat, block), x, block)


def write_slots(fn, buf, start: int, new):
    """``fn(buf, start, new)``, a cache write into slots ``[start, start +
    L)`` of dim 1.  A cache placed whole on that dim (batch or channels
    sharded, or replicated) takes the write as it is.  A cache sharded on
    its slots (the ``seq_axis_shard``/``seq_model_shard`` specs of
    ``sharding.cache_pspecs``) is written by each rank into its local
    tensor, in place: the slots of ``[start, start + L)`` that fall in its
    own shard, at its global offset on that dim; ``new`` is replicated over
    the mesh dims of the slots and placed as the cache elsewhere.  No rank
    gathers the cache.  A plain cache raises: DTensor cannot write a
    sharded forward's values into it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if not is_dtensor(buf):
        raise TypeError("a sharded forward writes a plain cache: place the cache with "
                        "sharding.distribute_tree (specs from sharding.cache_pspecs)")
    seq = [i for i, pl in enumerate(buf.placements) if isinstance(pl, Shard) and pl.dim == 1]
    if not seq:
        fn(buf, start, new)
        return
    mesh = buf.device_mesh
    new = _dt(new, mesh).redistribute(
        mesh, [Replicate() if i in seq else pl for i, pl in enumerate(buf.placements)])
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, buf.placements)
    lo, hi = int(offset[1]), int(offset[1]) + int(shape[1])
    a, b = max(start, lo), min(start + new.shape[1], hi)
    if a < b:
        buf.to_local()[:, a - lo:b - lo] = new.to_local()[:, a - start:b - start]
