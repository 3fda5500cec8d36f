"""Hardware constants of the card the port targets, and the dry run's
roofline terms (port of ``repro/launch/roofline_util.py``).

NVIDIA H100 SXM 80 GB, from NVIDIA's H100 Tensor Core GPU data sheet
(dense rates; the sheet's starred figures are with sparsity, twice these):

* ``PEAK_FLOPS`` — the int8 tensor-core rate, 1,979 TOP/s.  The precision
  planner's ``_rate_multiplier`` normalizes every level to this INT8 mode,
  and ``chip_smoke.py`` reads its int8 bound from here.
* ``HBM_BW`` — HBM3 bandwidth, 3.35 TB/s (``chip_smoke.py``'s byte bound).
* ``BF16_FLOPS`` — the bf16 tensor-core rate, 989.4 TFLOP/s: the compute
  term of the dry run's :class:`Roofline`.
* ``NVLINK_BW`` — NVLink 4, 900 GB/s a GPU in both directions, so 450 GB/s
  each way: the rate of a collective whose group lies inside one 8-GPU
  NVLink node (``NODE_GPUS``; an HGX/DGX H100 board).
* ``NET_BW`` — 50 GB/s a GPU each way: one 400 Gb/s ConnectX-7 port per GPU
  (NVIDIA's DGX H100 data sheet).  The rate of a collective whose group
  spans nodes: a ring is as fast as its slowest hop.  On the 16 x 16
  production mesh (rank = 16 data + model) the ``model`` axis spans two
  nodes and the ``data`` axis sixteen, so both take this rate; an axis of
  at most 8 consecutive ranks would take ``NVLINK_BW``.

The reference reads its terms from XLA: ``cost_analysis()`` of the
partitioned executable, ``memory_analysis()``, and a parse of the
partitioned HLO text for collectives.  PyTorch has none of these, and this
module emulates none of them.  The dry run executes each cell's step
eagerly on ``meta`` tensors (shapes, no data) placed as DTensors on a
``fake`` process group, under :class:`StepCounter`, which sees every aten
op at the local shapes a rank runs it on (it lets DTensor desugar each op
into its local ops and collectives first, as ``CommDebugMode`` does):

* FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
  attention) applied to the local ops.  ``FlopCounterMode`` around a
  DTensor program counts global shapes; counting the local ops instead is
  exact per rank, replicated work included.  DTensor's own shape
  propagation runs ops on fake tensors of global shapes, which are not
  counted.
* Bytes: each local op's operand and result bytes (views, allocations and
  collectives excluded), summed: an unfused upper bound.  XLA's "bytes accessed"
  counts after fusion, and eager execution has no fusion to count after.
* Collectives: the ``_c10d_functional`` ops DTensor and the port's sharded
  route issue, with their group sizes, through the reference's ring
  formulas (:func:`_wire_bytes`, on the result's bytes), each at
  ``NVLINK_BW`` or ``NET_BW`` by its group's span.  This replaces the
  reference's ``collective_bytes`` parse of HLO text.

Every term is modelled from data-sheet constants, not measured.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "HBM_BW", "BF16_FLOPS", "NVLINK_BW", "NET_BW", "NODE_GPUS",
           "Roofline", "StepCounter", "extract", "time_scan_flops", "model_flops"]

PEAK_FLOPS = 1979e12  # int8 dense tensor-core operations per second
HBM_BW = 3.35e12  # bytes/s
BF16_FLOPS = 989.4e12  # bf16 dense tensor-core FLOP/s
NVLINK_BW = 450e9  # bytes/s a GPU, each way, inside one NVLink node
NET_BW = 50e9  # bytes/s a GPU, each way, between nodes (400 Gb/s)
NODE_GPUS = 8

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# the functional collectives' ops -> the reference's kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "shard_dim_alltoall": "all-to-all",  # DTensor's own op (namespace _dtensor)
}
# ops that move no bytes: allocations, and a view not marked as one
_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
         "_unsafe_view"}


def _wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Per-device wire bytes (ring algorithms) from the RESULT's bytes, as
    the reference reads them.

    all-reduce: result == operand; ring = reduce-scatter + all-gather
                => 2·b·(g-1)/g
    all-gather: result == gathered => received (g-1)/g of result
    reduce-scatter: result == operand/g => sends (g-1)/g of operand
                = result·(g-1)
    all-to-all: keeps 1/g locally => result·(g-1)/g
    collective-permute: full result
    """
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return result_bytes


@dataclasses.dataclass
class Roofline:
    """The three per-device time terms of one step.  ``coll_bytes`` is the
    wire bytes of every collective, ``coll_bytes_intra`` the part whose
    groups lie inside one NVLink node (the rest crosses nodes)."""

    flops: float  # per device
    hbm_bytes: float  # per device
    coll_bytes: float  # per device (wire)
    coll_bytes_intra: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.coll_bytes_intra / NVLINK_BW
                + (self.coll_bytes - self.coll_bytes_intra) / NET_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(name: str) -> tuple[int, bool]:
    """(the size of the process group ``name``, whether its ranks share one
    NVLink node)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ranks = dist.get_process_group_ranks(_resolve_process_group(name))
    return len(ranks), len({r // NODE_GPUS for r in ranks}) == 1


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes and collectives of the ops run under it, at the local
    shapes of one rank (module docstring).  ``collectives`` holds one
    ``(kind, result shape, result bytes, group size, intra-node)`` a
    collective, in issue order."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars it into local ops and collectives
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's shape propagation, at global shapes
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor"):
            if name in _COLLECTIVES:
                size, intra = _group(next(a for a in reversed(args) if isinstance(a, str)))
                for t in _tensors([out]):
                    self.collectives.append(
                        (_COLLECTIVES[name], tuple(t.shape), _nbytes(t), size, intra))
            return out
        if func.is_view or name in _FREE:
            return out
        pk = func._overloadpacket
        if pk in flop_registry:
            self.flops += float(flop_registry[pk](*args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in _tensors([args, list(kwargs.values()), out]))
        return out


def extract(counter: StepCounter) -> dict:
    """The reference's per-cell terms from a :class:`StepCounter`: the
    roofline dict and ``collectives`` ({total, per_kind, count, intra}, the
    wire bytes by kind, and the bytes of groups inside one node)."""
    per_kind = {k: 0.0 for k in KINDS}
    count = {k: 0 for k in KINDS}
    intra = 0.0
    for kind, _, nbytes, size, inside in counter.collectives:
        b = _wire_bytes(kind, nbytes, size)
        per_kind[kind] += b
        count[kind] += 1
        intra += b if inside else 0.0
    total = sum(per_kind.values())
    rl = Roofline(flops=counter.flops, hbm_bytes=counter.bytes, coll_bytes=total,
                  coll_bytes_intra=intra)
    out = rl.as_dict()
    out["collectives"] = {"total": total, "per_kind": per_kind, "count": count,
                          "intra_node": intra}
    return out


def time_scan_flops(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """Analytic FLOPs of inner time-scan recurrences (bodies XLA counts
    once): Mamba selective scan ≈ 8·B·L·d_inner·d_state per layer
    (in-step discretization: exp, dB·u, state update, C·h); RWKV6 wkv
    ≈ 6·B·L·d·head_dim per layer.  Train steps triple (fwd + bwd ~2x).
    Decode steps run the recurrence once (L=1)."""
    l_eff = 1 if shape_kind == "decode" else seq
    mult = 3.0 if shape_kind == "train" else 1.0
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % len(cfg.pattern)]
        if kind == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            total += 8.0 * batch * l_eff * di * cfg.mamba_d_state
        elif kind == "rwkv":
            total += 6.0 * batch * l_eff * cfg.d_model * cfg.rwkv_head_dim
    return total * mult


def model_flops(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS = 6·N_active·D for train, 2·N_active·D for inference
    (per whole step, all devices).  For VGGT shapes ``seq`` is the frame
    count S and tokens = B·S·(patches+special)."""
    total, active = cfg.param_counts()
    if shape_kind.startswith("vggt"):
        tokens = batch * seq * (1024 + cfg.n_special_tokens)
        mult = 6.0 if shape_kind == "vggt_train" else 2.0
        return mult * active * tokens
    tokens = batch * seq if shape_kind != "decode" else batch  # decode: 1 tok
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * active * tokens
