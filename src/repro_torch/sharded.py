"""The one door from model code to the sharded route (``parallel/sites.py``).

Model code runs on DTensors as written (under ``implicit_replication()``),
except at the ops that cannot take them: a kernel reads the ``data_ptr``
of local tensors, and a head split or a blocked transform reshapes a
sharded dim in a way DTensor's view rules refuse.  Those ops reach
``parallel/sites.py`` through this module, which holds every route:

* a kernel site asks :func:`kernels_for` for its wrappers: ``kernels.ops``,
  or, when an operand is a DTensor, ``parallel.sites``, whose functions of
  the same names run the wrappers on local shards;
* an op decorated with :func:`routed` runs as it is on plain tensors, and
  with a DTensor among its positional arguments runs the function of its
  name in ``parallel.sites``, handed the op itself.

Nothing here imports ``torch.distributed``: a single-device run never
loads it.
"""
from __future__ import annotations

import functools
import sys

__all__ = ["is_dtensor", "refuse_dtensor", "kernels_for", "routed"]


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed`` DTensor.  None can exist before
    ``torch.distributed.tensor`` is imported, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise if any operand is a DTensor.  A kernel takes ``data_ptr``s of
    local tensors, and a DTensor's plain version would compute on its
    local shard as if it were the whole: a sharded path hands the kernel
    sites local shards (``parallel/sites.py``)."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{kernel}: got a DTensor; kernels take local shards "
                        "(run the site through repro_torch.parallel.sites)")


def kernels_for(*tensors):
    """``kernels.ops``, or ``parallel.sites`` (the same wrappers on local
    shards) when any of ``tensors`` is a DTensor."""
    if any(is_dtensor(t) for t in tensors):
        from repro_torch.parallel import sites

        return sites
    from repro_torch.kernels import ops

    return ops


def routed(fn):
    """``fn``, or ``parallel.sites.<fn's name>(fn, *args, **kw)`` when a
    positional argument is a DTensor."""

    @functools.wraps(fn)
    def op(*args, **kw):
        mod = sys.modules.get("torch.distributed.tensor")
        if mod is not None and any(isinstance(a, mod.DTensor) for a in args):
            from repro_torch.parallel import sites

            return getattr(sites, fn.__name__)(fn, *args, **kw)
        return fn(*args, **kw)

    return op
