"""Device meshes (port of ``repro/launch/mesh.py``): the production 16 x 16
and 2 x 16 x 16 meshes, and a small local one for tests and examples.

FUNCTIONS, not module constants: importing this module touches no process
group.  Each builds a ``torch.distributed`` ``DeviceMesh`` over the default
process group, which the caller has initialised with as many ranks as the
mesh has (``init_device_mesh`` initialises one from the environment if
none is).  ``device_type`` is ``"cuda"`` unless the caller asks for the
CPU (gloo ranks, or the ``fake`` backend of a dry run).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A (data, model) mesh over ``data * model`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
