"""Production meshes (port of ``repro.launch.mesh``) as ``DeviceMesh``es.

Single pod: 16×16 = 256 devices, dimensions ("data", "model").
Multi-pod:  2×16×16 = 512 devices, dimensions ("pod", "data", "model"): the
``pod`` dimension composes with ``data`` for batch/context sharding;
``model`` stays inside a pod, so tensor-parallel collectives never cross
the slower links between pods, and parameters are replicated across
pods (the gradient all-reduce is the only collective between pods).

Functions, not module constants: importing this module touches no device
or process-group state. ``make_production_mesh`` needs a
``torch.distributed`` world of exactly that many ranks, already
initialised.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh_of_one(device_type: str = "cuda"):
    """The production mesh's dimensions, ("data", "model"), at 1 × 1: a
    world of one rank (``collectives.world_of_one`` or ``fake_world(1)``)
    runs a cell at its global shape on this."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The batch/context sharding dimensions of this mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def n_chips(mesh) -> int:
    return int(mesh.size())
