"""Elastic scaling: rebuild the mesh on a changed set of ranks and
reshard (port of ``repro.runtime.elastic``).

The recovery protocol:

  1. the watchdog or the launcher reports failed ranks;
  2. pick the largest (data, model)-factorizable subset of the survivors;
  3. rebuild the ``DeviceMesh`` over them;
  4. restore the latest checkpoint with the NEW shardings (the
     checkpointer's ``shardings=`` path): parameters need no repartition
     step of their own.

Building a mesh creates one process group for each row and each column
of it with ``torch.distributed.new_group``, a collective of the whole
world: every rank of the world calls :meth:`ElasticMeshManager.build` and
:meth:`~ElasticMeshManager.on_failure`, ranks outside the new mesh too.
On those, ``mesh.get_coordinate()`` is None and they hold no shard. The
data pipeline re-shards by host index (``repro_torch.data.loader``), so a
resize changes only each host's batch slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def largest_mesh_shape(n_devices: int, model_axis: int) -> Tuple[int, int]:
    """Largest (data, model) grid with model ≤ ``model_axis`` that tiles
    the surviving device count exactly. Keeps tensor-parallel groups as
    large as possible and sheds whole data-parallel replicas instead.

    The model axis shrinks to the LARGEST DIVISOR of ``n_devices`` that is
    ≤ ``model_axis`` (``n_devices=8, model_axis=6`` gives ``(2, 4)``,
    ``n_devices=250, model_axis=16`` gives ``(25, 10)``)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    cap = max(1, min(model_axis, n_devices))
    model = max(d for d in range(1, cap + 1) if n_devices % d == 0)
    return n_devices // model, model


class ElasticMeshManager:
    """Builds (data, model) meshes over ranks of an initialised world.
    ``device_type`` is the mesh's: ``"cuda"`` (NCCL) unless the caller
    names ``"cpu"`` (gloo)."""

    def __init__(self, axis_names=("data", "model"), model_axis: int = 1,
                 device_type: str = "cuda"):
        self.axis_names = tuple(axis_names)
        self.model_axis = model_axis
        self.device_type = device_type
        self.mesh = None

    def build(self, ranks: Optional[Sequence[int]] = None):
        """A mesh over ``ranks`` (every rank of the world by default),
        its shape from :func:`largest_mesh_shape`. Every rank of the world
        calls it."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
        data, model = largest_mesh_shape(len(ranks), self.model_axis)
        grid = torch.tensor(ranks[: data * model]).reshape(data, model)
        self.mesh = DeviceMesh(self.device_type, grid,
                               mesh_dim_names=self.axis_names)
        return self.mesh

    def on_failure(self, failed_ranks: Sequence[int]):
        """Rebuild over the world's ranks less ``failed_ranks`` (in a
        test, a simulated failure: those ranks still take part in
        creating the new groups)."""
        import torch.distributed as dist

        failed = set(failed_ranks)
        return self.build([r for r in range(dist.get_world_size())
                           if r not in failed])

    def shardings(self, spec_tree, params_like):
        """``spec_tree`` as :class:`~repro_torch.launch.sharding.NamedSharding`
        leaves on the current mesh; ``params_like`` is not read, as in the
        reference."""
        from repro_torch.launch.sharding import named

        return named(self.mesh, spec_tree)
