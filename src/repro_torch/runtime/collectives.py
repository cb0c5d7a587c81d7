"""Collectives over ``torch.distributed`` process groups: the port's
counterparts of the ``jax.lax`` collectives the reference calls inside
``shard_map``.

  ``jax.lax.psum``                 → :func:`all_reduce`
  ``lax.all_gather(tiled=True)``   → :func:`all_gather`
  ``lax.all_to_all(tiled=True)``   → :func:`all_to_all`

Where the reference names a mesh axis, a shard's body here names its
group (:func:`group_of`): a ``ProcessGroup``, a 1-D ``DeviceMesh``, or
``(mesh, dim_name)`` for one dimension of a larger mesh, resolved once
into a :class:`Group` by a caller that runs many collectives.

Devices are explicit: a CUDA tensor needs an NCCL group and a CPU tensor
a gloo group, and any other pairing raises. Nothing falls back to the
other backend or to a local copy. The one other pairing is the dry run's
(``launch/dryrun.py``): a ``meta`` tensor, which holds a shape and no
data, on a group of torch's ``fake`` backend (:func:`fake_world`), which
moves nothing. A meta tensor needs a fake group and a fake group serves
meta tensors only, so no tensor with data ever reaches one.

Each wrapper counts its calls in its ``calls`` attribute (as the kernel
wrappers count ``launches``) and its payload in ``bytes``: the tensor an
all-reduce or an all-to-all sends, the result of an all-gather. So a
caller can read how many collectives a step made and what they carried
(:func:`read_counts`, :func:`read_bytes`).
"""
from __future__ import annotations

import contextlib

import torch


class Group:
    """A process group resolved once: its backend checked and its size
    read where the group is named, so that a collective on it checks only
    its tensor's device (``ProcessGroup`` itself is ``.pg``)."""

    __slots__ = ("pg", "size", "nccl", "gloo", "fake")

    def __init__(self, pg):
        import torch.distributed as dist

        backend = str(dist.get_backend(pg))
        self.pg, self.size = pg, dist.get_world_size(pg)
        self.nccl, self.gloo = "nccl" in backend, "gloo" in backend
        self.fake = backend == "fake"
        if not (self.nccl or self.gloo or self.fake):
            raise RuntimeError(f"a collective needs an nccl, a gloo or (for "
                               f"meta tensors) a fake group; this group's "
                               f"backend is {backend!r}")

    def checked(self, t: torch.Tensor):
        """The ``ProcessGroup``, after checking that it serves ``t``'s
        device: a CUDA tensor needs NCCL, a CPU tensor gloo, a meta tensor
        a fake group, which serves nothing else."""
        if t.is_meta or self.fake:
            if not (t.is_meta and self.fake):
                raise RuntimeError(
                    f"a meta tensor needs a fake group and a fake group "
                    f"serves only meta tensors; this is a {t.device.type} "
                    f"tensor on a {'fake' if self.fake else 'real'} group")
            return self.pg
        if not (self.nccl if t.is_cuda else self.gloo):
            want = "nccl" if t.is_cuda else "gloo"
            raise RuntimeError(f"a {t.device.type} tensor needs a {want} "
                               f"group; this one has none")
        return self.pg


def group_of(group_or_mesh_dim) -> Group:
    """The :class:`Group` a collective runs on, from a ``Group``, a
    ``ProcessGroup``, a 1-D ``DeviceMesh`` or a ``(DeviceMesh, dim_name)``
    pair. A caller that runs many collectives resolves its group once."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    g = group_or_mesh_dim
    if isinstance(g, Group):
        return g
    if isinstance(g, tuple) and len(g) == 2 and isinstance(g[0], DeviceMesh):
        return Group(g[0].get_group(g[1]))
    if isinstance(g, DeviceMesh):
        if g.ndim != 1:
            raise ValueError(
                f"a {g.ndim}-D mesh names no single group; pass "
                f"(mesh, dim) with dim in {g.mesh_dim_names}")
        return Group(g.get_group())
    if isinstance(g, dist.ProcessGroup):
        return Group(g)
    raise TypeError(
        "expected a Group, a ProcessGroup, a 1-D DeviceMesh or "
        f"(DeviceMesh, dim), got {type(g).__name__}")


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the group, in place; returns ``t`` (``psum``)."""
    import torch.distributed as dist

    group = group_of(group)
    dist.all_reduce(t, group=group.checked(t))
    all_reduce.calls += 1
    all_reduce.bytes += t.nbytes
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along dim 0 in rank order
    (``all_gather(tiled=True)``)."""
    import torch.distributed as dist

    group = group_of(group)
    t = t.contiguous()
    out = t.new_empty((group.size * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group.checked(t))
    all_gather.calls += 1
    all_gather.bytes += out.nbytes
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``t`` cut into one equal block per rank, block r sent to
    rank r; the blocks received, in source-rank order
    (``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    import torch.distributed as dist

    group = group_of(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group.checked(t))
    all_to_all.calls += 1
    all_to_all.bytes += t.nbytes
    return out


def mesh_barrier(mesh) -> None:
    """Return on every rank of ``mesh`` only after every rank of it has
    called this: one all-reduce over each dimension in turn (each rank's
    row then column reaches every other rank), each read back to the host.
    The read-back is the barrier on NCCL, whose all-reduce only queues
    work on the card and returns; it also waits for the work this rank
    queued before the call."""
    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    for dim in range(mesh.ndim):
        all_reduce(torch.zeros((1,), device=device), mesh.get_group(dim)).item()


@contextlib.contextmanager
def world_of_one(backend: str = "nccl"):
    """A ``torch.distributed`` world of this process alone, its store in
    memory (no file, no port), torn down on exit: the distribution layer
    on one card (``"nccl"``) or, when the caller names it, on the CPU
    (``"gloo"``)."""
    import torch.distributed as dist

    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``torch.distributed`` world of ``world_size`` ranks in which this
    process is rank 0 and no other rank exists: torch's ``fake`` backend
    (``FakeStore``), whose collectives return at once and move nothing.
    Only meta tensors may use it (:class:`Group`). The dry run traces one
    rank of a production mesh in it; torn down on exit."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


_WRAPPERS = (all_reduce, all_gather, all_to_all)


def reset_counts() -> None:
    for fn in _WRAPPERS:
        fn.calls = 0
        fn.bytes = 0


def read_counts() -> dict:
    return {fn.__name__: fn.calls for fn in _WRAPPERS}


def read_bytes() -> dict:
    """Each wrapper's payload bytes since :func:`reset_counts`: what an
    all-reduce or an all-to-all sent, what an all-gather returned."""
    return {fn.__name__: fn.bytes for fn in _WRAPPERS}


reset_counts()
