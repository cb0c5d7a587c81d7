"""Sharding rules (port of ``repro.launch.sharding``): the optimizer and
train-state specs and the iCD specs, as ``DeviceMesh`` + DTensor
placements.

Conventions (the reference's):
  * batch/context dims shard over ``dp`` = ("pod", "data") on multi-pod,
    ("data",) on single-pod;
  * weights shard over "model" on their parallel dim and over "data" on
    the other large dim (ZeRO/FSDP); parameters are NOT sharded over
    "pod": the only traffic between pods is the gradient all-reduce;
  * embedding tables row-shard over "model";
  * small vectors (norms, biases) replicate.

:class:`P` stands in for JAX's ``PartitionSpec``: one entry per tensor
dimension, ``None`` (replicated), a mesh dimension's name, or a tuple of
names. :func:`named` turns a tree of them into :class:`NamedSharding`
leaves, the mesh and the placements that ``distribute_tensor`` takes:
``Shard(d)`` on each mesh dimension a tensor dimension d names, and
``Replicate()`` on the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.launch.mesh import dp_axes
from repro_torch.optim.base import tree_map


class P:
    """PartitionSpec stand-in: ``P(("data",), None)`` shards a matrix's
    rows over "data" and replicates its columns. A leaf of the port's
    trees (not a tuple), compared by its entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(("P",) + self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def placements(mesh, spec: P) -> tuple:
    """The DTensor placements, one per mesh dimension, that lay a tensor
    out as ``spec`` says on ``mesh``. A name the mesh lacks, or one mesh
    dimension named twice, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name not in names:
                raise ValueError(f"{spec}: mesh has no dimension {name!r} "
                                 f"(it has {names})")
            i = names.index(name)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh dimension {name!r} named twice")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``distribute_tensor(t, s.mesh, s.placements)``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def named(mesh, spec_tree):
    return tree_map(lambda spec: NamedSharding(mesh, spec), spec_tree)


def _drop_data(spec: P) -> P:
    """Replace every 'data'/('data',) entry with None (ZeRO-1 live params:
    replicated over data, sharded over model only)."""
    def clean(e):
        if e == "data" or e == ("data",):
            return None
        return e

    return P(*[clean(e) for e in spec])


# ------------------------------------------------------------- optimizer --
def opt_state_specs(param_specs):
    """AdamW state: m/v mirror the parameters, step replicates."""
    return {"step": P(), "m": param_specs, "v": param_specs}


def train_state_specs(param_specs):
    from repro_torch.train.train_step import TrainState

    return TrainState(params=param_specs, opt=opt_state_specs(param_specs),
                      step=P())


def zero1_state_specs(fsdp_param_specs) -> Tuple[Any, Any]:
    """ZeRO-1 TrainState specs: live (bf16) params lose the 'data' axis;
    the fp32 master + adam moments inside the optimizer keep it."""
    from repro_torch.train.train_step import TrainState

    live = tree_map(_drop_data, fsdp_param_specs)
    opt = {"master": fsdp_param_specs,
           "inner": opt_state_specs(fsdp_param_specs)}
    return TrainState(params=live, opt=opt, step=P()), live


# ------------------------------------------------------------------ icd ---
def icd_mf_specs(mesh):
    """W rows (contexts) over dp; H rows (items) over model; observation
    arrays over dp. The k×k Grams replicate: Lemma 2's k² all-reduce."""
    from repro_torch.core.models.mf import MFParams

    dp = dp_axes(mesh)
    params = MFParams(w=P(dp, None), h=P("model", None))
    data = dict(
        ctx=P(dp), item=P(dp), y=P(dp), alpha=P(dp),
        t_ctx=P(dp), t_item=P(dp), t_perm=P(dp),
    )
    return params, data
