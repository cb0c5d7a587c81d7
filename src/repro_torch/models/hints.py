"""Logical-axis sharding hints for model internals (port of
``repro.models.hints``).

Model code stays mesh-agnostic: it annotates intermediates with LOGICAL
axes (``constrain(x, ("expert", "tokens", None))``); the launch layer
activates a mapping from logical axes to mesh dimensions for a stretch of
code. With no active mapping every call returns its input, so tests and
single-device paths are unaffected.

Where the reference takes the mesh from the surrounding ``with mesh:``,
the port takes it from the tensor: a DTensor carries its own
``device_mesh``, and ``constrain`` redistributes it there. A plain tensor
has no mesh, so it needs the named argument ``mesh=`` (it is then taken
as the whole tensor, the same on every rank, and distributed). The
mapping is thread-local, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

from repro_torch.launch.sharding import P, placements

_state = threading.local()

Axis = Union[str, Tuple[str, ...], None]


def _current() -> Optional[Dict[str, Axis]]:
    return getattr(_state, "mapping", None)


@contextlib.contextmanager
def sharding_hints(**mapping: Axis):
    """Activate a logical → mesh dimension mapping, e.g.
    ``sharding_hints(expert="model", tokens=("data",))``; the previous
    mapping comes back on exit."""
    prev = _current()
    _state.mapping = dict(mapping)
    try:
        yield
    finally:
        _state.mapping = prev


def constrain(x, logical_axes: Tuple[Optional[str], ...], *, mesh=None):
    """``x`` laid out as the active mapping says: a DTensor redistributed
    on its own mesh, a plain tensor distributed on ``mesh=``. Without a
    mapping, ``x`` itself."""
    mapping = _current()
    if mapping is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor

    spec = P(*[mapping.get(a) if a is not None else None for a in logical_axes])
    if isinstance(x, DTensor):
        if mesh is not None and mesh != x.device_mesh:
            raise ValueError("constrain redistributes a DTensor on its own "
                             "mesh; mesh= names another")
        return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))
    if mesh is None:
        raise ValueError("constrain under sharding_hints needs a DTensor or "
                         "mesh=: a plain tensor carries no mesh")
    return distribute_tensor(x, mesh, placements(mesh, spec))
