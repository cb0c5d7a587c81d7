"""Live ψ refresh: the double-buffered, versioned table (port of
``repro.serve.publish``, :class:`VersionedTable` only).

``publish`` builds the NEXT snapshot entirely off to the side while
readers still see the old one, then flips it live with ONE reference
assignment of the (snapshot, version) pair — atomic under the interpreter,
so a reader grabbing the active snapshot gets either the complete old one
or the complete new one. The version rides on the snapshot and the request
cache (``serve/batcher.py``) keys on it, so a publish invalidates every
cached result with no flush traffic.

``PsiPublisher``, ``StagedRollout`` and the delta publish helpers wait for
slice 5.
"""
from __future__ import annotations

from typing import Callable


class VersionedTable:
    """Double-buffered holder of the active snapshot.

    ``publish(build)`` calls ``build(next_version)`` to construct the new
    snapshot into the back buffer, then flips it live with one atomic
    reference swap. ``active`` raises until the first publish — a serving
    path must never silently answer from an empty catalogue.
    """

    def __init__(self):
        self._buffers = [None, None]  # [back, live] payloads
        self._state = (None, 0)       # (live snapshot, version) — ONE ref

    @property
    def version(self) -> int:
        return self._state[1]

    @property
    def active(self):
        snapshot, version = self._state  # single read: consistent pair
        if snapshot is None:
            raise RuntimeError(
                "no table published yet — call publish() before serving"
            )
        return snapshot

    def publish(self, build: Callable[[int], object]) -> int:
        """Build the next snapshot with ``build(version)``, then flip."""
        _, version = self._state
        nxt = build(version + 1)
        # the back buffer keeps the previous snapshot alive for readers
        # that grabbed it before the flip
        self._buffers = [self._state[0], nxt]
        self._state = (nxt, version + 1)
        return version + 1
