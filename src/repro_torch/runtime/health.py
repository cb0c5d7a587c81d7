"""Straggler detection: per-step timing watchdog.

On a pod each host reports step wall-times through the coordinator; hosts
whose p50 exceeds the fleet p50 by ``threshold``× for ``patience``
consecutive windows are flagged, triggering either (a) checkpoint + elastic
re-mesh without them, or (b) scheduler eviction. The serving mesh
(``serve/mesh.py``) feeds it per-replica query latencies. A plain-Python copy
of ``repro.runtime.health``.
"""
from __future__ import annotations

import collections
from typing import Dict, List


class StragglerWatchdog:
    """Flag members whose median report exceeds the fleet median.

    Host ids are any hashable key — training uses int host ids, the serving
    mesh (``serve/mesh.py``) uses ``(shard, replica)`` tuples with query
    latencies as the reported "step times".

    A host whose history has gone QUIET — no report for ``window`` full
    fleet rounds (``window · n_hosts`` reports fleet-wide) — stops voting:
    its stale median is excluded from the fleet baseline, it can't be
    flagged on dead history, and its strikes reset. A crashed host is the
    failure DETECTOR's job (it stops answering at all); the watchdog's job
    is live-but-slow, which requires live data.
    """

    def __init__(self, threshold: float = 2.0, patience: int = 3, window: int = 16):
        self.threshold = threshold
        self.patience = patience
        self.histories: Dict[object, collections.deque] = {}
        self.strikes: Dict[object, int] = collections.defaultdict(int)
        self.window = window
        self._tick = 0                          # fleet-wide report counter
        self._last_seen: Dict[object, int] = {}

    def report(self, host_id, step_time: float) -> None:
        self._tick += 1
        self._last_seen[host_id] = self._tick
        self.histories.setdefault(
            host_id, collections.deque(maxlen=self.window)
        ).append(step_time)

    def _median(self, xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def _active(self) -> List[object]:
        """Hosts with recent data: reported within the last ``window`` fleet
        rounds. Quiet hosts drop out of the baseline and un-strike."""
        horizon = self.window * max(1, len(self.histories))
        active = [h for h, t in self._last_seen.items()
                  if self._tick - t < horizon]
        for h in self.histories:
            if h not in active:
                self.strikes[h] = 0
        return active

    def check(self) -> List[object]:
        """Returns host ids currently flagged as stragglers."""
        if len(self.histories) < 2:
            return []
        medians = {h: self._median(list(self.histories[h]))
                   for h in self._active() if len(self.histories[h]) >= 3}
        if len(medians) < 2:
            return []
        fleet = self._median(list(medians.values()))
        flagged = []
        for h, m in medians.items():
            if m > self.threshold * fleet:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                flagged.append(h)
        return flagged
