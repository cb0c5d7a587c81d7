"""Training loop with checkpointing, fault tolerance and straggler hooks
(port of ``repro.train.trainer``)."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime import hosts
from repro_torch.runtime.health import StragglerWatchdog


class Trainer:
    def __init__(
        self,
        step_fn: Callable,
        state,
        data_iter: Iterator[Dict],
        checkpointer: Optional[Checkpointer] = None,
        ckpt_every: int = 100,
        watchdog: Optional[StragglerWatchdog] = None,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
    ):
        self.step_fn = step_fn
        self.state = state
        self.data_iter = data_iter
        self.checkpointer = checkpointer
        self.ckpt_every = ckpt_every
        self.watchdog = watchdog or StragglerWatchdog()
        self.log_every = log_every
        self.log_fn = log_fn
        self.metrics_history = []

    def maybe_resume(self) -> int:
        """Resume from the latest valid checkpoint if one exists."""
        if self.checkpointer is None:
            return 0
        step, restored = self.checkpointer.restore_latest(self.state)
        if restored is not None:
            self.state = restored
            self.log_fn(f"[trainer] resumed from step {step}")
            return int(step)
        return 0

    def run(self, n_steps: int) -> Any:
        start = self.maybe_resume()
        for i in range(start, n_steps):
            batch = next(self.data_iter)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.watchdog.report(hosts.process_index(), dt)
            self.metrics_history.append(metrics)
            if (i + 1) % self.log_every == 0:
                self.log_fn(
                    f"[trainer] step {i + 1} "
                    + " ".join(f"{k}={v:.4g}" for k, v in metrics.items())
                    + f" ({dt * 1e3:.1f} ms)"
                )
            if self.checkpointer and (i + 1) % self.ckpt_every == 0:
                self.checkpointer.save(i + 1, self.state)
            flagged = self.watchdog.check()
            if flagged:
                self.log_fn(f"[trainer] stragglers flagged: {flagged} "
                            "(would trigger elastic re-mesh on a pod)")
        if self.checkpointer:
            self.checkpointer.save(n_steps, self.state, blocking=True)
        return self.state
