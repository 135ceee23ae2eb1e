"""Elastic scaling and straggler helpers, the device-count-agnostic part
of :mod:`repro.train.elastic`.

* :class:`StepWatchdog` — per-step wall-time tracker that flags stragglers
  (steps longer than ``factor`` times the rolling median).
* :func:`plan_elastic_mesh` — given the surviving device count, the
  largest (data, model) grid that keeps the model axis.

``reshard_tree`` (moving a tree onto a new mesh's placements) waits for
``sharding/rules.py``.
"""
from __future__ import annotations

import collections
import statistics
import time


def plan_elastic_mesh(n_devices: int, model_parallel: int = 16):
    """Largest (data, model) grid keeping TP fixed; DP absorbs the loss."""
    if n_devices < model_parallel:
        raise ValueError(
            f"need >= {model_parallel} devices to preserve TP degree")
    return (n_devices // model_parallel, model_parallel)


class StepWatchdog:
    """Flags straggling steps; on a fleet the launcher swaps in hot
    spares."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.times = collections.deque(maxlen=window)
        self._t0 = None
        self.stragglers: list[tuple[int, float]] = []

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if dt > self.factor * med:
                self.stragglers.append((step, dt))
                is_straggler = True
        self.times.append(dt)
        return is_straggler

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
