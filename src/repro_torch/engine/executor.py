"""Static in-order chunk dispatch on one device.

Counterpart of the static schedule of :mod:`repro.engine.executor`.  The
accumulator is one int64 tensor on the device (the JAX package's int32
hi/lo pair exists only because JAX runs without x64); chunk units add
their partials into it in place.  :func:`_acc_fetch` is the run's one
device→host copy, and the only one, counted in ``stats["host_syncs"]``.

Backpressure (:func:`_throttle`): after each chunk the executor records a
CUDA event on the current stream and, once more than ``pipeline_depth``
chunks are in flight, waits on the oldest event — a wait, not a copy —
so the host never runs more than ``pipeline_depth`` chunks ahead of the
card.  CPU ops run synchronously and need no window.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch


class ChunkTask(NamedTuple):
    """One span ``[start, end)`` of the dyad stream, its predicted work,
    and a static per-task key: the bucket width ``K`` on the tiles
    backend, the ragged candidate count on the search backend."""

    start: int
    end: int
    cost: float = 0.0
    key: Optional[int] = None


def _acc_fetch(plan, acc: torch.Tensor) -> np.ndarray:
    """THE device→host copy of a run, a batch or a delta correction
    (counted once): ``acc`` is ``(total_bins,)``, or ``(B, total_bins)``
    for a batch of B graphs."""
    plan.stats["host_syncs"] += 1
    return acc.cpu().numpy().astype(np.int64)


def _throttle(window: collections.deque, device: torch.device,
              depth: int) -> None:
    """Allow at most ``depth`` chunks in flight on ``device``."""
    if device.type != "cuda":
        return
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    window.append(event)
    if len(window) > depth:
        window.popleft().synchronize()


class Executor:
    """In-order dispatch of one plan's chunk tasks on the plan's device."""

    def __init__(self, config, stats: dict, device: torch.device):
        self.depth = config.pipeline_depth
        self.stats = stats
        self.device = device

    def run(self, tasks, step) -> None:
        """Call ``step(task)`` for every task in order; each call folds its
        partial counts into the plan's accumulator."""
        window: collections.deque = collections.deque()
        for t in tasks:
            step(t)
            self.stats["chunks"] += 1
            _throttle(window, self.device, self.depth)
