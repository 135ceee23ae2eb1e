"""Elastic scaling and straggler helpers (counterpart of
:mod:`repro.train.elastic`).

* :func:`reshard_tree` — move a tree onto a new mesh's placements
  (recovery without a checkpoint while the tensors still exist; the
  checkpointed path is :mod:`repro_torch.train.checkpoint`).
* :class:`StepWatchdog` — per-step wall-time tracker that flags stragglers
  (steps longer than ``factor`` times the rolling median).
* :func:`plan_elastic_mesh` — given the surviving device count, the
  largest (data, model) grid that keeps the model axis.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Mapping

import torch

from ..sharding.rules import from_whole, is_dtensor, mesh_placements


def reshard_tree(tree, mesh, specs):
    """Every leaf of ``tree`` (a dict, list or tuple of tensors, nested)
    placed on ``mesh`` by the spec at the same place in ``specs`` (a
    tuple of mesh-axis names, tuples of names or None per dim, as
    :func:`~repro_torch.models.params.param_specs` gives).

    A plain tensor (the whole tensor, the same on every rank, on the host
    or the device) gives each rank a copy of its own block on the mesh's
    device, no collective; a DTensor on ``mesh`` is redistributed; a
    DTensor on another mesh goes through the whole tensor
    (``full_tensor``, a collective over its old mesh: every rank of it
    must call), since a DTensor cannot be redistributed across meshes."""
    if isinstance(tree, Mapping):
        return {k: reshard_tree(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        out = [reshard_tree(v, mesh, s) for v, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(
            tree)(out)
    want = mesh_placements(mesh, tuple(specs))
    if is_dtensor(tree):
        if tree.device_mesh == mesh:
            return tree.redistribute(mesh, want)
        tree = tree.full_tensor()
    return from_whole(tree, mesh, want)


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
