"""Engine configuration: the knobs of the port's single-device census path.

Counterpart of :mod:`repro.engine.config` for the port's slices so far.
One frozen, hashable dataclass, :class:`EngineConfig`; it is part of the
plan-cache key.  :data:`CensusConfig` is the same class under its
census-era name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.graph import resolve_device

BACKENDS = ("tiles", "search", "auto")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static execution policy for a census pass.

    Attributes:
        backend: ``"tiles"`` (degree-bucketed dyads through the
            hand-written CUDA census kernel, which reads the CSR rows
            directly; the counterpart of the JAX ``"pallas"`` backend),
            ``"search"`` (the binary-search batch program as torch ops;
            the counterpart of ``"xla"``), or ``"auto"`` (resolves to
            ``"tiles"``).
        device: torch device the plan runs on.  ``None`` means ``"cuda"``;
            pass ``"cpu"`` to run on the CPU (the tiles backend then runs
            the kernel's plain torch version).  Asking for CUDA on a
            machine without it raises — the engine never moves to the CPU
            on its own.
        batch: chunk granularity: the streaming chunk is a whole number of
            batches, and ``block`` defaults to ``min(batch, 32)``.
        block: census-kernel block, the dyads per output row of partials.
            ``None`` picks ``min(batch, 32)``.
        k: top bucket width override (>= the graph's max degree).
            ``None`` derives a power-of-two bucket from the max degree.
        buckets: degree-bucket widths of the tiles backend (the
            smallest bucket >= a dyad's degree need wins; the plan's ``k``
            is always the top bucket).  Non-empty, positive, strictly
            increasing.
        chunk_dyads: streaming chunk size in dyads (``None`` = 8192),
            rounded up to whole batches and capped at the graph's
            dyad-count bucket.
        pipeline_depth: max chunks in flight on the card before the host
            waits (``1`` = lockstep, ``2`` = double buffering).
        delta_threshold: incremental-census cutoff, in ``(0, 1]``.
            ``Plan.apply_delta`` runs the affected-subset correction only
            while the mutation footprint (affected dyads over the larger
            dyad stream) stays at or below it, else a full pass.  The
            default ``0.5`` is the delta pass's break-even: it walks the
            affected set twice, once per graph version.  ``1.0`` always
            prefers the delta path.
    """

    backend: str = "auto"
    device: Optional[str] = None
    batch: int = 256
    block: Optional[int] = None
    k: Optional[int] = None
    buckets: Tuple[int, ...] = (32, 128, 512)
    chunk_dyads: Optional[int] = None
    pipeline_depth: int = 2
    delta_threshold: float = 0.5

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.device is not None:
            object.__setattr__(self, "device", str(torch.device(self.device)))
        if self.batch < 1:
            raise ValueError("batch must be >= 1")
        if self.block is not None and self.block < 1:
            raise ValueError("block must be >= 1")
        object.__setattr__(self, "buckets",
                           tuple(int(b) for b in self.buckets))
        if not self.buckets:
            raise ValueError("buckets must be non-empty")
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        if any(a >= b for a, b in zip(self.buckets, self.buckets[1:])):
            raise ValueError("buckets must be strictly increasing, "
                             f"got {self.buckets}")
        if self.chunk_dyads is not None and self.chunk_dyads < 1:
            raise ValueError(f"chunk_dyads must be >= 1 (got "
                             f"{self.chunk_dyads}); use None for 8192")
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1 (got "
                             f"{self.pipeline_depth})")
        if not 0.0 < float(self.delta_threshold) <= 1.0:
            raise ValueError(
                f"delta_threshold must be in (0, 1] (got "
                f"{self.delta_threshold}); it is the affected-dyad "
                "fraction above which apply_delta falls back to a full "
                "recompute — 1.0 always prefers the delta path")
        object.__setattr__(self, "delta_threshold",
                           float(self.delta_threshold))

    def resolve_backend(self) -> str:
        """Pin ``"auto"`` to a concrete backend: the tiles path."""
        return "tiles" if self.backend == "auto" else self.backend

    def resolve_device(self) -> torch.device:
        """The plan's device under the port's device rule."""
        return resolve_device(self.device)

    def resolve_chunk(self) -> int:
        """Streaming chunk size, rounded up to a whole number of batches."""
        c = self.chunk_dyads if self.chunk_dyads is not None else 8192
        return max(self.batch, -(-c // self.batch) * self.batch)

    def resolve_block(self) -> int:
        """Tile-kernel block: ``block``, else ``min(batch, 32)``."""
        return self.block if self.block is not None else min(self.batch, 32)


#: Census-era name for :class:`EngineConfig` — the same class.
CensusConfig = EngineConfig
