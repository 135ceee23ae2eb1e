"""Engine configuration: the knobs of the port's census engine.

Counterpart of :mod:`repro.engine.config`.  One frozen, hashable
dataclass,
:class:`EngineConfig`; it is part of the plan-cache key.
:data:`CensusConfig` is the same class under its census-era name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.balance import PACKING, WEIGHTS
from ..core.graph import resolve_device
from .faults import FaultPlan

BACKENDS = ("tiles", "search", "distributed", "auto")
SCHEDULES = ("static", "dynamic")
REORDERS = ("none", "degree", "bfs", "rcm")
PARTITION_MODES = ("serial", "pool", "mesh")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static execution policy for a census pass.

    Attributes:
        backend: ``"tiles"`` (degree-bucketed dyads through the
            hand-written CUDA census kernel, which reads the CSR rows
            directly; the counterpart of the JAX ``"pallas"`` backend),
            ``"search"`` (the binary-search batch program as torch ops;
            the counterpart of ``"xla"``), ``"distributed"`` (one rank
            per process over a ``torch.distributed`` device mesh, each
            rank's share of the dyads through the tiles chunk unit, one
            all-reduce per mesh dimension per run; see
            :mod:`repro_torch.core.distributed`), or ``"auto"``
            (resolves to ``"tiles"``).
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
        chunk_dyads: streaming chunk size in dyads, rounded up to whole
            batches and capped at the graph's dyad-count bucket.
            ``None`` means 8192, except on the static one-slot census
            pass of a plan whose only per-dyad kernel is the census on
            tiles: there it means one ``census_csr`` launch per non-empty
            degree bucket (``backends.bucket_wide``).
        pipeline_depth: max chunks in flight on the card before the host
            waits (``1`` = lockstep, ``2`` = double buffering).
        delta_threshold: incremental-census cutoff, in ``(0, 1]``.
            ``Plan.apply_delta`` runs the affected-subset correction only
            while the mutation footprint (affected dyads over the larger
            dyad stream) stays at or below it, else a full pass.  The
            default ``0.5`` is the delta pass's break-even: it walks the
            affected set twice, once per graph version.  ``1.0`` always
            prefers the delta path.
        schedule: chunk scheduling policy.  ``"static"`` runs the
            fixed-size chunks in order on the plan's device;
            ``"dynamic"`` carves the dyad stream into chunks of roughly
            equal predicted work (``weight_model``; on tiles the
            per-dyad bucket needs) and work-queues them over the
            executor's device pool, the analogue of the paper's OpenMP
            dynamic scheduling (:mod:`repro_torch.engine.executor`).
            ``"dynamic"`` is kept for parity with the JAX package: on a
            pool of one H100 it has no second device to balance and ran
            1.9-2.3x slower than ``"static"`` (``PERF.md``), so it is no
            default until a wider pool is measured to gain from it.
        n_executor_devices: pool width under ``schedule="dynamic"``
            (normalized to 1 under ``"static"``).  On ``"cuda"`` it is
            clamped to ``torch.cuda.device_count()`` and ``None`` means
            every device; on ``"cpu"`` it is that many CPU slots (worker
            threads) as given, and ``None`` means one.  Pinned to 1 on the
            distributed backend, whose mesh owns the devices.
        weight_model: the dyad cost model of the dynamic schedule on the
            search backend and of tiles plans without the census, and
            the task weights of the distributed backend's packing (see
            :mod:`repro_torch.core.balance`).
        strategy: how the distributed backend packs the canonical dyads
            into one task row per rank (``balance.PACKING``:
            ``"greedy_sequential"``, ``"sorted_snake"``,
            ``"greedy_lpt"``).
        max_attempts: dispatch budget per chunk (>= 1; 1 disables
            retry); on the bucket-wide schedule a chunk is a whole degree
            bucket, so a retry re-runs the bucket.  A chunk's
            contribution is folded only when its attempt succeeds, so
            recovered runs are bit-identical.
        backend_fallback: enable the ``tiles -> search`` rung of the
            degradation ladder: an injected tiles compile failure, or a
            run whose chunks exhaust their retries on injected faults
            only (:class:`~repro_torch.engine.faults.FaultPlan`),
            demotes the plan to ``"search"`` (recorded in
            ``Plan.degradation`` and
            ``stats["faults"]["backend_fallbacks"]``).  **Off by default
            in the port** (on in the JAX package): on the card a demotion
            is a path that runs without the CUDA kernel, so a failing
            kernel re-raises unless the caller asks for the rung.  A
            real launch failure, a kernel build or load error and an
            asynchronous device fault are never caught by any rung.
        schedule_fallback: enable the ``dynamic -> static`` rung: a
            dynamic pool whose devices are all lost or quarantined re-runs
            the task list in order on the primary device.
        reorder: locality relabeling before dispatch — ``"none"``,
            ``"degree"``, ``"bfs"`` or ``"rcm"`` (see
            :mod:`repro_torch.core.reorder`); memoized per (plan, graph),
            results bit-identical to ``"none"``, deltas stay in original
            ids.  Kept for parity: on an H100 every strategy made the
            Slashdot census kernel 35-49 % slower (``PERF.md``), so the
            default stays ``"none"``.
        fault_plan: a :class:`~repro_torch.engine.faults.FaultPlan`
            injected into this plan (``None`` = the
            ``REPRO_TORCH_FAULT_PLAN`` environment plan, if any; an inert
            ``FaultPlan()`` opts out).
        partitions: number of contiguous vertex-range graph shards
            (``None``/``1`` = the unpartitioned CSR).  With ``partitions >
            1`` the CSR is split into ranges balanced by owned canonical
            dyads, each run as a shard pass over a local CSR (its rows and
            a halo of the remote rows its dyads read), every shard pass
            through the plan's own chunk unit — on tiles the CUDA census
            kernel — with bins equal to the unpartitioned ones and one
            device→host copy per run (see
            :mod:`repro_torch.engine.partition`).  Every op must keep the
            ``delta_local`` contract.
        spill: out-of-core staging of partitioned runs: ``None``/``False``
            keeps each shard's dyad list in host memory, ``True`` stages
            it through memory-mapped files in a fresh temporary
            directory, a string names the directory to make it in; the
            files are removed after the run.  With an mmap graph
            (:func:`repro_torch.core.graph.from_edges_mmap`) the host
            holds one shard's staging at a time
            (``stats["partition"]["max_stage_bytes"]`` against
            ``stream_bytes``).
        partition_mode: shard residency for ``partitions > 1`` (``None``
            resolves it; rejected without partitions).  ``"pool"`` (the
            default) stages every shard once onto its home pool slot and
            keeps it resident for the run, halo rows copied from their
            owner shard's resident arrays on the device, and drives all
            shards' tasks through the executor pool at once; ``"serial"``
            (the default under ``spill``) holds one shard on the plan's
            device at a time — the out-of-core mode.  ``"mesh"`` (the
            default on the distributed backend, and only there) deals the
            shards over the mesh's ranks, rank ``r`` running shards ``r,
            r + W, ...`` each over its local CSR; ``"serial"`` on that
            backend splits every shard's dyads across the ranks.
            ``"pool"`` is refused there: the mesh owns the devices.
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
    schedule: str = "static"
    n_executor_devices: Optional[int] = None
    weight_model: str = "canonical_uniform"
    strategy: str = "sorted_snake"
    max_attempts: int = 3
    backend_fallback: bool = False
    schedule_fallback: bool = True
    reorder: str = "none"
    fault_plan: Optional[FaultPlan] = None
    partitions: Optional[int] = None
    spill: "Optional[bool | str]" = None
    partition_mode: Optional[str] = None

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
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, "
                             f"got {self.schedule!r}")
        if self.n_executor_devices is not None and self.n_executor_devices < 1:
            raise ValueError(
                f"n_executor_devices must be >= 1 (got "
                f"{self.n_executor_devices}); use None for the default pool")
        if self.weight_model not in WEIGHTS:
            raise ValueError(f"weight_model must be one of {WEIGHTS}, got "
                             f"{self.weight_model!r}")
        if self.strategy not in PACKING:
            raise ValueError(f"strategy must be one of {PACKING}, got "
                             f"{self.strategy!r}")
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1 (got {self.max_attempts}); it "
                "is the total dispatch budget per chunk — 1 disables retry")
        for flag in ("backend_fallback", "schedule_fallback"):
            if not isinstance(getattr(self, flag), bool):
                raise ValueError(
                    f"{flag} must be a bool (got "
                    f"{getattr(self, flag)!r}); it toggles one rung of "
                    "the degradation ladder")
        if self.reorder not in REORDERS:
            raise ValueError(
                f"reorder must be one of {REORDERS}, got {self.reorder!r}; "
                "'none' disables relabeling, 'degree' packs hubs first, "
                "'bfs' uses Gorder-style frontier order, 'rcm' is reverse "
                "Cuthill-McKee")
        if self.fault_plan is not None and not isinstance(self.fault_plan,
                                                          FaultPlan):
            raise ValueError(
                f"fault_plan must be a FaultPlan or None, got "
                f"{type(self.fault_plan).__name__}")
        if self.partitions is not None and (
                not isinstance(self.partitions, int)
                or isinstance(self.partitions, bool)
                or self.partitions < 1):
            raise ValueError(
                f"partitions must be an int >= 1 or None (got "
                f"{self.partitions!r}); it is the number of contiguous "
                "vertex-range graph shards — None/1 is the unpartitioned "
                "single-device CSR")
        if self.spill is not None and not isinstance(self.spill, (bool, str)):
            raise ValueError(
                f"spill must be None, a bool, or a scratch-directory path "
                f"(got {type(self.spill).__name__}); True stages shard "
                "dyad lists through memory-mapped temp files, a string "
                "names the scratch directory")
        if self.partition_mode is not None:
            if self.partition_mode not in PARTITION_MODES:
                raise ValueError(
                    f"partition_mode must be one of {PARTITION_MODES} or "
                    f"None, got {self.partition_mode!r}; 'pool' makes every "
                    "shard resident on its executor-pool slot at once "
                    "(halo rows copied on the device), 'serial' runs one "
                    "shard context at a time on the plan's device (the "
                    "out-of-core mode), 'mesh' deals the shards over the "
                    "distributed backend's ranks")
            if self.partitions is None or self.partitions == 1:
                raise ValueError(
                    f"partition_mode={self.partition_mode!r} requires "
                    "partitions > 1 — an unpartitioned run has no shards "
                    "to place; set partitions or drop partition_mode")

    def resolve_backend(self) -> str:
        """Pin ``"auto"`` to a concrete backend: the tiles path."""
        return "tiles" if self.backend == "auto" else self.backend

    def resolve_device(self) -> torch.device:
        """The plan's device under the port's device rule."""
        return resolve_device(self.device)

    def resolve_executor_devices(self) -> int:
        """Executor pool width: 1 under the static schedule and on the
        distributed backend (its mesh owns the devices); else
        ``n_executor_devices`` clamped to the CUDA device count (``None`` =
        all of them), or on the CPU that many slots (``None`` = 1)."""
        if (self.schedule != "dynamic"
                or self.resolve_backend() == "distributed"):
            return 1
        if self.resolve_device().type == "cuda":
            count = torch.cuda.device_count()
            n = (self.n_executor_devices if self.n_executor_devices
                 is not None else count)
            return max(1, min(n, count))
        return self.n_executor_devices or 1

    def resolve_partitions(self) -> int:
        """Graph shard count; ``None`` means unpartitioned (1)."""
        return 1 if self.partitions is None else int(self.partitions)

    def resolve_spill(self) -> "Optional[bool | str]":
        """Spill policy with the inert ``False`` normalized to ``None``, so
        off by default and off by request share one plan."""
        return None if self.spill is False else self.spill

    def resolve_partition_mode(self) -> Optional[str]:
        """Shard residency: ``None`` unpartitioned, the explicit mode when
        set, ``"serial"`` under ``spill`` (out-of-core staging promises
        ONE resident shard), else ``"mesh"`` on the distributed backend
        (its mesh owns the devices) and ``"pool"`` elsewhere.
        ``compile()`` normalizes the config through this, so ``None`` and
        the mode it resolves to share one plan-cache entry."""
        if self.resolve_partitions() == 1:
            return None
        if self.partition_mode is not None:
            return self.partition_mode
        if self.resolve_spill():
            return "serial"
        return "mesh" if self.resolve_backend() == "distributed" else "pool"

    def resolve_chunk(self) -> int:
        """Streaming chunk size, rounded up to a whole number of batches."""
        c = self.chunk_dyads if self.chunk_dyads is not None else 8192
        return max(self.batch, -(-c // self.batch) * self.batch)

    def resolve_block(self) -> int:
        """Tile-kernel block: ``block``, else ``min(batch, 32)``."""
        return self.block if self.block is not None else min(self.batch, 32)


#: Census-era name for :class:`EngineConfig` — the same class.
CensusConfig = EngineConfig
