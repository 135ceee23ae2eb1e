"""One front door for graph analytics: config -> plan -> results.

    from repro_torch.engine import EngineConfig, compile

    plan = compile(graph, ["triad_census", "dyad_census", "degree_stats"],
                   EngineConfig(backend="tiles"))
    results = plan.run(graph)        # {op_name: result}, one fused pass

Analytics are pluggable :class:`~repro_torch.engine.ops.GraphOp`
instances (``triad_census``, ``dyad_census``, ``degree_stats`` and
``triadic_profile`` ship built in; :func:`register_op` adds more), and
any number of them run in one fused pass: one traversal of the dyad
stream, one int64 accumulator with a slice per kernel, one device→host
copy.  ``Plan.run_batch`` runs B same-bucket graphs with one copy for the
batch (:class:`repro_torch.serve.CensusService` builds fleet serving on
it), and ``Plan.apply_delta`` advances a graph's bins by one
:class:`GraphDelta` with work proportional to its footprint.

Backends (counterparts of the JAX engine's):

    "tiles"   — the triad census through the CUDA CSR census kernel on
                degree-bucketed dyads, every other op's torch program on
                the same chunks (JAX: "pallas")
    "search"  — the binary-search batch program as torch ops (JAX: "xla")
    "distributed" — SPMD over a torch.distributed device mesh: each rank
                runs its static task row (core/balance.pack_tasks) through
                the tiles chunk unit, then one int64 all-reduce per mesh
                dimension and one copy (``compile(..., mesh=)``; JAX:
                "distributed")
    "auto"    — "tiles"

Execution policy (``EngineConfig``): ``schedule="static"|"dynamic"``
over the executor's device pool (``n_executor_devices``; CPU slots on
``"cpu"``), bounded chunk retry (``max_attempts``) with quarantine and a
``dynamic -> static`` rung, an opt-in ``tiles -> search`` rung
(``backend_fallback``, off by default), seeded fault injection
(``FaultPlan``, or the ``REPRO_TORCH_FAULT_PLAN`` environment variable),
and locality relabeling (``reorder="degree"|"bfs"|"rcm"``) with results
bit-identical to ``"none"``.

Partitioned graphs and out-of-core runs (:mod:`repro_torch.core.
partition`, :mod:`repro_torch.engine.partition`):
``EngineConfig(partitions=P)`` splits the CSR into P contiguous
vertex-range shards balanced by owned canonical dyads, each a local CSR
with a halo of the remote rows its dyads read, and runs every shard pass
through the plan's own chunk unit (on tiles, the CUDA census kernel),
all shards resident at once (``partition_mode="pool"``), one at a time
(``"serial"``), or dealt over a distributed plan's ranks (``"mesh"``);
bins equal the unpartitioned ones, one copy per run.
``spill=True`` stages shard dyad lists through memory-mapped files, and
:func:`repro_torch.core.graph.from_edges_mmap` keeps the graph itself in
memory-mapped files.

Plans run on ``EngineConfig.device`` (``None`` = ``"cuda"``; raises
without CUDA, never falls back to the CPU).  ``CensusConfig`` /
``compile_census`` / :class:`CensusPlan` are the census-era names of the
same entry points.
"""
from ..core.census import CensusResult
from ..core.delta import GraphDelta, affected_dyads, apply_delta_csr
from .config import BACKENDS, REORDERS, SCHEDULES, CensusConfig, EngineConfig
from .delta import DeltaResult, delta_correction
from .executor import (ChunkRetryError, ChunkTask, Executor,
                       PoolExhaustedError, WorkerFailures)
from .faults import (DeviceLostError, FaultPlan, InjectedFault,
                     fault_plan_from_env, is_poisoned, poison,
                     resolve_faults, unpoison)
from .ops import (DegreeStats, DyadCensus, GraphOp, OpLayout, TriadCensusOp,
                  TriadicProfile, get_op, list_ops, register_op, resolve_ops,
                  unregister_op)
from .plan import (CensusPlan, GraphMeta, Plan, PlanShapeError,
                   clear_plan_cache, compile, compile_census,
                   plan_cache_stats, set_plan_cache_capacity)

__all__ = [
    "BACKENDS", "CensusConfig", "CensusPlan", "CensusResult",
    "ChunkRetryError", "ChunkTask", "DegreeStats", "DeltaResult",
    "DeviceLostError", "DyadCensus", "EngineConfig", "Executor", "FaultPlan",
    "GraphDelta", "GraphMeta", "GraphOp", "InjectedFault", "OpLayout",
    "Plan", "PlanShapeError", "PoolExhaustedError", "REORDERS", "SCHEDULES",
    "TriadCensusOp", "TriadicProfile", "WorkerFailures", "affected_dyads",
    "apply_delta_csr", "clear_plan_cache", "compile", "compile_census",
    "delta_correction", "fault_plan_from_env", "get_op", "is_poisoned",
    "list_ops", "plan_cache_stats", "poison", "register_op", "resolve_faults",
    "resolve_ops", "set_plan_cache_capacity", "unpoison", "unregister_op",
]
