"""One front door for the port's census: config -> plan -> results.

    from repro_torch.engine import EngineConfig, compile

    plan = compile(graph, ("triad_census",), EngineConfig(backend="tiles"))
    result = plan.run(graph)["triad_census"]

Backends (counterparts of the JAX engine's):

    "tiles"   — degree-bucketed neighbourhood tiles through the CUDA census
                tile kernel (JAX: "pallas")
    "search"  — the binary-search batch program as torch ops (JAX: "xla")
    "auto"    — "tiles"

Plans run on ``EngineConfig.device`` (``None`` = ``"cuda"``; raises
without CUDA, never falls back to the CPU) with one device→host copy per
run.  ``CensusConfig`` / ``compile_census`` / :class:`CensusPlan` are the
census-era names of the same entry points.
"""
from ..core.census import CensusResult
from .config import BACKENDS, CensusConfig, EngineConfig
from .executor import ChunkTask, Executor
from .ops import GraphOp, OpLayout, TriadCensusOp, get_op, resolve_ops
from .plan import (CensusPlan, GraphMeta, Plan, PlanShapeError,
                   clear_plan_cache, compile, compile_census,
                   plan_cache_stats, set_plan_cache_capacity)

__all__ = [
    "BACKENDS", "CensusConfig", "CensusPlan", "CensusResult", "ChunkTask",
    "EngineConfig", "Executor", "GraphMeta", "GraphOp", "OpLayout", "Plan",
    "PlanShapeError", "TriadCensusOp", "clear_plan_cache", "compile",
    "compile_census", "get_op", "plan_cache_stats", "resolve_ops",
    "set_plan_cache_capacity",
]
