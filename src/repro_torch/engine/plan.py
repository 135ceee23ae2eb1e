"""Compiled census plans and the plan cache.

Counterpart of :mod:`repro.engine.plan`.  ``compile(graph_meta, ops,
config) -> Plan``: a :class:`Plan` owns what runs reuse — the
padded-shape buckets, the chunk geometry, the fused chunk unit of its
backend, its :class:`~repro_torch.engine.executor.Executor` (schedule and
device pool), and bounded per-graph memos of host-derived chunk
schedules, of locality permutations and of partition layouts — and
runs any number of ops in one pass with one device→host copy
(``stats["host_syncs"]``): :meth:`Plan.run` for one graph,
:meth:`Plan.run_batch` for B same-bucket graphs, and
:meth:`Plan.apply_delta` to advance a graph's bins by one mutation.
Plans are cached in a bounded LRU keyed on bucketized graph metadata, the
ops and the config, so same-shape graphs share one plan.

**Degradation ladder.**  ``backend`` is the rung a plan runs on,
``requested_backend`` what it was compiled for, and ``degradation`` the
record of every demotion (empty on a healthy plan).  With
``EngineConfig(backend_fallback=True)`` a tiles plan whose chunk unit
fails to build, or whose run ends in a chunk that exhausted its retries
(or a dynamic pool exhausted past its own static rung), demotes to
``"search"`` for good, each demotion counted in
``stats["faults"]["backend_fallbacks"]``.  The port's default is
``False``: on the card that rung is a path without the CUDA kernel, so
by default a failing kernel re-raises.  Even when enabled, both rungs
take only failures that the plan's ``FaultPlan`` injected
(:func:`~repro_torch.engine.executor.injected_only`): a real launch
failure of ``census_csr``, a kernel build or load error
(:class:`~repro_torch.kernels._build.KernelBuildError`) and an
asynchronous device fault always re-raise.  The ``dynamic -> static``
rung lives in the executor.

**Reordering.**  Under ``config.reorder`` each graph is relabeled once
per plan (memoized beside the task memo, counted in
``stats["reorders"]``), the backend runs on the relabeled graph, and the
raw bins map back through ``OpLayout.unpermute``: raw bins are always in
original vertex ids.

**Partitions.**  With ``config.partitions > 1`` a run is the partitioned
pass of :mod:`repro_torch.engine.partition` (pool, serial or mesh shard
residency), inside the same ladder and after the relabeling, so the cuts
fall on the relabeled ids.  Such a plan refuses an op whose
``delta_local`` is ``False``, and its ``run_batch`` runs member by member.

**Distributed plans.**  ``compile(..., mesh=)`` on the ``"distributed"``
backend binds the plan to a ``torch.distributed`` device mesh (part of
the cache key): every run, batch and delta is this rank's share, merged
over the mesh before its one copy (:mod:`repro_torch.core.distributed`),
so every rank must make the same calls in the same order.  Without a
mesh the plan takes a 1-D mesh over the world when the default process
group is initialized, else a one-rank mesh on the plan's device.  The
ladder has no rung for this backend: a failure raises on every rank.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Optional

import numpy as np
import torch

from ..core import spans
from ..core.census import CensusResult
from ..core.distributed import default_mesh, make_census_fn_for_mesh
from ..core.graph import CSRGraph, GraphArrays, next_pow2, tensor_arrays
from ..core.reorder import compute_permutation, permute_graph
from ..kernels.ops import (MAX_PACKED_DEGREE, build_arc_flags_device,
                           build_in_csr_device)
from . import backends
from .config import EngineConfig
from .delta import run_delta
from .executor import (ChunkRetryError, Executor, PoolExhaustedError,
                       injected_only, pool_devices)
from .faults import InjectedFault, check_poisoned, resolve_faults
from .ops import OpLayout, resolve_ops

__all__ = ["CensusPlan", "GraphMeta", "Plan", "PlanShapeError", "compile",
           "compile_census", "clear_plan_cache", "plan_cache_stats",
           "set_plan_cache_capacity"]


class PlanShapeError(ValueError):
    """A graph exceeds the plan's metadata buckets — recompile at the
    graph's own shape."""


@dataclasses.dataclass(frozen=True)
class GraphMeta:
    """Static, bucketized graph shape — the graph half of the plan-cache
    key.  Fields are rounded up to powers of two so graphs of similar
    shape share one plan."""

    n_bucket: int       # vertices, rounded up
    k: int              # candidate tile width (>= max undirected degree)
    member_iters: int   # binary-search trips covering any CSR row
    m_out_bucket: int   # directed-arc array length, rounded up
    m_nbr_bucket: int   # undirected-adjacency array length, rounded up

    @classmethod
    def from_graph(cls, g: CSRGraph, k: Optional[int] = None) -> "GraphMeta":
        k_bucket = next_pow2(max(g.max_deg, 1))
        k_eff = int(k) if k else k_bucket
        # membership searches run over real rows: cover the true max degree
        depth = max(k_eff, k_bucket)
        return cls(n_bucket=next_pow2(max(g.n, 1)), k=k_eff,
                   member_iters=max(1, math.ceil(math.log2(depth + 1))) + 1,
                   m_out_bucket=next_pow2(max(g.m, 1)),
                   m_nbr_bucket=next_pow2(max(g.m_nbr, 1)))


def _pad_to(t: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


class Plan:
    """A compiled, reusable census plan for one shape bucket, op set,
    config and device.  Create via :func:`compile`; run with :meth:`run`
    (``{op_name: result}``) or :meth:`run_raw` (raw int64 bins)."""

    def __init__(self, meta: GraphMeta, ops, config: EngineConfig,
                 backend: str, device: torch.device, mesh=None):
        self.meta = meta
        self.ops = tuple(ops)
        self.op_names = tuple(op.name for op in self.ops)
        self.config = config
        self.backend = backend
        self.device = device
        if backend == "distributed" and mesh is None:
            raise ValueError("the distributed backend needs a mesh "
                             "(compile() supplies the default one)")
        self.mesh = mesh
        self.layout = OpLayout(self.ops, meta, config)
        # streaming chunk, capped by the dyad-count bucket so small graphs
        # do not pad up to a full default chunk (a pass on the bucket-wide
        # schedule launches per bucket instead: backends.bucket_wide)
        batch = config.batch
        d_bucket = max(1, meta.m_nbr_bucket // 2)
        self.chunk = min(config.resolve_chunk(), -(-d_bucket // batch) * batch)
        # device dyad list length: whole chunks covering the dyad bucket
        self.dyad_pad = max(self.chunk,
                            -(-d_bucket // self.chunk) * self.chunk)
        self.stats = {"runs": 0, "chunks": 0, "bucket_passes": 0,
                      "host_syncs": 0, "batch_runs": 0, "batch_graphs": 0,
                      "device_chunks": {},
                      "delta_runs": 0, "delta_fulls": 0, "reorders": 0,
                      "faults": dict(chunk_failures=0, retries=0,
                                     device_losses=0, quarantines=0,
                                     backend_fallbacks=0,
                                     schedule_fallbacks=0),
                      "fault_events": []}
        # the distributed backend's SPMD schedule: this rank's share into a
        # private accumulator, one merge over the mesh, one copy
        self.census_for_mesh = (None if mesh is None else
                                make_census_fn_for_mesh(
                                    mesh, n_bins=self.layout.total_bins,
                                    device=device, stats=self.stats))
        self.requested_backend = backend
        self.degradation: list = []
        self.partitions = config.resolve_partitions()
        self.partition_mode = config.resolve_partition_mode()
        if self.partitions > 1:
            nonlocal_ops = [op.name for op in self.ops if not op.delta_local]
            if nonlocal_ops:
                raise ValueError(
                    f"partitions={self.partitions} requires every op to "
                    f"honor the delta_local locality contract, but "
                    f"{nonlocal_ops} opt out — their kernels may read "
                    "rows outside a shard's halo; run them unpartitioned "
                    "(partitions=1)")
            if self.partition_mode == "mesh" and backend != "distributed":
                raise ValueError(
                    f"partition_mode='mesh' requires the distributed "
                    f"backend (got backend={backend!r}): the mesh mode "
                    "deals the shards over the ranks of a device mesh — "
                    "use partition_mode='pool' or 'serial' on this backend")
            if self.partition_mode == "pool" and backend == "distributed":
                raise ValueError(
                    "partition_mode='pool' is not available on the "
                    "distributed backend: its mesh owns the devices (the "
                    "executor pool is pinned to one slot) — use "
                    "partition_mode='mesh' (the default there) or 'serial'")
        self.executor = Executor(
            config, self.stats,
            pool_devices(device, config.resolve_executor_devices()),
            backend=backend)
        self._task_memo: dict = {}
        self._reorder_memo: dict = {}
        self._partition_memo: dict = {}
        # distributed: the packing's load summary of the latest run
        # (backends.TaskStats; never the task arrays)
        self.last_task_stats = None
        self._once = self.layout.once_kernel()
        fplan = resolve_faults(config.fault_plan)
        try:
            if fplan is not None and fplan.compile_fails(backend):
                raise InjectedFault(f"injected {backend} compile failure")
            self._fn = self._build_fn(backend)
        except InjectedFault as e:
            # the chunk units are torch closures, so the compile rung
            # sees only the injected failure; a distributed plan has no
            # rung (its ranks would leave the SPMD schedule apart)
            if backend != "tiles" or not config.backend_fallback:
                raise
            self._demote("search", stage="compile", reason=repr(e))

    def _build_fn(self, backend: str):
        """``backend``'s chunk unit (the ladder re-enters this); a
        distributed rank runs the tiles unit."""
        make = {"tiles": backends.make_tiles_chunk_fn,
                "distributed": backends.make_tiles_chunk_fn,
                "search": backends.make_search_chunk_fn}[backend]
        return make(self.layout)

    def _demote(self, to: str, *, stage: str, reason: str) -> None:
        """One rung of the degradation ladder: re-point the plan at backend
        ``to`` for good, and record the demotion in ``degradation``,
        ``stats["faults"]`` and the event trace.  Both backends compute
        the same integer bins, so demoted results stay bit-identical."""
        frm = self.backend
        self.backend = self.executor.backend = to
        self._fn = self._build_fn(to)
        self.executor._note("backend_fallback", frm, to, stage,
                            backend_fallbacks=1)
        self.degradation.append(dict(rung=f"{frm}->{to}", stage=stage,
                                     reason=reason))

    def _laddered(self, run, *args):
        """``run(self, *args)`` under the runtime rung: a tiles run that
        ended in chunk-dispatch failures, every one of them injected by
        the plan's ``FaultPlan``, demotes the plan to ``"search"`` (when
        enabled) and runs again there.  A real failure of the kernel's
        launch re-raises on any device."""
        try:
            return run(self, *args)
        except (ChunkRetryError, PoolExhaustedError) as e:
            if (self.backend != "tiles" or not self.config.backend_fallback
                    or not injected_only(e)):
                raise
            self._demote("search", stage="runtime", reason=repr(e))
            return run(self, *args)

    def _check(self, g: CSRGraph) -> None:
        m = self.meta
        if g.max_deg > m.k:
            raise PlanShapeError(
                f"graph max_deg={g.max_deg} exceeds plan tile width "
                f"k={m.k}; recompile via repro_torch.engine.compile")
        if (g.n > m.n_bucket or g.m > m.m_out_bucket
                or g.m_nbr > m.m_nbr_bucket):
            raise PlanShapeError(
                f"graph (n={g.n}, m={g.m}, m_nbr={g.m_nbr}) exceeds plan "
                f"buckets {m}; recompile via repro_torch.engine.compile")

    def padded_arrays(self, g: CSRGraph, *, arrays=None,
                      with_in_csr: bool = False,
                      with_flags: bool = False) -> GraphArrays:
        """The graph's tensors on the plan's device, padded to the metadata
        buckets.  Padded ptr rows repeat the last offset (empty rows) and
        padded idx/deg entries are inert.  ``with_flags`` also builds the
        arc flags and range counts on the device (what the tiles backend's
        CSR census kernel reads; the counts are packed while the graph's
        max degree allows, else wide); ``with_in_csr`` the transpose CSR (the
        six-tile gather's in-arc rows).  ``arrays`` pads the tensors of
        a graph shaped like ``g`` in place of ``g``'s own."""
        m = self.meta
        return self.pad_arrays(
            g.arrays if arrays is None else arrays, g.m, g.m_nbr, m.m_out_bucket, m.m_nbr_bucket,
            wide=g.max_deg > MAX_PACKED_DEGREE, with_in_csr=with_in_csr,
            with_flags=with_flags)

    def pad_arrays(self, a: GraphArrays, m_out: int, m_nbr: int,
                   out_len: int, nbr_len: int, *, wide: bool,
                   with_in_csr: bool = False,
                   with_flags: bool = False) -> GraphArrays:
        """Five CSR arrays (tensors, or host numpy such as a shard's local
        CSR) on the plan's device: ptr arrays padded to ``n_bucket + 1``
        repeating their last offsets ``m_out`` / ``m_nbr``, idx arrays to
        ``out_len`` / ``nbr_len``, deg to ``n_bucket``; the flags and
        transpose CSR as in :meth:`padded_arrays`, the range counts wide
        when ``wide`` (which comes from the whole graph's max degree)."""
        nb = self.meta.n_bucket
        t = tensor_arrays(a, self.device)
        arrays = GraphArrays(
            out_ptr=_pad_to(t.out_ptr, nb + 1, m_out),
            out_idx=_pad_to(t.out_idx, out_len, 0),
            nbr_ptr=_pad_to(t.nbr_ptr, nb + 1, m_nbr),
            nbr_idx=_pad_to(t.nbr_idx, nbr_len, 0),
            nbr_deg=_pad_to(t.nbr_deg, nb, 0))
        if with_in_csr:
            in_ptr, in_idx = build_in_csr_device(arrays.out_ptr,
                                                 arrays.out_idx)
            arrays = arrays._replace(in_ptr=in_ptr, in_idx=in_idx)
        if with_flags:
            flags, counts = build_arc_flags_device(
                arrays.out_ptr, arrays.out_idx, arrays.nbr_ptr,
                arrays.nbr_idx, wide=wide)
            arrays = arrays._replace(nbr_flag=flags, nbr_cnt=counts)
        return arrays

    # -- locality-aware reordering -------------------------------------------

    def _seed_reorder(self, g: CSRGraph, g_exec: CSRGraph,
                      perm: np.ndarray) -> None:
        """Record ``g -> (g_exec, perm)`` in the reorder memo: keyed by
        graph identity with a weakref guard, bounded to 8 graphs.  The
        delta path seeds the mutated graph, so a mutation stream reuses
        one permutation."""
        memo = self._reorder_memo
        while len(memo) >= 8:
            memo.pop(next(iter(memo)))
        memo[id(g)] = (weakref.ref(g), g_exec, perm)

    def _reordered(self, g: CSRGraph):
        """``(execution graph, perm)`` under ``config.reorder``: ``(g,
        None)`` for ``"none"``, else the permutation (``perm[old] = new``)
        and the relabeled graph, computed on the host once per (plan,
        graph) and counted in ``stats["reorders"]``."""
        if self.config.reorder == "none":
            return g, None
        hit = self._reorder_memo.get(id(g))
        if hit is not None and hit[0]() is g:
            return hit[1], hit[2]
        perm = compute_permutation(g, self.config.reorder)
        g_exec = permute_graph(g, perm)
        self.stats["reorders"] += 1
        self._seed_reorder(g, g_exec, perm)
        return g_exec, perm

    def _execute_raw(self, g: CSRGraph) -> np.ndarray:
        """Relabel (memoized), run the backend — partitioned when the plan
        has partitions — under the ladder, and map the raw bins back to
        original vertex ids."""
        g_exec, perm = self._reordered(g)
        if self.partitions > 1:
            from .partition import run_partitioned as run
        else:
            run = backends.run_full
        raw = self._laddered(run, g_exec)
        return raw if perm is None else self.layout.unpermute(raw, perm, g)

    # -- execution -----------------------------------------------------------

    def run(self, g: CSRGraph) -> dict:
        """Run every op in one pass; returns ``{op_name: result}``."""
        return self.layout.finalize(self.run_raw(g), g)

    def run_raw(self, g: CSRGraph):
        """Run the pass and return the raw int64 accumulator bins (no
        finalize), in original vertex ids; one device→host copy.  This is
        the state a delta stream carries between mutations
        (:meth:`apply_delta`)."""
        with spans.span(spans.RUN):
            check_poisoned(g)
            self._check(g)
            self.stats["runs"] += 1
            return self._execute_raw(g)

    def run_batch(self, graphs) -> "list[dict]":
        """Run the fused pass on B same-bucket graphs as one batch.

        Every graph must pass this plan's admission check (the
        :class:`GraphMeta` grouping a
        :class:`repro_torch.serve.CensusService` performs); a poisoned
        member fails the batch as a unit.  Each member's chunks add into
        its own row of one ``(B, total_bins)`` accumulator, and the batch
        costs **one** device→host copy.  Results equal B sequential
        :meth:`run` calls; returns one ``{op_name: result}`` per graph, in
        input order.  Under ``config.reorder`` each member runs relabeled
        (memoized) and its bins map back before finalize.  A partitioned
        plan runs the members one by one (one copy each), each through
        its own shard passes."""
        graphs = list(graphs)
        if not graphs:
            return []
        with spans.span(spans.RUN):
            return self._run_batch(graphs)

    def _run_batch(self, graphs) -> "list[dict]":
        for g in graphs:
            check_poisoned(g)
            self._check(g)
        self.stats["runs"] += len(graphs)
        self.stats["batch_runs"] += 1
        self.stats["batch_graphs"] += len(graphs)
        if self.partitions > 1:
            return [self.layout.finalize(self._execute_raw(g), g)
                    for g in graphs]
        pairs = [self._reordered(g) for g in graphs]
        raws = self._laddered(backends.run_batch, [ge for ge, _ in pairs])
        return [self.layout.finalize(
                    raw if perm is None
                    else self.layout.unpermute(raw, perm, g), g)
                for raw, (_, perm), g in zip(raws, pairs, graphs)]

    def apply_delta(self, g: CSRGraph, delta, raw=None):
        """Advance a graph's bins by one mutation batch, with work
        proportional to the mutation's footprint.

        ``g`` is the current graph, ``raw`` its raw bins (from
        :meth:`run_raw` or the previous application's ``.raw``) and
        ``delta`` a :class:`~repro_torch.core.delta.GraphDelta`.  Returns
        a :class:`~repro_torch.engine.delta.DeltaResult` whose ``graph``
        and ``raw`` seed the next application and whose ``results`` equal
        ``plan.run(result.graph)``: the plan's own chunk units re-run on
        the affected dyads of both graphs and the exact integer
        difference is folded in, for one device→host copy.  Recomputes in
        full (``mode == "full"``) when ``raw`` is None, the affected
        fraction exceeds ``config.delta_threshold``, or an op sets
        ``delta_local=False``.  Raises :class:`PlanShapeError` if the
        mutated graph outgrows the plan's buckets."""
        with spans.span(spans.RUN):
            self._check(g)
            self.stats["runs"] += 1
            return run_delta(self, g, delta, raw)

    def census_view(self) -> "CensusPlan":
        """The census-only view of this plan."""
        if "triad_census" not in self.op_names:
            raise ValueError(f"plan ops {self.op_names} do not include "
                             "'triad_census'")
        return CensusPlan(self)


class CensusPlan:
    """Triad-census view of a :class:`Plan`: every attribute delegates to
    the plan, and :meth:`run` returns a bare
    :class:`~repro_torch.core.census.CensusResult`."""

    def __init__(self, plan: Plan):
        self._plan = plan

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def run(self, g: CSRGraph) -> CensusResult:
        """Run the census; int64 counts of all 16 triad types."""
        return self._plan.run(g)["triad_census"]

    def run_batch(self, graphs) -> "list[CensusResult]":
        """The census of B same-bucket graphs as one batch (see
        :meth:`Plan.run_batch`); one result per graph, in input order."""
        return [r["triad_census"] for r in self._plan.run_batch(graphs)]


_PLAN_CACHE: collections.OrderedDict = collections.OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_CACHE_CAPACITY = 32


def set_plan_cache_capacity(capacity: int) -> None:
    """Bound the plan cache to ``capacity`` entries (LRU eviction)."""
    global _CACHE_CAPACITY
    if capacity < 1:
        raise ValueError("plan cache capacity must be >= 1")
    _CACHE_CAPACITY = capacity
    _evict_to_capacity()


def _evict_to_capacity() -> None:
    while len(_PLAN_CACHE) > _CACHE_CAPACITY:
        _PLAN_CACHE.popitem(last=False)
        _CACHE_STATS["evictions"] += 1


def compile(graph_meta, ops=("triad_census",),
            config: Optional[EngineConfig] = None, *, mesh=None) -> Plan:
    """Build (or fetch from cache) the plan for this graph shape + ops.

    ``graph_meta`` is a :class:`CSRGraph` or a :class:`GraphMeta`.  The
    config's backend, device, pool width and partition fields are resolved
    first (``"auto"`` → ``"tiles"``, ``None`` → ``"cuda"``, which raises
    without CUDA; ``partition_mode=None`` → the mode it resolves to), so
    equivalent configs share one cache entry.  ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh``) binds a distributed
    plan to its ranks and is part of the key; ``None`` there is the
    default mesh (:func:`~repro_torch.core.distributed.default_mesh`),
    and other backends ignore it.
    """
    config = config or EngineConfig()
    op_objs = resolve_ops(ops)
    meta = (graph_meta if isinstance(graph_meta, GraphMeta)
            else GraphMeta.from_graph(graph_meta, k=config.k))
    backend = config.resolve_backend()
    device = config.resolve_device()
    config = dataclasses.replace(
        config, backend=backend, device=str(device),
        n_executor_devices=config.resolve_executor_devices(),
        partitions=config.resolve_partitions(),
        spill=config.resolve_spill(),
        partition_mode=config.resolve_partition_mode())
    if backend != "distributed":
        mesh = None
    elif mesh is None:
        mesh = default_mesh(device)
    key = (meta, op_objs, config, mesh)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _CACHE_STATS["hits"] += 1
        _PLAN_CACHE.move_to_end(key)
        return plan
    _CACHE_STATS["misses"] += 1
    plan = Plan(meta, op_objs, config, backend, device, mesh)
    _PLAN_CACHE[key] = plan
    _evict_to_capacity()
    return plan


def compile_census(graph_meta, config: Optional[EngineConfig] = None, *,
                   mesh=None) -> CensusPlan:
    """Census-only front door: the census view of
    ``compile(graph_meta, ("triad_census",), config, mesh=mesh)`` (same
    cache)."""
    return compile(graph_meta, ("triad_census",), config,
                   mesh=mesh).census_view()


def clear_plan_cache() -> None:
    """Drop every cached plan, each plan's task, reorder and partition
    memos, and reset the hit/miss/eviction counters."""
    for p in _PLAN_CACHE.values():
        p._task_memo.clear()
        p._reorder_memo.clear()
        p._partition_memo.clear()
    _PLAN_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0, evictions=0)


def plan_cache_stats() -> dict:
    """Cache counters plus one entry per cached plan (LRU order): its
    bucketized ``meta``, ``backend`` (the rung it runs on) with
    ``requested_backend`` and ``degradation`` (the ladder's record,
    normally empty), ``device``, ``ops``, ``chunk``, the executor policy
    (``schedule``, ``n_devices``), ``reorder``, live ``task_memo`` and
    ``reorder_memo`` entries, and the execution counters (``runs``,
    ``chunks``, ``bucket_passes``: the passes that took the bucket-wide
    schedule, one task per degree bucket (``backends.bucket_wide``),
    ``host_syncs``, ``batch_runs`` / ``batch_graphs``,
    ``delta_runs`` / ``delta_fulls``, ``reorders``, ``device_chunks``:
    chunks per pool slot, ``faults`` / ``fault_events``: the recovery
    counters and bounded trace), the partition policy (``partitions``, 1
    unpartitioned; ``partition_mode``, None unpartitioned;
    ``partition_memo``, the live layout-memo entries) and, after a
    partitioned run, ``partition``: that run's layout and staging record
    (see :func:`repro_torch.engine.partition.run_partitioned`); ``mesh``,
    the shape of a distributed plan's mesh (None on other backends)."""
    entries = [dict(meta=dataclasses.asdict(p.meta), backend=p.backend,
                    requested_backend=p.requested_backend,
                    degradation=[dict(d) for d in p.degradation],
                    device=str(p.device), ops=p.op_names, chunk=p.chunk,
                    schedule=p.config.schedule,
                    n_devices=p.executor.n_devices,
                    task_memo=len(p._task_memo), reorder=p.config.reorder,
                    reorder_memo=len(p._reorder_memo),
                    partitions=p.partitions,
                    partition_mode=p.partition_mode,
                    partition_memo=len(p._partition_memo),
                    mesh=(None if p.mesh is None
                          else tuple(int(x) for x in p.mesh.shape)),
                    **{**p.stats,
                       "device_chunks": dict(p.stats["device_chunks"]),
                       "faults": dict(p.stats["faults"]),
                       "fault_events": list(p.stats["fault_events"]),
                       **({"partition": dict(p.stats["partition"])}
                          if "partition" in p.stats else {})})
               for p in _PLAN_CACHE.values()]
    return {**_CACHE_STATS, "size": len(_PLAN_CACHE),
            "capacity": _CACHE_CAPACITY, "entries": entries}
