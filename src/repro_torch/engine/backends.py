"""The backends of the census engine: ``"tiles"``, ``"search"`` and
``"distributed"``.

Counterpart of the ``"pallas"``, ``"xla"`` and ``"distributed"``
device-resident paths of :mod:`repro.engine.backends` and of the subset
passes of :mod:`repro.engine.delta`.  Every pass keeps its work on the
plan's device: dyads are enumerated (and, for the census on tiles,
bucket-sorted) on the device, each chunk unit returns its
``(total_bins,)`` int64 contribution, the plan's
:class:`~repro_torch.engine.executor.Executor` adds it into an
accumulator, and :func:`~repro_torch.engine.executor._acc_fetch` is the
one device→host copy of a run, a batch or a delta correction.  The once
contributions (vertex-space ops) are folded into the accumulator once
per graph pass, before its chunks.  The chunk schedules are derived on
the host from the degree arrays the graph already holds, so no control
value is ever read back from the card: fixed-size chunks under the
static schedule, equal-cost chunks (:mod:`repro_torch.core.balance`)
under the dynamic one, and one task per degree bucket on the
bucket-wide schedule (:func:`bucket_wide`: a census on tiles with no
other per-dyad kernel, static, one pool slot, no ``chunk_dyads``).

A *pass* adds one graph's bins into an accumulator row: the full passes
(:func:`search_pass`, :func:`tiles_pass`) walk every dyad, the subset
pass (:func:`subset_pass`, either backend) a given dyad list.  The
subset pass takes an ``arrays=`` override, the hook of the partitioned
engine (:mod:`repro_torch.engine.partition`): a shard pass is a subset
pass over the shard's dyads and its local CSR, whose once contributions
are the caller's to fold (they are whole-graph functions).

The distributed backend runs each pass as this rank's share of it, SPMD
over the plan's mesh (:mod:`repro_torch.core.distributed`): a full pass
takes the rank's row of :func:`~repro_torch.core.balance.pack_tasks`
(memoized per graph), a subset pass the rank's round-robin share of the
dyad list, both through the tiles chunk unit — ``census_csr`` — on the
rank's device; the once contributions are folded on rank 0 only; and the
one copy of a run, batch or delta is preceded by the merge, one int64
all-reduce per mesh dimension: the plan's SPMD schedule
(:func:`~repro_torch.core.distributed.make_census_fn_for_mesh`,
through :func:`_collect`).
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..core import balance, spans
from ..core.census import (canonical_dyads, dyad_buckets,
                           enumerate_dyads_device, host_bucket_schedule,
                           sort_dyads_by_bucket)
from ..core.distributed import deal, mesh_rank, mesh_size
from ..core.graph import CSRGraph, GraphArrays
from ..kernels.ops import TILE_NAMES, gather_tiles_device
from ..kernels.triad_census import SENTINEL, census_csr
from .executor import ChunkTask, _acc_fetch

CENSUS = "triad_census"


class TaskStats(NamedTuple):
    """The per-rank load summary a distributed run keeps on the plan
    (``plan.last_task_stats``): the modeled work of each rank's task row,
    not the task arrays (plans live in the cache)."""

    weights: np.ndarray  # (W,) modeled per-rank work
    strategy: str
    weight_model: str
    shape: tuple  # (W, L) of the packed task arrays

    @property
    def imbalance(self) -> float:
        """max/mean modeled work — 1.0 is perfect."""
        mean = self.weights.mean()
        return float(self.weights.max() / mean) if mean > 0 else 1.0


def _memo_tasks(plan, g: CSRGraph, key, build) -> "list[ChunkTask]":
    """Per-plan memo of a host-derived chunk schedule, keyed on the graph's
    identity (with a weakref check, so a recycled id never serves a stale
    schedule) and bounded to the last 8 graphs."""
    full_key = (key, id(g))
    hit = plan._task_memo.get(full_key)
    if hit is not None and hit[0]() is g:
        return hit[1]
    tasks = build()
    while len(plan._task_memo) >= 8:
        plan._task_memo.pop(next(iter(plan._task_memo)))
    plan._task_memo[full_key] = (weakref.ref(g), tasks)
    return tasks


def _placer(arrays: GraphArrays, *tensors):
    """The executor's ``place(device)`` for a pass: the graph arrays and
    dyad tensors on the worker's device (``Tensor.to`` copies nothing on
    the device they already hold, so a one-slot or CPU pool copies
    nothing)."""
    def place(dev):
        return (GraphArrays(*(None if a is None else a.to(dev)
                              for a in arrays)),
                *(t.to(dev) for t in tensors))

    return place


def _span_tasks(plan, g: CSRGraph, D: int, chunk: int,
                dyads=None) -> "list[ChunkTask]":
    """Chunk spans over a list of ``D`` dyads: fixed-size under the static
    schedule, equal predicted work under the dynamic one (the
    ``config.weight_model`` cost of each dyad of ``dyads``, ``g``'s
    canonical dyads when None — derived on the host only then,
    :func:`~repro_torch.core.balance.chunk_bounds_by_cost`); no key."""
    if plan.config.schedule == "dynamic" and D:
        u, v = canonical_dyads(g) if dyads is None else dyads
        w = balance.dyad_weights(g, u, v, plan.config.weight_model)
        bounds = balance.chunk_bounds_by_cost(w, chunk)
        cum = np.concatenate([[0.0], np.cumsum(w, dtype=np.float64)])
        return [ChunkTask(int(a), int(b), float(cum[b] - cum[a]))
                for a, b in zip(bounds[:-1], bounds[1:])]
    return [ChunkTask(s, min(s + chunk, D), float(min(s + chunk, D) - s))
            for s in range(0, D, chunk)]


def folds_once(plan) -> bool:
    """Whether this process folds the plan's once contributions: a plan
    with once kernels does, on a distributed plan rank 0 only, since the
    merge sums every rank's accumulator."""
    return plan._once is not None and mesh_rank(plan.mesh) == 0


def _fold_once(plan, acc: torch.Tensor, arrays: GraphArrays, n: int) -> None:
    """Add the plan's once contributions for one graph into ``acc`` (when
    :func:`folds_once`)."""
    if folds_once(plan):
        acc += plan._once(arrays, n)


def _upload_dyads(plan, u: np.ndarray, v: np.ndarray):
    """A host dyad list on the plan's device, as int32 (a read-only list,
    such as a spilled shard's memmap, is copied first)."""
    return tuple(torch.from_numpy(np.require(x, np.int32, ("C", "W")))
                 .to(plan.device) for x in (u, v))


# ----------------------------------------------------------------------------
# search: the binary-search batch program as torch ops
# ----------------------------------------------------------------------------


def make_search_chunk_fn(layout):
    """Chunk unit ``(arrays, n, du, dv, task) -> (total_bins,)`` of the
    search backend: the fused batch program over dyads ``[task.start,
    task.end)`` of the device dyad list."""
    fused = layout.batch_kernel()

    def search_chunk(arrays, n, du, dv, task):
        u, v = du[task.start: task.end], dv[task.start: task.end]
        valid = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
        return fused(arrays, n, u, v, valid, task.key)

    return search_chunk


def _search_tasks(plan, g: CSRGraph, u: np.ndarray, v: np.ndarray,
                  chunk: int) -> "list[ChunkTask]":
    """The schedule's spans over the dyad list ``(u, v)``
    (:func:`_span_tasks`); each task's key is its ragged candidate count,
    ``sum(deg(u) + deg(v))`` over its dyads."""
    deg = g.host.nbr_deg.astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(deg[u] + deg[v])])
    return [t._replace(key=int(cum[t.end] - cum[t.start]))
            for t in _span_tasks(plan, g, len(u), chunk, (u, v))]


def _run_full(plan, g: CSRGraph, arrays, du, dv, tasks, acc) -> None:
    """Fold ``g``'s once contributions, then run ``tasks`` over the dyad
    stream ``(du, dv)``, into ``acc``."""
    _fold_once(plan, acc, arrays, g.n)
    plan.executor.run(tasks, place=_placer(arrays, du, dv),
                      step=make_step(plan, g.n), init=acc)


def search_pass(plan, g: CSRGraph, acc: torch.Tensor) -> None:
    """Add ``g``'s full search-backend bins into ``acc`` (graph has dyads)."""
    with spans.span(spans.STREAM):
        arrays = plan.padded_arrays(g)
        du, dv = enumerate_dyads_device(arrays.nbr_ptr, arrays.nbr_idx,
                                        g.m_nbr, out_size=plan.dyad_pad)
        tasks = _memo_tasks(plan, g, ("search", plan.chunk),
                            lambda: _search_tasks(plan, g, *canonical_dyads(g),
                                                  plan.chunk))
    _run_full(plan, g, arrays, du, dv, tasks, acc)


# ----------------------------------------------------------------------------
# tiles: the triad census through the CUDA CSR census kernel on
# degree-bucketed dyads, every other op's batch kernel on the same chunk
# ----------------------------------------------------------------------------


def task_lanes(task, chunk, block: int) -> int:
    """The lanes of ``task``'s launch: the plan's fixed ``chunk``, or on
    the bucket-wide schedule (``chunk`` None) the task's own length
    rounded up to a whole ``block``."""
    if chunk is not None:
        return chunk
    return -(-(task.end - task.start) // block) * block


def chunk_dyads(su, sv, task, chunk: int):
    """``chunk`` dyads of the stream from ``task.start``; lanes at or past
    ``task.end`` become SENTINEL padding.  Returns ``(u, v, valid)``;
    ``valid`` is None for a full chunk, whose dyads are views of the
    stream."""
    stop = task.start + chunk
    if stop <= task.end:
        return su[task.start: stop], sv[task.start: stop], None
    pos = torch.arange(task.start, stop, device=su.device)
    valid = pos < task.end
    pos.clamp_(max=su.shape[0] - 1)
    u, v = su[pos], sv[pos]
    return (torch.where(valid, u, SENTINEL), torch.where(valid, v, SENTINEL),
            valid)


def chunk_tile_inputs(arrays, su, sv, task, chunk: int):
    """The six-tile kernel's inputs for one tiles task: the task's dyads
    (:func:`chunk_dyads`) and their six (chunk, K) tiles, ``K =
    task.key``; ``arrays`` must carry the transpose CSR.  Returns ``(u, v,
    tiles)`` in :func:`census_tiles` argument order.  Not on the main
    path: the parity seam with the Pallas kernel's interface."""
    u, v, valid = chunk_dyads(su, sv, task, chunk)
    if valid is None:
        valid = torch.ones(chunk, dtype=torch.bool, device=u.device)
    tiles = gather_tiles_device(arrays, u, v, valid, K=task.key)
    return u, v, [tiles[k] for k in TILE_NAMES]


def make_tiles_chunk_fn(layout):
    """Chunk unit ``(arrays, n, su, sv, task; chunk, block) ->
    (total_bins,)`` of the tiles backend, over the task's
    :func:`task_lanes` lanes of dyads (:func:`chunk_dyads`):

    * the CSR census kernel, its warp or CTA mapping chosen by the bucket
      width ``task.key``, gives (lanes / block, 16) partials, summed into
      the ``triad_census`` slice;
    * every other kernel (``layout.batch_kernel(skip=("triad_census",))``)
      runs on the same dyads, padded lanes remapped to the inert ``(0,
      1)`` dyad and masked by ``valid``, with ``n_cand=None``.

    The whole contribution is built before it is returned, so the
    executor folds it with one add: a launch that fails after the other
    kernels ran leaves the accumulator untouched, and its retry counts
    every op once."""
    census_sl = layout.slices.get(CENSUS)
    census_only = census_sl == slice(0, layout.total_bins)
    rest = (layout.batch_kernel(skip=(CENSUS,))
            if layout.has_batch(skip=(CENSUS,)) else None)

    def fold_census(partials, part):
        census = partials.sum(0, dtype=torch.int64)
        if census_only:
            return census
        part[census_sl] += census
        return part

    def tiles_chunk(arrays, n, su, sv, task, *, chunk, block: int):
        lanes = task_lanes(task, chunk, block)
        u, v, valid = chunk_dyads(su, sv, task, lanes)
        part = None
        if rest is not None:
            if valid is None:
                ru, rv = u, v
                rvalid = torch.ones(lanes, dtype=torch.bool, device=u.device)
            else:
                ru, rv, rvalid = (torch.where(valid, u, 0),
                                  torch.where(valid, v, 1), valid)
            part = rest(arrays, n, ru, rv, rvalid, None)
        elif not census_only:
            part = torch.zeros(layout.total_bins, dtype=torch.int64,
                               device=u.device)
        if census_sl is None:
            return part
        partials = census_csr(u, v, n, arrays, k=task.key, block=block)
        if not spans.enabled():
            return fold_census(partials, part)
        with spans.recording(spans.REDUCE):
            return fold_census(partials, part)

    return tiles_chunk


def bucket_wide(plan) -> bool:
    """Whether the plan's tiles passes take the bucket-wide schedule, one
    ``census_csr`` launch per non-empty degree bucket: the plan runs the
    census and no other per-dyad kernel, on the static schedule over a
    one-slot pool, and no ``chunk_dyads`` was given.  Every other plan
    keeps its fixed-size or equal-need chunks: the dynamic schedule
    balances chunks over a pool, and another per-dyad kernel builds
    tensors of the chunk's size."""
    cfg = plan.config
    return (needs_flags(plan) and cfg.chunk_dyads is None
            and cfg.schedule == "static" and plan.executor.n_devices == 1
            and not plan.layout.has_batch(skip=(CENSUS,)))


def tiles_geometry(plan) -> "tuple[int, int | None, tuple]":
    """``(block, chunk, ks)`` of the plan's tiles passes: the chunk is a
    whole number of blocks, or None on the bucket-wide schedule
    (:func:`bucket_wide`), and the bucket widths are the configured
    buckets capped at the plan's width ``k``, which is always the top
    bucket."""
    block = plan.config.resolve_block()
    chunk = (None if bucket_wide(plan)
             else max(block, (plan.chunk // block) * block))
    kmax = max(plan.meta.k, 1)
    ks = tuple(sorted({min(max(int(k), 1), kmax)
                       for k in plan.config.buckets} | {kmax}))
    return block, chunk, ks


def _bucket_tasks(ks: tuple, counts, chunk, need_sorted=None, *,
                  block: int = 1) -> "list[ChunkTask]":
    """Per-bucket chunks over a bucket-sorted dyad stream whose buckets
    hold ``counts`` dyads; each task's key is its bucket's width ``K``,
    which bounds every row of its dyads.  Fixed-size chunks, or, given the
    stream's per-dyad needs in stream order (the dynamic schedule),
    equal-need chunks against one stream-wide quota, so the wide buckets
    get proportionally shorter chunks.  With ``chunk`` None, one task per
    non-empty bucket (:func:`_bucket_spans`)."""
    if chunk is None:
        return _bucket_spans(ks, counts, block)
    if need_sorted is not None:
        cum = np.concatenate([[0.0], np.cumsum(need_sorted,
                                               dtype=np.float64)])
        target = cum[-1] / max(1, -(-len(need_sorted) // chunk))
    tasks: list = []
    offset = 0
    for K, c in zip(ks, (int(c) for c in counts)):
        if need_sorted is not None and c:
            bounds = offset + balance.chunk_bounds_by_cost(
                need_sorted[offset: offset + c], chunk, target=target)
            tasks += [ChunkTask(int(a), int(b), float(cum[b] - cum[a]), K)
                      for a, b in zip(bounds[:-1], bounds[1:])]
        else:
            tasks += [ChunkTask(s, offset + c,
                                float(K * min(chunk, offset + c - s)), K)
                      for s in range(offset, offset + c, chunk)]
        offset += c
    return tasks


def _bucket_spans(ks: tuple, counts, block: int) -> "list[ChunkTask]":
    """The bucket-wide schedule: one task per non-empty bucket of a
    bucket-sorted stream whose buckets hold ``counts`` dyads.  Each edge
    between two tasks is floored to a whole ``block``, so every task but
    the last is a whole number of blocks, a view of the stream, and only
    the last pads (fewer than ``block`` lanes).  The dyads a floored edge
    moves into the next task come from a narrower bucket, so that task's
    width ``K`` still bounds their rows; a bucket of fewer than ``block``
    dyads can go wholly to the next task."""
    live = [(K, int(c)) for K, c in zip(ks, counts) if c]
    tasks: list = []
    start = offset = 0
    for i, (K, c) in enumerate(live):
        offset += c
        end = offset if i == len(live) - 1 else offset // block * block
        if end > start:
            tasks.append(ChunkTask(start, end, float(K * (end - start)), K))
            start = end
    return tasks


class TilesStream(NamedTuple):
    """Everything a tiles pass dispatches over: the padded device arrays
    (with the arc flags and range counts when the plan runs the census),
    the dyad stream (bucket-sorted for the census), the task list, and
    the chunk (None on the bucket-wide schedule) and block sizes."""

    arrays: GraphArrays
    su: torch.Tensor
    sv: torch.Tensor
    tasks: list
    chunk: "int | None"
    block: int


def tiles_stream(plan, g: CSRGraph) -> TilesStream:
    """Build the tiles backend's device stream for ``g`` (graph has
    dyads).  A plan without the census builds no arc flags and sorts
    nothing: it streams the enumerated dyads in the schedule's spans."""
    with spans.span(spans.STREAM):
        return _tiles_stream(plan, g)


def _tiles_stream(plan, g: CSRGraph) -> TilesStream:
    block, chunk, ks = tiles_geometry(plan)
    census = CENSUS in plan.layout.slices
    arrays = plan.padded_arrays(g, with_flags=census)
    du, dv = enumerate_dyads_device(arrays.nbr_ptr, arrays.nbr_idx, g.m_nbr,
                                    out_size=plan.dyad_pad)
    if not census:
        tasks = _memo_tasks(plan, g, ("tiles-flat", chunk), lambda: [
            t._replace(key=ks[-1])
            for t in _span_tasks(plan, g, g.n_dyads, chunk)])
        return TilesStream(arrays, du, dv, tasks, chunk, block)
    su, sv, _ = sort_dyads_by_bucket(arrays.nbr_deg, arrays.out_ptr, du, dv,
                                     g.n_dyads, ks=ks)
    dynamic = plan.config.schedule == "dynamic"

    def build():
        counts, need = host_bucket_schedule(g, ks, with_needs=dynamic)
        return _bucket_tasks(ks, counts, chunk, need, block=block)

    tasks = _memo_tasks(plan, g, ("tiles", ks, chunk), build)
    return TilesStream(arrays, su, sv, tasks, chunk, block)


def tiles_pass(plan, g: CSRGraph, acc: torch.Tensor) -> None:
    """Add ``g``'s full tiles-backend bins into ``acc`` (graph has dyads)."""
    st = tiles_stream(plan, g)
    _run_full(plan, g, st.arrays, st.su, st.sv, st.tasks, acc)


def needs_flags(plan) -> bool:
    """Whether the plan's passes read the arc flags and range counts: the
    census on tiles (and on the distributed backend, whose ranks run the
    tiles chunk unit)."""
    return (plan.backend in ("tiles", "distributed")
            and CENSUS in plan.layout.slices)


def subset_schedule(plan, g: CSRGraph, u: np.ndarray, v: np.ndarray):
    """The host half of a subset pass over ``g``'s dyads ``(u, v)``:
    ``(u, v, tasks)`` with the dyads in dispatch order.  Tiles with the
    census sorts them by (bucket, need) from ``g``'s degrees (global
    degrees: a shard keeps its dyads' rows in full) and keys each task
    with its bucket's width; search keys each span with its candidate
    count."""
    if plan.backend == "search":
        return u, v, _search_tasks(plan, g, u, v, plan.chunk)
    block, chunk, ks = tiles_geometry(plan)
    if CENSUS not in plan.layout.slices:
        return u, v, [t._replace(key=ks[-1])
                      for t in _span_tasks(plan, g, len(u), chunk, (u, v))]
    need, b = dyad_buckets(g, u, v, ks)
    order = np.lexsort((need, b))
    return u[order], v[order], _bucket_tasks(
        ks, np.bincount(b, minlength=len(ks))[: len(ks)], chunk,
        need[order] if plan.config.schedule == "dynamic" else None,
        block=block)


def make_step(plan, n: int):
    """The executor's ``step(ctx, task)`` of the plan's backend over a
    ``(arrays, su, sv)`` context of a graph of ``n`` vertices.  Every pass
    builds its own, once; a pass on the bucket-wide schedule is counted
    in ``plan.stats["bucket_passes"]``."""
    if plan.backend == "search":
        return lambda ctx, t: plan._fn(ctx[0], n, ctx[1], ctx[2], t)
    block, chunk, _ = tiles_geometry(plan)
    if chunk is None:
        plan.stats["bucket_passes"] += 1
    return lambda ctx, t: plan._fn(ctx[0], n, ctx[1], ctx[2], t,
                                   chunk=chunk, block=block)


def subset_pass(plan, g: CSRGraph, u: np.ndarray, v: np.ndarray,
                acc: torch.Tensor, *, arrays=None) -> None:
    """Add the bins of ``g``'s dyads ``(u, v)`` (and ``g``'s once
    contributions, unless ``arrays`` overrides the padded graph arrays)
    into ``acc``, in :func:`subset_schedule`'s order: on tiles with the
    census sorted on the host by (bucket, need), as the full pass sorts
    on the device, so every task's ``K`` is its bucket's width; the
    sorted list is uploaded once."""
    fold = arrays is None
    with spans.span(spans.STREAM):
        if fold:
            arrays = plan.padded_arrays(g, with_flags=needs_flags(plan))
        if len(u):
            u, v, tasks = subset_schedule(plan, g, u, v)
            du, dv = _upload_dyads(plan, u, v)
    if fold:
        _fold_once(plan, acc, arrays, g.n)
    if len(u):
        _dispatch(plan, g, arrays, du, dv, tasks, acc)


def _dispatch(plan, g: CSRGraph, arrays, du, dv, tasks, acc) -> None:
    """Run ``tasks`` over the uploaded dispatch-ordered dyads ``(du, dv)``
    and ``arrays`` into ``acc``."""
    plan.executor.run(tasks, place=_placer(arrays, du, dv),
                      step=make_step(plan, g.n), init=acc)


# ----------------------------------------------------------------------------
# distributed: this rank's share of each pass, merged over the mesh
# ----------------------------------------------------------------------------


def rank_share(plan, g: CSRGraph):
    """This rank's share of ``g``'s full distributed pass: ``(u, v, tasks,
    task_stats)``, the rank's row of ``balance.pack_tasks(g, W, ...)``
    without its padding slots, in :func:`subset_schedule`'s dispatch
    order.  Every rank packs the same way (the packing is deterministic),
    so the rows partition the dyads without a word exchanged.  Memoized
    per graph like the chunk schedules (:func:`_memo_tasks`)."""
    W, r = mesh_size(plan.mesh), mesh_rank(plan.mesh)
    cfg = plan.config

    def build():
        packed = balance.pack_tasks(g, W, weight_model=cfg.weight_model,
                                    strategy=cfg.strategy,
                                    pad_multiple=cfg.batch)
        keep = packed.valid[r]
        u, v, tasks = subset_schedule(plan, g, packed.u[r][keep],
                                      packed.v[r][keep])
        return u, v, tasks, TaskStats(packed.weights, packed.strategy,
                                      packed.weight_model, packed.u.shape)

    return _memo_tasks(plan, g, ("distributed", W, r, cfg.strategy), build)


def distributed_pass(plan, g: CSRGraph, acc: torch.Tensor) -> None:
    """Add this rank's share of ``g``'s full pass (:func:`rank_share`, and
    on rank 0 the once contributions) into ``acc``; records the packing's
    load summary in ``plan.last_task_stats``."""
    with spans.span(spans.STREAM):
        u, v, tasks, stats = rank_share(plan, g)
        arrays = plan.padded_arrays(g, with_flags=needs_flags(plan))
        if tasks:
            du, dv = _upload_dyads(plan, u, v)
    plan.last_task_stats = stats
    _fold_once(plan, acc, arrays, g.n)
    if tasks:
        _dispatch(plan, g, arrays, du, dv, tasks, acc)


def distributed_subset_pass(plan, g: CSRGraph, u: np.ndarray, v: np.ndarray,
                            acc: torch.Tensor, *, arrays=None) -> None:
    """This rank's share of a subset pass: the dyads dealt round-robin,
    rank ``r`` taking ``r::W`` (:func:`~repro_torch.core.distributed.deal`),
    run like :func:`subset_pass`; the once contributions (unless
    ``arrays`` overrides the graph's arrays) on rank 0 only."""
    subset_pass(plan, g, deal(plan.mesh, np.asarray(u)),
                deal(plan.mesh, np.asarray(v)), acc, arrays=arrays)


def run_rank_row(plan, g: CSRGraph, arrays: GraphArrays, u: np.ndarray,
                 v: np.ndarray) -> np.ndarray:
    """A given task row ``(u, v)`` of this rank over ``arrays``, the
    tensors of a graph shaped like ``g``, as a subset pass, merged over
    the plan's mesh; no once contributions.  The run of the legacy
    :func:`~repro_torch.core.distributed.make_distributed_census_fn`."""
    arrays = plan.padded_arrays(g, arrays=arrays,
                                with_flags=needs_flags(plan))
    return _collect(plan, lambda acc: subset_pass(plan, g, u, v, acc,
                                                  arrays=arrays))


# ----------------------------------------------------------------------------
# drivers: one run, a batch, a delta correction — one counted copy each
# ----------------------------------------------------------------------------

#: backend name -> full pass (on the distributed backend, this rank's
#: share of it)
PASSES = {"tiles": tiles_pass, "search": search_pass,
          "distributed": distributed_pass}


def _zeros(plan, *shape) -> torch.Tensor:
    return torch.zeros(*shape, plan.layout.total_bins, dtype=torch.int64,
                       device=plan.device)


def _collect(plan, fill, *shape) -> np.ndarray:
    """``fill(acc)`` into a fresh ``(*shape, total_bins)`` accumulator,
    then the one counted copy of its bins.  On the distributed backend
    this is the plan's SPMD schedule (``plan.census_for_mesh``,
    :func:`~repro_torch.core.distributed.make_census_fn_for_mesh`):
    ``fill`` adds this rank's share and the merge over the plan's mesh
    (one all-reduce per mesh dimension) comes before the copy; a failure
    of any rank's ``fill`` raises on every rank."""
    if plan.census_for_mesh is not None:
        return plan.census_for_mesh(fill, *shape)
    acc = _zeros(plan, *shape)
    fill(acc)
    return _acc_fetch(plan, acc)


def run_full(plan, g: CSRGraph) -> np.ndarray:
    """Full pass of ``g``; returns the raw int64 bins.  An arc-free graph
    runs nothing and returns zeros (the ops' finalize covers it)."""
    if g.n_dyads == 0:
        return np.zeros(plan.layout.total_bins, dtype=np.int64)
    return _collect(plan, lambda acc: PASSES[plan.backend](plan, g, acc))


def run_batch(plan, graphs) -> np.ndarray:
    """Full passes of B graphs into one ``(B, total_bins)`` accumulator,
    each member's chunks into its own row, and one copy (on the
    distributed backend one merge) for the batch.  Returns the ``(B,
    total_bins)`` raw int64 bins."""
    def fill(acc):
        for row, g in zip(acc, graphs):
            if g.n_dyads:
                PASSES[plan.backend](plan, g, row)

    return _collect(plan, fill, len(graphs))


def run_subsets(plan, g_old: CSRGraph, old, g_new: CSRGraph,
                new) -> np.ndarray:
    """Exact ``raw(g_new) - raw(g_old)`` over the dyad lists ``old`` of
    ``g_old`` and ``new`` of ``g_new``: two subset passes (partitioned
    ones on a partitioned plan, this rank's share on a distributed one)
    into two rows of one accumulator, their difference taken on the
    device in int64 (it may be negative), one copy (one merge)."""
    if plan.partitions > 1:
        from .partition import subset_partitioned as subset
    elif plan.backend == "distributed":
        subset = distributed_subset_pass
    else:
        subset = subset_pass

    def fill(acc):
        both = _zeros(plan, 2)
        for row, g, (u, v) in ((both[0], g_old, old), (both[1], g_new, new)):
            if g.n_dyads:
                subset(plan, g, u, v, row)
        acc += both[1] - both[0]

    return _collect(plan, fill)
