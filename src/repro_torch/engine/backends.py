"""Backend drivers of the census engine: ``"tiles"`` and ``"search"``.

Counterpart of the ``"pallas"`` and ``"xla"`` device-resident paths of
:mod:`repro.engine.backends`.  Both drivers keep the whole run on the
plan's device: dyads are enumerated (and, for tiles, bucket-sorted) on
the device, each chunk adds its partial counts into one int64 accumulator
in place, and :func:`~repro_torch.engine.executor._acc_fetch` is the one
device→host copy of the run.  The chunk schedules are derived on the host
from the degree arrays the graph already holds, so no control value is
ever read back from the card.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..core.census import (canonical_dyads, enumerate_dyads_device,
                           host_bucket_schedule, sort_dyads_by_bucket)
from ..core.graph import CSRGraph, GraphArrays
from ..kernels.ops import TILE_NAMES, gather_tiles_device
from ..kernels.triad_census import SENTINEL, census_csr
from .executor import ChunkTask, _acc_fetch


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


# ----------------------------------------------------------------------------
# search: the binary-search batch program as torch ops
# ----------------------------------------------------------------------------


def make_search_chunk_fn(layout):
    """Chunk unit ``(arrays, n, du, dv, task, acc; chunk)`` of the search
    backend: the fused batch program over dyads ``[task.start, task.end)``
    of the device dyad list, added into ``acc`` in place."""
    fused = layout.batch_kernel()

    def search_chunk(arrays, n, du, dv, task, acc, *, chunk: int):
        u = du[task.start: task.start + chunk]
        v = dv[task.start: task.start + chunk]
        valid = torch.arange(chunk, device=u.device) < task.end - task.start
        acc += fused(arrays, n, u, v, valid, task.key)

    return search_chunk


def _dyad_tasks(plan, g: CSRGraph) -> "list[ChunkTask]":
    """Fixed-size chunks over the canonical dyad stream; each task's key is
    its ragged candidate count, ``sum(deg(u) + deg(v))`` over its dyads."""
    chunk = plan.chunk

    def build():
        u, v = canonical_dyads(g)
        deg = g.host.nbr_deg.astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(deg[u] + deg[v])])
        spans = [(s, min(s + chunk, g.n_dyads))
                 for s in range(0, g.n_dyads, chunk)]
        return [ChunkTask(s, e, float(e - s), int(cum[e] - cum[s]))
                for s, e in spans]

    return _memo_tasks(plan, g, ("search", chunk), build)


def run_search(plan, g: CSRGraph) -> np.ndarray:
    """Full pass on the search backend; returns the raw int64 bins."""
    if g.n_dyads == 0:
        return np.zeros(plan.layout.total_bins, dtype=np.int64)
    acc = torch.zeros(plan.layout.total_bins, dtype=torch.int64,
                      device=plan.device)
    arrays = plan.padded_arrays(g)
    du, dv = enumerate_dyads_device(arrays.nbr_ptr, arrays.nbr_idx, g.m_nbr,
                                    out_size=plan.dyad_pad)
    plan.executor.run(
        _dyad_tasks(plan, g),
        lambda t: plan._fn(arrays, g.n, du, dv, t, acc, chunk=plan.chunk))
    return _acc_fetch(plan, acc)


# ----------------------------------------------------------------------------
# tiles: degree-bucketed dyads through the CUDA census kernel, which reads
# the CSR rows directly (the six-tile gather is off this path)
# ----------------------------------------------------------------------------


def chunk_dyads(su, sv, task, chunk: int):
    """``chunk`` dyads of the bucket-sorted stream from ``task.start``;
    lanes at or past ``task.end`` become SENTINEL padding.  Returns
    ``(u, v, valid)``; ``valid`` is None for a full chunk, whose dyads
    are views of the stream."""
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
    """Chunk unit ``(arrays, n, su, sv, task, acc; chunk, block)`` of the
    tiles backend: run the CSR census kernel on the task's dyads
    (:func:`chunk_dyads`), its warp or CTA mapping chosen by the bucket
    width ``task.key``, and add its (chunk / block, 16) partials into
    ``acc``."""
    if layout.keys != ["triad_census"]:
        raise ValueError(f"the tiles backend runs the triad census kernel "
                         f"only; got kernels {layout.keys} (use "
                         f"backend='search')")

    def tiles_chunk(arrays, n, su, sv, task, acc, *, chunk: int,
                    block: int):
        u, v, _ = chunk_dyads(su, sv, task, chunk)
        acc += census_csr(u, v, n, arrays, k=task.key, block=block).sum(
            0, dtype=torch.int64)

    return tiles_chunk


def _tiles_bucket_tasks(plan, g: CSRGraph, ks: tuple,
                        chunk: int) -> "list[ChunkTask]":
    """Per-bucket fixed-size chunks over the bucket-sorted dyad stream;
    each task's key is its bucket's width ``K``, which bounds every row
    of its dyads."""

    def build():
        counts, _ = host_bucket_schedule(g, ks, with_needs=False)
        tasks: list = []
        offset = 0
        for K, c in zip(ks, counts.tolist()):
            tasks += [ChunkTask(s, offset + c,
                                float(K * min(chunk, offset + c - s)), K)
                      for s in range(offset, offset + c, chunk)]
            offset += c
        return tasks

    return _memo_tasks(plan, g, ("tiles", ks, chunk), build)


class TilesStream(NamedTuple):
    """Everything a tiles run dispatches over: the padded device arrays
    (with the arc flags and range counts), the bucket-sorted dyad stream,
    the task list, and the chunk and block sizes."""

    arrays: GraphArrays
    su: torch.Tensor
    sv: torch.Tensor
    tasks: list
    chunk: int
    block: int


def tiles_stream(plan, g: CSRGraph) -> TilesStream:
    """Build the tiles backend's device stream for ``g`` (graph has
    dyads).  Bucket widths are the configured buckets capped at the plan's
    width ``k``, which is always the top bucket."""
    block = plan.config.resolve_block()
    chunk = max(block, (plan.chunk // block) * block)
    kmax = max(plan.meta.k, 1)
    ks = tuple(sorted({min(max(int(k), 1), kmax)
                       for k in plan.config.buckets} | {kmax}))
    arrays = plan.padded_arrays(g, with_flags=True)
    du, dv = enumerate_dyads_device(arrays.nbr_ptr, arrays.nbr_idx, g.m_nbr,
                                    out_size=plan.dyad_pad)
    su, sv, _ = sort_dyads_by_bucket(arrays.nbr_deg, arrays.out_ptr, du, dv,
                                     g.n_dyads, ks=ks)
    return TilesStream(arrays, su, sv,
                       _tiles_bucket_tasks(plan, g, ks, chunk), chunk, block)


def run_tiles(plan, g: CSRGraph) -> np.ndarray:
    """Full pass on the tiles backend; returns the raw int64 bins."""
    if g.n_dyads == 0:
        return np.zeros(plan.layout.total_bins, dtype=np.int64)
    st = tiles_stream(plan, g)
    acc = torch.zeros(plan.layout.total_bins, dtype=torch.int64,
                      device=plan.device)
    plan.executor.run(
        st.tasks, lambda t: plan._fn(st.arrays, g.n, st.su, st.sv, t, acc,
                                     chunk=st.chunk, block=st.block))
    return _acc_fetch(plan, acc)


#: backend name -> full-pass driver.
RUNNERS = {"tiles": run_tiles, "search": run_search}
