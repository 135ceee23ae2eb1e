"""Partitioned (sharded-CSR) execution: pool, serial and mesh shard
residency, halo rows copied on the device, and out-of-core spill.

Counterpart of :mod:`repro.engine.partition`.  With
``EngineConfig(partitions=P)`` a census run is P shard passes, each over
a **local CSR** — the full rows of one contiguous vertex range plus its
halo of remote rows (:mod:`repro_torch.core.partition` builds the
layout) — and the shard's owned span of the canonical dyad stream.  A
shard pass is the plan's own subset pass over those dyads with the local
arrays (:func:`repro_torch.engine.backends.subset_schedule`,
:func:`~repro_torch.engine.backends.make_step`): on tiles every chunk of
every shard launches the CUDA census kernel ``census_csr`` over the
shard-local CSR.

``EngineConfig(partition_mode=...)`` picks the residency:

``"pool"`` (the default)
  Every shard's context is staged ONCE onto its home pool slot and stays
  resident for the run; all shards' tasks go through
  :meth:`~repro_torch.engine.executor.Executor.run_sharded` at once.  A
  shard's one host→device copy carries its ptr halves, its OWNED idx
  blocks and its sorted dyads; each halo block is gathered from the
  owner shard's resident rows and scattered into the requester's idx
  arrays on the device, with one ``.to`` when the owner's slot is
  another device (``d2d_puts``; 0 on one card).  The arc flags and
  range counts are then built on the home slot from the complete local
  CSR.

``"serial"`` (the default under ``spill``)
  One shard context resident at a time on the plan's device — the
  out-of-core property — each staged once
  (:meth:`~repro_torch.engine.executor.Executor.run_pinned`).  ``spill``
  stages each shard's dyad list through a memory-mapped file, so with an
  mmap graph (:func:`repro_torch.core.graph.from_edges_mmap`) the host
  holds one shard at a time.  On the distributed backend every rank
  stages every shard and runs its round-robin share (``r::W``) of each
  shard's dyads.

``"mesh"`` (the distributed backend's default, and only there)
  The shards are dealt over the mesh's ranks: rank ``r`` runs the
  ``r``-th, ``(r + W)``-th, ... non-empty shard (the JAX package's waves
  of W shards), each staged once on the rank's device from the host
  like a serial shard and run through ``census_csr`` over its local CSR.

The whole-graph once contribution is folded exactly once (on a
distributed plan by rank 0), every shard's chunks add into the run's
int64 accumulator on the plan's device (exact, for any order, homing or
re-homing), and ONE counted device→host copy ends the run, on a
distributed plan after the merge over the mesh.  Correctness rests on
the ``GraphOp.delta_local`` contract (a dyad's contribution reads only
``{u, v} ∪ N(u) ∪ N(v)``, which the halo keeps as full rows); the arc
flags of a local CSR are exact at every position of every owned and
partner row, the only ones a kernel reads.
A delta corrects through :func:`subset_partitioned`: only the shards
owning affected dyads run.

``plan.stats["partition"]`` records the layout and the staging: ``mode``,
``cuts``, ``shard_dyads``, ``halo_sizes``, ``spill``, ``h2d_puts`` (one
per non-empty shard on a fault-free run), ``d2d_puts``,
``halo_host_puts`` (halo blocks of owners with no resident context),
``max_shard_bytes`` against :func:`full_context_bytes`,
``max_stage_bytes`` against ``stream_bytes``, ``shard_times`` (on a
distributed plan only this rank's shards, ``device`` its rank) and
``shard_overlap`` (the share of busy wall time with two or more shards in
flight), ``rehomes`` after a re-home and ``delta_shards`` after a delta.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
import weakref

import numpy as np
import torch

from ..core.distributed import deal, mesh_rank
from ..core.graph import CSRGraph, GraphArrays, next_pow2
from ..core.partition import (GraphPartition, _gather_rows, _host,
                              build_local_arrays, halo_by_owner, local_ptrs,
                              owned_idx, partition_graph, shard_dyads)
from ..kernels.ops import MAX_PACKED_DEGREE, build_arc_flags_device
from .backends import (_collect, _fold_once, _placer, _upload_dyads,
                       folds_once, make_step, needs_flags, subset_pass,
                       subset_schedule)
from .executor import _on, same_device

__all__ = ["full_context_bytes", "plan_partition", "run_partitioned",
           "shard_context_bytes", "subset_partitioned"]


def plan_partition(plan, g: CSRGraph) -> GraphPartition:
    """The (plan, graph) partition layout, memoized like the reorder memo
    (graph identity with a weakref check, the last 8 graphs): warm runs
    and the steps of a mutation stream pay no partitioning.  The shard
    count is clamped to the vertex count."""
    memo = plan._partition_memo
    hit = memo.get(id(g))
    if hit is not None and hit[0]() is g:
        return hit[1]
    part = partition_graph(g, min(plan.partitions, max(g.n, 1)))
    while len(memo) >= 8:
        memo.pop(next(iter(memo)))
    memo[id(g)] = (weakref.ref(g), part)
    return part


class _Geometry:
    """Common shard geometry: every shard's idx arrays pad to the largest
    shard's (a power of two, capped at the plan's buckets), and ``pad``
    is the largest dyad span in whole chunks — the staging the byte
    accounting counts.  ``wide`` is the whole graph's range-count layout,
    never a shard's own."""

    def __init__(self, plan, g: CSRGraph, part: GraphPartition):
        self.m_out = min(plan.meta.m_out_bucket,
                         next_pow2(max((s.m_out for s in part.shards),
                                       default=1)))
        self.m_nbr = min(plan.meta.m_nbr_bucket,
                         next_pow2(max((s.m_nbr for s in part.shards),
                                       default=1)))
        d = max(1, part.max_dyads)
        self.pad = max(plan.chunk, -(-d // plan.chunk) * plan.chunk)
        self.wide = g.max_deg > MAX_PACKED_DEGREE


def _shard_arrays(plan, g: CSRGraph, shard, geom: _Geometry) -> GraphArrays:
    """One shard's padded local CSR on the plan's device, built on the
    host: ptr/deg arrays over the whole (padded) vertex range, the local
    ptr repeating its own last offset, over idx arrays compacted to the
    common geometry; vertex ids stay global.  On tiles with the census,
    the arc flags and range counts of the local CSR."""
    local = build_local_arrays(g, shard.lo, shard.hi, shard.halo)
    return plan.pad_arrays(local, int(local.out_ptr[-1]),
                           int(local.nbr_ptr[-1]), geom.m_out, geom.m_nbr,
                           wide=geom.wide, with_flags=needs_flags(plan))


def _once_into(plan, acc: torch.Tensor, g: CSRGraph) -> None:
    """Fold the whole-graph once contribution into ``acc`` (once per run,
    never per shard: once kernels read the whole graph, so a plan with
    one pays one full padded upload here, on a distributed plan on rank 0
    only)."""
    if folds_once(plan):
        _fold_once(plan, acc, plan.padded_arrays(g), g.n)


def _rank_split(plan, shard_lists):
    """This rank's part of ``shard_lists`` on a distributed plan (the
    list unchanged elsewhere): under ``"mesh"`` every W-th shard from the
    rank's own, under ``"serial"`` every shard's dyads dealt round-robin
    (``r::W``), shards left without dyads dropped; both dealt by
    :func:`~repro_torch.core.distributed.deal`."""
    if plan.partition_mode == "mesh":
        return deal(plan.mesh, shard_lists)
    split = [(shard, deal(plan.mesh, u), deal(plan.mesh, v))
             for shard, u, v in shard_lists]
    return [(shard, u, v) for shard, u, v in split if len(u)]


@contextlib.contextmanager
def _spill_scratch(spill):
    """Scratch directory for spilled dyad lists: ``None`` disables,
    ``True`` makes a fresh temporary directory, a string makes one inside
    that path.  Always removed afterwards."""
    if not spill:
        yield None
        return
    if isinstance(spill, str):
        os.makedirs(spill, exist_ok=True)
        d = tempfile.mkdtemp(prefix="repro-spill-", dir=spill)
    else:
        d = tempfile.mkdtemp(prefix="repro-spill-")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _stage_spill(u: np.ndarray, v: np.ndarray, scratch: str, tag: str):
    """Move one shard's dyad list into an ``.npy`` memmap and hand back
    lazy read-only views; the in-memory list is dropped.  No flush: the
    file is this run's scratch, read back through the page cache and
    removed after the run, so nothing needs it on the disk."""
    path = os.path.join(scratch, f"{tag}.npy")
    d = len(u)
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.int32,
                                   shape=(2, max(d, 1)))
    mm[0, :d] = u
    mm[1, :d] = v
    del mm
    ro = np.load(path, mmap_mode="r")
    return ro[0, :d], ro[1, :d]


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------

def _bytes_for(plan, m_out: int, m_nbr: int, dyad_slots: int,
               wide: bool) -> int:
    """Bytes of one resident census context: the int32 ptr and deg arrays,
    the idx arrays, on tiles with the census the int8 arc flags and the
    range counts (4 bytes an entry packed, 8 wide), the dyad stream and
    the int64 accumulator.  No transpose CSR: the CSR kernel reads none."""
    n = plan.meta.n_bucket
    b = 4 * (2 * (n + 1) + n) + 4 * (m_out + m_nbr)
    if needs_flags(plan):
        b += m_nbr * (1 + (8 if wide else 4))
    b += 2 * 4 * dyad_slots + 8 * plan.layout.total_bins
    return int(b)


def shard_context_bytes(plan, geom: _Geometry) -> int:
    """Bytes of ONE resident shard context — ``stats["partition"]
    ["max_shard_bytes"]``, the per-slot residency bound, beside
    :func:`full_context_bytes`."""
    return _bytes_for(plan, geom.m_out, geom.m_nbr, geom.pad, geom.wide)


def full_context_bytes(plan, g: CSRGraph) -> int:
    """Bytes of the UNPARTITIONED context of ``g`` under the same
    accounting (the JAX package's takes the plan alone: here the range
    counts' layout comes from ``g``'s max degree)."""
    m = plan.meta
    return _bytes_for(plan, m.m_out_bucket, m.m_nbr_bucket, plan.dyad_pad,
                      g.max_deg > MAX_PACKED_DEGREE)


def _overlap_fraction(times: dict) -> float:
    """Share of busy wall time with >= 2 shards in flight, by an interval
    sweep over the ``[start, end)`` records: 0.0 for a serial or
    one-shard run, up to ``(P-1)/P`` when P equal shards fully overlap."""
    ivs = [(t["start"], t["end"]) for t in times.values()
           if t["end"] > t["start"]]
    if not ivs:
        return 0.0
    events = sorted([(a, 1) for a, _ in ivs] + [(b, -1) for _, b in ivs])
    busy = multi = 0.0
    depth = 0
    prev = events[0][0]
    for x, d in events:
        if depth >= 1:
            busy += x - prev
        if depth >= 2:
            multi += x - prev
        depth += d
        prev = x
    return float(multi / busy) if busy > 0 else 0.0


# ---------------------------------------------------------------------------
# pool mode: every shard resident on its home slot at once
# ---------------------------------------------------------------------------

def _gather_block(ptr: torch.Tensor, idx: torch.Tensor, ids: torch.Tensor,
                  total: int) -> torch.Tensor:
    """Concatenated CSR rows of ``ids`` read from a shard's RESIDENT local
    arrays, back to back in id order — the layout of the requester's
    compacted idx span; ``total`` (their entry count, known on the host)
    fixes the output size, so nothing is read back."""
    ids = ids.long()
    starts = ptr[ids].long()
    counts = ptr[ids + 1].long() - starts
    seg = torch.repeat_interleave(
        torch.arange(ids.shape[0], device=ids.device), counts,
        output_size=total)
    first = torch.cumsum(counts, 0) - counts
    pos = starts[seg] + torch.arange(total, device=ids.device) - first[seg]
    return idx[pos]


def _stage_pool_shard(plan, g, shard, geom, u, v, dev):
    """Stage one shard on ``dev`` with ONE host→device copy: its ptr
    halves and deg (vertex-count sized), its OWNED idx blocks (rows
    ``[lo, hi)``, the contiguous span ``[ptr[lo], ptr[hi])`` of the
    compacted idx layout) and its dyads, in one int32 buffer that the
    resident tensors view.  The idx arrays start as zeros with the owned
    blocks in place; halo blocks follow in :func:`_exchange_halos`."""
    nb = plan.meta.n_bucket
    out_ptr, nbr_ptr, nbr_deg = local_ptrs(g, shard.lo, shard.hi, shard.halo)
    own_out, own_nbr = owned_idx(g, shard.lo, shard.hi)

    def pad(a, size, fill):
        out = np.full(size, fill, np.int32)
        out[: len(a)] = a
        return out

    parts = [pad(out_ptr, nb + 1, out_ptr[-1]), pad(nbr_ptr, nb + 1,
                                                    nbr_ptr[-1]),
             pad(nbr_deg, nb, 0), own_out, own_nbr,
             np.asarray(u, np.int32), np.asarray(v, np.int32)]
    bounds = np.cumsum([0] + [len(p) for p in parts])
    buf = torch.from_numpy(np.concatenate(parts)).to(dev)
    d_optr, d_nptr, d_deg, d_oblk, d_nblk, su, sv = (
        buf[a:b] for a, b in zip(bounds[:-1], bounds[1:]))
    w = dict(dev=dev, out_ptr=d_optr, nbr_ptr=d_nptr, nbr_deg=d_deg, su=su,
             sv=sv, host_out_ptr=out_ptr, host_nbr_ptr=nbr_ptr)
    for csr, blk, size in (("out", d_oblk, geom.m_out),
                           ("nbr", d_nblk, geom.m_nbr)):
        idx = torch.zeros(size, dtype=torch.int32, device=dev)
        start = int(w[f"host_{csr}_ptr"][shard.lo])
        idx[start: start + blk.shape[0]] = blk
        w[f"{csr}_idx"] = idx
    return w


def _exchange_halos(plan, g, part, work, pstats) -> None:
    """Fill every staged shard's halo blocks, one (requester, owner) group
    of ids at a time — contiguous both in the owner's range and in the
    requester's compacted layout.  The owner's resident rows are gathered
    on the owner's device and scattered into the requester's idx arrays;
    when the two slots are different devices the block takes one ``.to``
    between them (``d2d_puts``), else none.  Owners with no resident
    context (shards that own no dyads) send host rows instead
    (``halo_host_puts``)."""
    shards = {s.index: s for s in part.shards}
    for s, w in work.items():
        for owner, ids in halo_by_owner(part.cuts, shards[s].halo):
            spans = {}
            for csr in ("out", "nbr"):
                hp = w[f"host_{csr}_ptr"]
                spans[csr] = (int(hp[ids[0]]), int(hp[ids[-1] + 1]))
            ow = work.get(owner)
            if ow is not None:
                with _on(ow["dev"]):
                    d_ids = torch.from_numpy(ids.astype(np.int32)).to(
                        ow["dev"])
                    vals = [_gather_block(ow[f"{csr}_ptr"], ow[f"{csr}_idx"],
                                          d_ids, b - a)
                            for csr, (a, b) in spans.items()]
                if not same_device(ow["dev"], w["dev"]):
                    vals = [x.to(w["dev"]) for x in vals]
                    pstats["d2d_puts"] += 1
            else:
                host = []
                for csr in ("out", "nbr"):
                    ptr = _host(getattr(g.host, f"{csr}_ptr"))
                    ptr = ptr[: g.n + 1].astype(np.int64)
                    host.append(_gather_rows(
                        ptr, _host(getattr(g.host, f"{csr}_idx")),
                        ids.astype(np.int64)).astype(np.int32))
                vals = [torch.from_numpy(h).to(w["dev"]) for h in host]
                pstats["halo_host_puts"] = pstats.get("halo_host_puts",
                                                      0) + 1
            for (csr, (a, b)), x in zip(spans.items(), vals):
                w[f"{csr}_idx"][a:b] = x


def _finish_pool_context(plan, w, geom):
    """One staged shard's executor context ``(arrays, su, sv)``, with the
    arc flags and range counts built on its home slot from the now
    complete local CSR when the plan reads them."""
    arrays = GraphArrays(out_ptr=w["out_ptr"], out_idx=w["out_idx"],
                         nbr_ptr=w["nbr_ptr"], nbr_idx=w["nbr_idx"],
                         nbr_deg=w["nbr_deg"])
    if needs_flags(plan):
        with _on(w["dev"]):
            flags, counts = build_arc_flags_device(
                arrays.out_ptr, arrays.out_idx, arrays.nbr_ptr,
                arrays.nbr_idx, wide=geom.wide)
        arrays = arrays._replace(nbr_flag=flags, nbr_cnt=counts)
    return arrays, w["su"], w["sv"]


def _host_ctx(plan, g, shard, geom, u, v, dev):
    """A shard context built from the host onto ``dev`` — the re-home and
    fallback path, and the serial mode's staging.  ``u``/``v`` are in
    dispatch order."""
    return _placer(_shard_arrays(plan, g, shard, geom),
                   *_upload_dyads(plan, u, v))(dev)


def _pool_pass(plan, g, part, geom, shard_lists, acc, pstats) -> None:
    """Pool execution of ``shard_lists`` (``[(shard, u, v)]``) into
    ``acc``, shared by the full run and the pool-mode delta: stage every
    shard on its home slot (``k % width``, the homing of
    :meth:`Executor.run_sharded`, so each first placement finds it
    resident), exchange halos, then run all shards' tasks at once."""
    devs = plan.executor.devices
    prep = []
    for shard, u, v in shard_lists:
        u, v, tasks = subset_schedule(plan, g, np.asarray(u, np.int32),
                                      np.asarray(v, np.int32))
        prep.append((shard, u, v, tasks))
    work = {}
    for k, (shard, u, v, _t) in enumerate(prep):
        with _on(devs[k % len(devs)]):
            work[shard.index] = _stage_pool_shard(plan, g, shard, geom, u,
                                                  v, devs[k % len(devs)])
        pstats["h2d_puts"] += 1
    _exchange_halos(plan, g, part, work, pstats)
    ctxs = {s: (w["dev"], _finish_pool_context(plan, w, geom))
            for s, w in work.items()}
    del work
    by_id = {shard.index: (shard, u, v) for shard, u, v, _t in prep}

    def place(s, dev):
        hit = ctxs.get(s)
        if hit is not None and same_device(hit[0], dev):
            return hit[1]
        # a re-home onto another device: the context rebuilds from the
        # host there
        shard, u, v = by_id[s]
        pstats["h2d_puts"] += 1
        with _on(dev):
            ctx = _host_ctx(plan, g, shard, geom, u, v, dev)
        ctxs[s] = (dev, ctx)
        return ctx

    plan.executor.run_sharded(
        [(shard.index, tasks) for shard, _u, _v, tasks in prep],
        place=place, step=make_step(plan, g.n), init=acc, pstats=pstats)


# ---------------------------------------------------------------------------
# serial mode: one resident shard at a time (the out-of-core mode)
# ---------------------------------------------------------------------------

def _serial_pass(plan, g, part, geom, shard_lists, acc, pstats) -> None:
    """Shards in order on the plan's device, each context built and placed
    exactly ONCE (``h2d_puts``) and dropped before the next.  On a
    distributed plan, this rank's part of them (:func:`_rank_split`):
    the ``"serial"`` and ``"mesh"`` modes there."""
    times = pstats.setdefault("shard_times", {})
    t_base = time.perf_counter()
    step = make_step(plan, g.n)
    dev = plan.executor.devices[0]
    label = mesh_rank(plan.mesh)
    for shard, u, v in _rank_split(plan, shard_lists):
        u, v, tasks = subset_schedule(plan, g, np.asarray(u, np.int32),
                                      np.asarray(v, np.int32))

        def build(shard=shard, u=u, v=v):
            return _host_ctx(plan, g, shard, geom, u, v, dev)

        ctx = build()
        pstats["h2d_puts"] += 1
        start = time.perf_counter() - t_base
        plan.executor.run_pinned(tasks, ctx=ctx, step=step, init=acc,
                                 rebuild=build)
        del ctx
        times[shard.index] = dict(start=start,
                                  end=time.perf_counter() - t_base,
                                  tasks=len(tasks), device=label)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def run_partitioned(plan, g: CSRGraph) -> np.ndarray:
    """The partitioned full pass of ``g`` (the plan's run on ``partitions >
    1``): the plan's ``partition_mode``, the executor's retry, quarantine
    and fallback inside it, every shard's bins added into one
    accumulator (on a distributed plan, this rank's shards, merged over
    the mesh), ONE counted device→host copy.  Records
    ``plan.stats["partition"]``; returns the raw int64 bins."""
    if g.n_dyads == 0:  # the full-run convention: zeros, no copy
        return np.zeros(plan.layout.total_bins, dtype=np.int64)
    part = plan_partition(plan, g)
    geom = _Geometry(plan, g, part)
    mode = plan.partition_mode
    spill = plan.config.spill
    pstats = dict(partitions=part.parts, mode=mode,
                  cuts=[int(c) for c in part.cuts],
                  shard_dyads=part.dyad_counts, halo_sizes=part.halo_sizes,
                  spill=bool(spill), h2d_puts=0, d2d_puts=0,
                  max_stage_bytes=0,
                  max_shard_bytes=shard_context_bytes(plan, geom),
                  stream_bytes=int(2 * 4 * g.n_dyads))

    def fill(acc):
        _once_into(plan, acc, g)
        with _spill_scratch(spill) as scratch:
            shard_lists = []
            for shard in part.shards:
                if shard.n_dyads == 0:
                    continue
                u, v = shard_dyads(g, shard.lo, shard.hi)
                pstats["max_stage_bytes"] = max(
                    pstats["max_stage_bytes"],
                    int(u.nbytes + v.nbytes + 2 * 4 * geom.pad))
                if scratch is not None:
                    u, v = _stage_spill(u, v, scratch, f"shard{shard.index}")
                shard_lists.append((shard, u, v))
            run = _pool_pass if mode == "pool" else _serial_pass
            if shard_lists:
                run(plan, g, part, geom, shard_lists, acc, pstats)

    raw = _collect(plan, fill)
    pstats["shard_overlap"] = _overlap_fraction(pstats.get("shard_times",
                                                           {}))
    plan.stats["partition"] = pstats
    return raw


def subset_partitioned(plan, g: CSRGraph, u: np.ndarray, v: np.ndarray,
                       acc: torch.Tensor) -> None:
    """The partitioned subset pass (the delta path of a partitioned plan):
    add ``g``'s once contributions and the bins of its dyads ``(u, v)``
    into ``acc``.  The dyads group by owner shard (``searchsorted`` over
    the cuts) and only the owning shards build a local CSR and run —
    together through the pool under ``"pool"``, one at a time otherwise
    (on a distributed plan, this rank's part of them:
    :func:`_rank_split`).
    ``stats["partition"]["delta_shards"]`` records how many shards the
    pass touched."""
    part = plan_partition(plan, g)
    geom = _Geometry(plan, g, part)
    _once_into(plan, acc, g)
    u, v = np.asarray(u, np.int32), np.asarray(v, np.int32)
    owner = np.searchsorted(part.cuts, u.astype(np.int64), side="right") - 1
    shard_lists = [(shard, u[owner == shard.index], v[owner == shard.index])
                   for shard in part.shards if (owner == shard.index).any()]
    if plan.partition_mode == "pool" and shard_lists:
        # staging and timing go to a scratch record: the last full run's
        # observables stay readable
        _pool_pass(plan, g, part, geom, shard_lists, acc,
                   dict(h2d_puts=0, d2d_puts=0))
    else:
        for shard, su_, sv_ in _rank_split(plan, shard_lists):
            subset_pass(plan, g, su_, sv_, acc,
                        arrays=_shard_arrays(plan, g, shard, geom))
    pstats = plan.stats.setdefault("partition", dict(partitions=part.parts))
    pstats["delta_shards"] = len(shard_lists)
