"""Contiguous vertex-range graph partitioning with halos (host side).

Counterpart of :mod:`repro.core.partition`, in plain numpy.  The paper's
Patents-scale result sits where the whole CSR need not fit on one device,
so the graph itself is sharded: the vertex id space is cut into ``parts``
contiguous ranges balanced by **owned canonical dyads**, and each shard
gets a *local* CSR holding the full rows of its range plus a **halo** of
the remote rows its dyads read.

Contiguous ranges: canonical dyads ``(u, v), v > u`` are enumerated in
row order, so a range owns a contiguous span of the canonical dyad
stream, and the cuts come from a cumulative sum and a ``searchsorted``
over per-row owned-dyad counts.  A locality relabeling
(``EngineConfig(reorder=...)``, applied before partitioning) then
doubles as a partitioner.

The halo is ``(partners ∪ N(range ∪ partners))`` minus the range: a
dyad's contribution reads only rows of ``{u, v} ∪ N(u) ∪ N(v)`` (the
``GraphOp.delta_local`` contract), ``u`` is in the range and ``v`` a
partner.  Kept rows are copied IN FULL, so every search over them sees
the global row and the shard's bins equal the unpartitioned ones.

Every function reads the graph through a host view (:func:`_host`): a
numpy array, including the ``np.memmap`` of a graph built by
:func:`repro_torch.core.graph.from_edges_mmap`, passes untouched (slices
of it stay lazy), a CPU tensor is viewed through ``.numpy()``, and a
CUDA tensor is fetched once.  The device side lives in
:mod:`repro_torch.engine.partition`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import CSRGraph, GraphArrays

__all__ = ["GraphPartition", "ShardInfo", "build_local_arrays",
           "halo_by_owner", "halo_vertices", "local_ptrs", "owned_idx",
           "partition_cuts", "partition_graph", "shard_dyads"]


def _host(a) -> np.ndarray:
    """Host view of a graph array: numpy (``np.memmap`` included, which
    stays lazy) passes through, a CPU tensor is viewed, a device tensor
    is copied to the host once."""
    if isinstance(a, np.ndarray):
        return a
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _ptr(g: CSRGraph, name: str) -> np.ndarray:
    return _host(getattr(g.host, name))[: g.n + 1].astype(np.int64)


def partition_cuts(g: CSRGraph, parts: int) -> np.ndarray:
    """``parts + 1`` vertex boundaries with near-equal owned-dyad counts.

    Vertex ``u`` owns the canonical dyads ``(u, v), v > u, v ∈ N(u)``;
    the cumulative owned-count curve is cut at even targets, so the
    shards balance *work* (dyads), not vertices.  Returns a monotone int64
    array ``[0, c_1, ..., c_{parts-1}, n]``; repeated boundaries (an empty
    shard) are legal and skipped at execution."""
    parts = max(1, int(parts))
    ptr = _ptr(g, "nbr_ptr")
    idx = _host(g.host.nbr_idx)
    owned = np.zeros(g.n, dtype=np.int64)
    block = 1 << 18  # rows per sweep: bounded RAM on mmap graphs too
    for lo in range(0, g.n, block):
        hi = min(lo + block, g.n)
        cols = np.asarray(idx[int(ptr[lo]): int(ptr[hi])], dtype=np.int64)
        rows = np.repeat(np.arange(lo, hi, dtype=np.int64),
                         np.diff(ptr[lo:hi + 1]))
        owned[lo:hi] = np.bincount(rows[cols > rows] - lo,
                                   minlength=hi - lo)
    cum = np.concatenate([[0], np.cumsum(owned)])
    targets = cum[-1] * np.arange(1, parts, dtype=np.float64) / parts
    cuts = np.searchsorted(cum, targets, side="left")
    return np.concatenate([[0], cuts, [g.n]]).astype(np.int64)


def shard_dyads(g: CSRGraph, lo: int, hi: int):
    """Canonical dyads owned by the range ``[lo, hi)``, in global ids and
    canonical (row-major) order.  Reads only the range's rows."""
    ptr = _ptr(g, "nbr_ptr")
    cols = np.asarray(_host(g.host.nbr_idx)[int(ptr[lo]): int(ptr[hi])])
    rows = np.repeat(np.arange(lo, hi, dtype=np.int32),
                     np.diff(ptr[lo:hi + 1]))
    keep = cols > rows
    return rows[keep].astype(np.int32), cols[keep].astype(np.int32)


def _gather_rows(ptr: np.ndarray, idx, verts: np.ndarray) -> np.ndarray:
    """Concatenated CSR rows of ``verts`` (sorted unique int64 ids), by one
    vectorized position expansion."""
    starts = ptr[verts]
    counts = ptr[verts + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])
    pos = np.repeat(starts - cum[:-1], counts) + np.arange(total)
    return np.asarray(idx[pos], dtype=np.int64)


def halo_vertices(g: CSRGraph, lo: int, hi: int,
                  partners: np.ndarray) -> np.ndarray:
    """Sorted remote row ids the shard ``[lo, hi)`` keeps: ``(partners ∪
    N(range ∪ partners))`` outside the range.  ``partners`` are the ``v``
    ends of the shard's owned dyads."""
    own = np.arange(lo, hi, dtype=np.int64)
    ends = np.union1d(own, np.asarray(partners, dtype=np.int64))
    third = _gather_rows(_ptr(g, "nbr_ptr"), _host(g.host.nbr_idx), ends)
    needed = np.union1d(ends, third)
    return needed[(needed < lo) | (needed >= hi)]


def halo_by_owner(cuts: np.ndarray,
                  halo: np.ndarray) -> "list[tuple[int, np.ndarray]]":
    """A shard's halo row ids grouped by the shard that OWNS them:
    ``[(owner_index, ids), ...]`` in owner order, each group one
    contiguous slice of the sorted halo.  Each entry is one (requester,
    owner) exchange of the pool mode: the owner's resident local arrays
    hold those rows in full."""
    halo = np.asarray(halo, dtype=np.int64)
    if len(halo) == 0:
        return []
    owner = np.searchsorted(np.asarray(cuts), halo, side="right") - 1
    bounds = np.flatnonzero(np.diff(owner)) + 1
    groups = np.split(halo, bounds)
    return [(int(owner[0 if i == 0 else bounds[i - 1]]), grp)
            for i, grp in enumerate(groups)]


def _kept(lo: int, hi: int, halo: np.ndarray) -> np.ndarray:
    return np.union1d(np.arange(lo, hi, dtype=np.int64),
                      np.asarray(halo, dtype=np.int64))


def _local_ptr(ptr: np.ndarray, n: int, keep: np.ndarray) -> np.ndarray:
    counts = np.zeros(n, dtype=np.int64)
    counts[keep] = ptr[keep + 1] - ptr[keep]
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def local_ptrs(g: CSRGraph, lo: int, hi: int, halo: np.ndarray):
    """The O(n) ptr half of a shard's local CSR — ``(out_ptr, nbr_ptr,
    nbr_deg)`` as :func:`build_local_arrays` lays them out — without
    gathering any idx entry.  The kept rows lie in vertex-id order, so the
    rows owned by shard ``o`` (range ``[lo_o, hi_o)``) occupy the span
    ``[ptr[lo_o], ptr[hi_o])`` of the compacted idx arrays."""
    keep = _kept(lo, hi, halo)
    out_ptr = _local_ptr(_ptr(g, "out_ptr"), g.n, keep)
    nbr_ptr = _local_ptr(_ptr(g, "nbr_ptr"), g.n, keep)
    return out_ptr, nbr_ptr, np.diff(nbr_ptr).astype(np.int32)


def owned_idx(g: CSRGraph, lo: int, hi: int):
    """Concatenated idx entries of the OWNED rows ``[lo, hi)`` only —
    ``(out_block, nbr_block)`` int32, the host upload a pool-mode shard
    pays for its idx arrays (its halo blocks come from their owners)."""
    verts = np.arange(lo, hi, dtype=np.int64)
    out = _gather_rows(_ptr(g, "out_ptr"), _host(g.host.out_idx), verts)
    nbr = _gather_rows(_ptr(g, "nbr_ptr"), _host(g.host.nbr_idx), verts)
    return out.astype(np.int32), nbr.astype(np.int32)


def build_local_arrays(g: CSRGraph, lo: int, hi: int,
                       halo: np.ndarray) -> GraphArrays:
    """A shard's local CSR as host numpy: full-length ptr/deg arrays (rows
    outside ``range ∪ halo`` are empty, so a search of them misses, which
    no owned dyad's read does) over **compacted** idx arrays holding only
    the kept rows' entries.  Kept rows equal the global rows."""
    keep = _kept(lo, hi, halo)

    def sub(ptr_name, idx_name):
        ptr = _ptr(g, ptr_name)
        local_idx = _gather_rows(ptr, _host(getattr(g.host, idx_name)), keep)
        return _local_ptr(ptr, g.n, keep), local_idx.astype(np.int32)

    out_ptr, out_idx = sub("out_ptr", "out_idx")
    nbr_ptr, nbr_idx = sub("nbr_ptr", "nbr_idx")
    return GraphArrays(out_ptr=out_ptr, out_idx=out_idx, nbr_ptr=nbr_ptr,
                       nbr_idx=nbr_idx,
                       nbr_deg=np.diff(nbr_ptr).astype(np.int32))


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Static per-shard metadata (dyad lists and local CSRs are rebuilt
    per run: a cached plan never pins graph-sized host memory)."""

    index: int
    lo: int              # owned vertex range [lo, hi)
    hi: int
    n_dyads: int         # owned canonical dyads
    halo: np.ndarray     # sorted remote row ids kept locally
    m_out: int           # local out-CSR entries (owned ∪ halo rows)
    m_nbr: int           # local nbr-CSR entries

    @property
    def halo_size(self) -> int:
        return int(len(self.halo))


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """A graph's partition layout: the cuts and one :class:`ShardInfo` per
    shard.  Metadata only — O(n) at worst, never O(m)."""

    parts: int
    cuts: np.ndarray
    shards: "tuple[ShardInfo, ...]"

    @property
    def dyad_counts(self) -> "list[int]":
        return [s.n_dyads for s in self.shards]

    @property
    def halo_sizes(self) -> "list[int]":
        return [s.halo_size for s in self.shards]

    @property
    def max_dyads(self) -> int:
        return max([s.n_dyads for s in self.shards] or [0])


def partition_graph(g: CSRGraph, parts: int) -> GraphPartition:
    """Cut ``g`` into ``parts`` contiguous vertex-range shards with halos:
    one pass per shard over its owned and halo rows, enough to rebuild
    any shard's local CSR on its own (one shard resident at a time)."""
    cuts = partition_cuts(g, parts)
    out_ptr, nbr_ptr = _ptr(g, "out_ptr"), _ptr(g, "nbr_ptr")
    shards = []
    for i in range(len(cuts) - 1):
        lo, hi = int(cuts[i]), int(cuts[i + 1])
        u, v = shard_dyads(g, lo, hi)
        halo = halo_vertices(g, lo, hi, np.unique(v))
        keep = _kept(lo, hi, halo)
        shards.append(ShardInfo(
            index=i, lo=lo, hi=hi, n_dyads=int(len(u)), halo=halo,
            m_out=int((out_ptr[keep + 1] - out_ptr[keep]).sum()),
            m_nbr=int((nbr_ptr[keep + 1] - nbr_ptr[keep]).sum())))
    return GraphPartition(parts=len(shards), cuts=cuts, shards=tuple(shards))
