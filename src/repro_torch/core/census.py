"""Sub-quadratic Triad Census building blocks (Batagelj–Mrvar, paper Fig.
2.4/2.5) as torch ops.

Counterpart of :mod:`repro.core.census`: the membership probe, the
per-batch census program of the ``"search"`` backend, dyad enumeration,
the degree-bucket sort, the host-side bucket schedule, and the
brute-force oracle.

Candidate layout of the batch program.  The JAX package pads every
dyad's two neighbourhoods to a dense ``(B, K)`` tile, with ``K`` the
graph's bucketed maximum degree.  On a skewed graph almost all of those
lanes are padding: for the Slashdot-sized R-MAT stand-in (K = 8192) the
dense layout holds ~4·10^9 lanes per run against ~3.3·10^8 real
candidates.  Here the candidates are **ragged**: each dyad contributes
exactly ``deg(u) + deg(v)`` lanes, laid out back to back.  The length of
that list is data-dependent, so the caller passes it (``n_cand``) from
the host-side schedule — the host owns the degree arrays — and the device
never has to report a size back.  The arithmetic per candidate (union
dedup, canonicality filter, four ``IsEdge`` probes, 64→16 table) is the
JAX program's, so per-batch partials are identical.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .graph import CSRGraph, GraphArrays, dense_adjacency
from .triad_table import TRIAD_TABLE_64


class CensusResult(NamedTuple):
    """A finished triad census: ``counts[i]`` is the number of triads of
    type ``i + 1`` in MAN notation ("003" .. "300"), including the
    type-003 closed form: int64, or exact Python ints (object dtype) once
    C(n, 3) passes int64's range (n >= 3,810,780).  ``total`` always
    equals C(n, 3)."""

    counts: np.ndarray  # (16,) int64, or object past int64

    @property
    def total(self) -> int:
        return int(self.counts.sum())


def make_member_fn(n_iters: int):
    """Sorted-CSR membership probe (binary search, fixed trips).

    ``member(ptr, idx, rows, queries) -> bool tensor`` broadcasting
    ``rows`` against ``queries``; ``n_iters >= ceil(log2(max_row_len +
    1))``.
    """

    def member(ptr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
               queries: torch.Tensor) -> torch.Tensor:
        rows, q = torch.broadcast_tensors(rows.long(), queries.long())
        lo = ptr[rows].long()
        end = ptr[rows + 1].long()
        hi = end
        last = idx.shape[0] - 1
        for _ in range(n_iters):
            active = lo < hi
            mid = (lo + hi) >> 1
            go_right = idx[mid.clamp(0, last)] < q
            lo = torch.where(active & go_right, mid + 1, lo)
            hi = torch.where(active & ~go_right, mid, hi)
        return (lo < end) & (idx[lo.clamp(0, last)] == q)

    return member


def make_census_batch_fn(member_iters: int):
    """Build the per-batch census program (the ``"search"`` backend's unit
    and the plain reference of the engine).

    Returns ``f(graph_arrays, n, u, v, valid, n_cand) -> (16,) int64``
    partial counts for a batch of canonical dyads ``(u, v), u < v``;
    ``n_cand`` must equal ``sum(deg(u) + deg(v))`` over the valid dyads
    (the ragged candidate count — see the module docstring).  Null triads
    (type 003) are not counted here; they come from the closed form at the
    end (paper line 29).
    """
    member = make_member_fn(member_iters)
    tables: dict = {}  # the 64 -> 16 table, copied once per device

    def batch_census(g: GraphArrays, n: int, u: torch.Tensor,
                     v: torch.Tensor, valid: torch.Tensor,
                     n_cand: int) -> torch.Tensor:
        if n_cand is None:
            raise ValueError(
                "the census batch program needs the ragged candidate count "
                "n_cand, which only the search backend computes (the tiles "
                "backend passes None outside its triad_census slice); run "
                "this op with backend='search'")
        dev = u.device
        B = u.shape[0]
        u, v = u.long(), v.long()
        deg = g.nbr_deg.long()
        ptr = g.nbr_ptr.long()
        # candidate segments, two per dyad: N(u) then N(v)
        cnt = torch.stack([torch.where(valid, deg[u], 0),
                           torch.where(valid, deg[v], 0)], 1).reshape(-1)
        start = torch.stack([ptr[u], ptr[v]], 1).reshape(-1)
        seg = torch.repeat_interleave(torch.arange(2 * B, device=dev), cnt,
                                      output_size=n_cand)
        first = torch.cumsum(cnt, 0) - cnt
        pos = start[seg] + torch.arange(n_cand, device=dev) - first[seg]
        w = g.nbr_idx[pos].long()
        owner = seg >> 1
        from_v = (seg & 1).bool()
        uo, vo = u[owner], v[owner]
        # S = N(u) ∪ N(v) \ {u, v}: N(v) candidates already in N(u) drop out
        live = torch.where(from_v, w != uo, w != vo)
        live &= ~(from_v & member(g.nbr_ptr, g.nbr_idx, uo, w))
        s_size = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
            0, owner, live.long())

        # dyadic triads (paper lines 9-14)
        e_uv = member(g.out_ptr, g.out_idx, u, v).long()
        e_vu = member(g.out_ptr, g.out_idx, v, u).long()
        dyad_code = e_uv + 2 * e_vu
        dyadic = torch.where(valid, n - s_size - 2, 0)

        # connected triads (paper lines 15-20): count w iff v < w, or
        # u < w < v and w is not in N(u) (the dedup above already says so)
        canon = live & torch.where(from_v, (w > vo) | ((w > uo) & (w < vo)),
                                   w > vo)
        code = (dyad_code[owner]
                + 4 * member(g.out_ptr, g.out_idx, uo, w).long()
                + 8 * member(g.out_ptr, g.out_idx, w, uo).long()
                + 16 * member(g.out_ptr, g.out_idx, vo, w).long()
                + 32 * member(g.out_ptr, g.out_idx, w, vo).long())
        table = tables.get(dev)
        if table is None:
            table = tables[dev] = torch.as_tensor(
                TRIAD_TABLE_64, dtype=torch.int64, device=dev)
        counts = torch.zeros(16, dtype=torch.int64, device=dev)
        counts.index_add_(0, table[code], canon.long())
        counts[0] = 0  # null triads come from the closed form
        counts.index_add_(0, torch.where(dyad_code == 3, 2, 1), dyadic)
        return counts

    return batch_census


def pad_dyads(u: np.ndarray, v: np.ndarray, batch: int):
    """Pad dyad lists to a multiple of ``batch``; returns (u, v, valid)."""
    d = len(u)
    pad = (-d) % batch
    u = np.concatenate([u, np.zeros(pad, u.dtype)])
    v = np.concatenate([v, np.ones(pad, v.dtype)])  # (0,1) keeps u<v
    valid = np.concatenate([np.ones(d, bool), np.zeros(pad, bool)])
    return u.astype(np.int32), v.astype(np.int32), valid


def canonical_dyads(g: CSRGraph) -> "tuple[np.ndarray, np.ndarray]":
    """All canonical connected dyads (u, v) with u < v (host numpy), in
    CSR row-major order — the order :func:`enumerate_dyads_device` gives."""
    nbr_ptr, nbr_idx = g.host.nbr_ptr, g.host.nbr_idx
    rows = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(nbr_ptr))
    keep = nbr_idx > rows
    return rows[keep], nbr_idx[keep]


def enumerate_dyads_device(nbr_ptr: torch.Tensor, nbr_idx: torch.Tensor,
                           m_nbr: int, *, out_size: int):
    """Device-side :func:`canonical_dyads`, fixed-shape.

    Inputs are the bucket-padded undirected CSR plus the true entry count
    ``m_nbr``.  Returns ``(u, v)`` int32 tensors of length ``out_size``
    holding the canonical dyads in CSR row-major order, padded past
    ``m_nbr // 2`` with the inert ``(0, 1)`` dyad.  Each entry's row comes
    from one ``searchsorted`` over the ptr array, and the ``col > row``
    filter is compacted by a second ``searchsorted`` over the running
    keep-count — no data-dependent shape, no read back to the host.
    """
    dev = nbr_idx.device
    M = nbr_idx.shape[0]
    pos = torch.arange(M, dtype=torch.int32, device=dev)
    rows = torch.searchsorted(nbr_ptr, pos, right=True) - 1
    keep = (pos < m_nbr) & (nbr_idx > rows)
    csum = torch.cumsum(keep, 0, dtype=torch.int32)
    rank = torch.arange(out_size, dtype=torch.int32, device=dev)
    src = torch.searchsorted(csum, rank + 1).clamp(0, M - 1)
    live = rank < (m_nbr // 2)
    return (torch.where(live, rows[src], 0).int(),
            torch.where(live, nbr_idx[src], 1).int())


def sort_dyads_by_bucket(nbr_deg: torch.Tensor, out_ptr: torch.Tensor,
                         u: torch.Tensor, v: torch.Tensor, n_dyads: int, *,
                         ks: tuple):
    """Device-side degree-bucket assignment + load-balancing sort.

    A dyad's tile-width *need* is ``max(deg(u), deg(v), out_deg(u),
    out_deg(v))``; its bucket is the smallest ``ks[i] >= need``.  Dyads
    are stable-sorted by (bucket, need) with two chained stable argsorts,
    exactly as the JAX program does, so chunk contents match it dyad for
    dyad.  Padding dyads sort past every real bucket.  Returns
    ``(u_sorted, v_sorted, bucket_counts)``.
    """
    dev = u.device
    ul, vl = u.long(), v.long()
    out_deg = out_ptr[1:] - out_ptr[:-1]
    need = torch.maximum(torch.maximum(nbr_deg[ul], nbr_deg[vl]),
                         torch.maximum(out_deg[ul], out_deg[vl]))
    b = torch.zeros_like(need, dtype=torch.int64)
    for k in ks:  # scalar compares: no host->device copy of ks
        b += need > k
    live = torch.arange(u.shape[0], device=dev) < n_dyads
    b = torch.where(live, b, len(ks))
    by_need = torch.argsort(need, stable=True)
    order = by_need[torch.argsort(b[by_need], stable=True)]
    # bucket edges in the sorted stream: no atomics on a handful of bins
    edges = torch.searchsorted(b[order], torch.arange(len(ks) + 1,
                                                      device=dev))
    return u[order], v[order], (edges[1:] - edges[:-1]).int()


def host_bucket_schedule(g: CSRGraph, ks: tuple, *, with_needs: bool = True
                         ) -> "tuple[np.ndarray, np.ndarray | None]":
    """Host-side mirror of :func:`sort_dyads_by_bucket`'s control outputs.

    Returns ``(bucket_counts, need_sorted)``: the per-bucket dyad counts
    (identical to the histogram the device sort computes) and each dyad's
    tile-width need in the device stream's (bucket, need) order.  Derived
    from the host degree arrays, so the tiles driver lays out its chunk
    loop without reading anything back from the device.
    """
    need, b = dyad_buckets(g, *canonical_dyads(g), ks)
    counts = np.bincount(b, minlength=len(ks))[: len(ks)].astype(np.int64)
    return counts, need[np.lexsort((need, b))] if with_needs else None


def dyad_buckets(g: CSRGraph, u: np.ndarray, v: np.ndarray, ks: tuple
                 ) -> "tuple[np.ndarray, np.ndarray]":
    """Host twin of :func:`sort_dyads_by_bucket`'s keys for the dyads
    ``(u, v)`` of ``g``: each dyad's tile-width need ``max(deg u, deg v,
    out_deg u, out_deg v)`` and its bucket, the index of the smallest
    ``ks[i] >= need`` (``len(ks)`` when none is)."""
    deg = g.host.nbr_deg
    out_deg = np.diff(g.host.out_ptr)
    need = np.maximum(np.maximum(deg[u], deg[v]),
                      np.maximum(out_deg[u], out_deg[v])).astype(np.int64)
    ks_arr = np.asarray(ks, dtype=np.int64)
    return need, (need[:, None] > ks_arr[None, :]).sum(1)


def make_census_fn(g: CSRGraph, *, batch: int = 256,
                   K: "int | None" = None):
    """Deprecated: a census function for graphs shaped like ``g``.

    Returns ``census(arrays, n, u, v, valid) -> (steps, 16)`` int64
    per-batch partials over dyads already padded to a multiple of
    ``batch`` (:func:`pad_dyads`), through the binary-search batch program
    (:func:`make_census_batch_fn`, the ``"search"`` backend's unit);
    ``arrays`` are the graph's tensors on the dyads' device.  Null triads
    (type 003) are not counted.  ``K`` is accepted for the JAX package's
    signature; the ragged program needs no tile width."""
    warnings.warn(
        "repro_torch.core.census.make_census_fn is deprecated; use "
        "repro_torch.engine.compile(graph, ('triad_census',), config)",
        DeprecationWarning, stacklevel=2)
    member_iters = max(1, math.ceil(math.log2(
        max(g.max_deg, g.max_out_deg, K or 0, 1) + 1))) + 1
    batch_fn = make_census_batch_fn(member_iters)
    deg = g.host.nbr_deg.astype(np.int64)

    def census(arrays: GraphArrays, n, u, v, valid) -> torch.Tensor:
        uh, vh, vah = (np.asarray(torch.as_tensor(x).cpu())
                       for x in (u, v, valid))
        dev = arrays.nbr_ptr.device
        parts = []
        for s in range(0, len(uh), batch):
            sl = slice(s, s + batch)
            n_cand = int((deg[uh[sl]] + deg[vh[sl]])[vah[sl]].sum())
            parts.append(batch_fn(
                arrays, int(n), torch.from_numpy(uh[sl]).to(dev),
                torch.from_numpy(vh[sl]).to(dev),
                torch.from_numpy(vah[sl]).to(dev), n_cand))
        if not parts:
            return torch.zeros((0, 16), dtype=torch.int64, device=dev)
        return torch.stack(parts)

    return census


def triad_census(g: CSRGraph, *, batch: int = 256,
                 K: "int | None" = None) -> CensusResult:
    """Deprecated: the census of ``g`` on its device.

    .. deprecated:: a shim over ``repro_torch.engine.compile_census(g,
       CensusConfig(backend="search", ...)).run(g)`` (the JAX package's
       forwards to ``"xla"``)."""
    from ..engine import CensusConfig, compile_census

    warnings.warn(
        "repro_torch.core.triad_census is deprecated; use "
        "repro_torch.engine.compile_census(graph, CensusConfig(...))"
        ".run(graph)", DeprecationWarning, stacklevel=2)
    cfg = CensusConfig(backend="search", batch=batch, k=K,
                       device=str(g.device))
    return compile_census(g, cfg).run(g)


def brute_force_census(g: CSRGraph) -> CensusResult:
    """The paper's naive O(n^3) census over the dense adjacency — the
    correctness oracle for small graphs."""
    a = dense_adjacency(g).astype(np.int64)
    n = g.n
    idx = np.arange(n)
    counts = np.zeros(16, dtype=np.int64)
    for i in range(n - 2):
        j, k = np.meshgrid(idx, idx, indexing="ij")
        sel = (j > i) & (k > j)
        jj, kk = j[sel], k[sel]
        code = (a[i, jj] + 2 * a[jj, i] + 4 * a[i, kk] + 8 * a[kk, i]
                + 16 * a[jj, kk] + 32 * a[kk, jj])
        counts += np.bincount(TRIAD_TABLE_64[code], minlength=16)
    return CensusResult(counts=counts)
