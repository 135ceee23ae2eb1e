"""Pluggable graph analytics: the GraphOp protocol, the registry, the four
built-in ops and the fused accumulator layout.

Counterpart of :mod:`repro.engine.ops`.  A :class:`GraphOp` declares up to
three pieces and lets the engine pay for the traversal once for every op
that wants it:

  * ``make_batch_fn`` — the per-chunk device kernel: torch ops over a
    batch of canonical dyads ``(u, v), u < v`` returning ``(bins,)``
    int64 partial counts, additive across batches;
  * ``make_once_fn`` — an optional per-run device contribution (for
    vertex-space analytics such as degree statistics), folded into the
    accumulator exactly once per run, before the chunk loop;
  * ``finalize`` — the host step from raw int64 bins to the op's result.

``compile(graph, ops, EngineConfig())`` fuses any number of ops into one
pass: one dyad stream, one int64 accumulator with a slice per kernel
(:class:`OpLayout`), one device→host copy.  Ops that declare the same
``kernel_key`` share one kernel and one slice (``triadic_profile`` reads
the ``triad_census`` bins).  On an arc-free graph no chunk runs, so
``finalize`` must give the right result from all-zero bins when
``g.m == 0``.  Every built-in op ships a numpy ``reference`` oracle.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import spans
from ..core.census import (CensusResult, brute_force_census,
                           make_census_batch_fn, make_member_fn)
from ..core.graph import CSRGraph, dense_adjacency
from ..core.triad_table import TRIAD_NAMES

__all__ = ["DegreeStats", "DyadCensus", "GraphOp", "OpLayout",
           "TriadicProfile", "get_op", "list_ops", "register_op",
           "resolve_ops", "unregister_op"]


def _c2(n: int) -> int:
    return n * (n - 1) // 2 if n >= 2 else 0


def _c3(n: int) -> int:
    return n * (n - 1) * (n - 2) // 6 if n >= 3 else 0


# ----------------------------------------------------------------------------
# result types
# ----------------------------------------------------------------------------


class DyadCensus(NamedTuple):
    """MAN dyad census over all C(n, 2) vertex pairs: a pair is **mutual**
    when both arcs exist, **asymmetric** when exactly one does, **null**
    otherwise (null pairs come from the closed form)."""

    mutual: int
    asymmetric: int
    null: int


class DegreeStats(NamedTuple):
    """In/out-degree summary of the directed graph.

    ``out_hist`` / ``in_hist`` are log2 histograms over the n vertices:
    bin 0 counts degree-0 vertices, bin b (b >= 1) degrees in
    ``[2**(b-1), 2**b)``, and the top bin absorbs everything larger.
    ``mean_out == mean_in == m / n``, computed on the host."""

    out_hist: np.ndarray  # (16,) int64
    in_hist: np.ndarray   # (16,) int64
    max_out: int
    max_in: int
    mean_out: float
    mean_in: float


class TriadicProfile(NamedTuple):
    """Transitivity profile derived from the 16 triad-census bins, over the
    underlying undirected graph: ``triangles``, ``open_triples`` (wedges
    not closed into a triangle), ``transitivity`` = 3 * triangles /
    (3 * triangles + open_triples) and ``triangle_density`` = triangles /
    C(n, 3)."""

    triangles: int
    open_triples: int
    transitivity: float
    triangle_density: float


# ----------------------------------------------------------------------------
# the GraphOp protocol
# ----------------------------------------------------------------------------


class GraphOp:
    """One pluggable analytic: per-chunk kernel + per-run contribution +
    host finalize.

    Subclass, set ``name`` / ``bins``, override any of
    :meth:`make_batch_fn` / :meth:`make_once_fn` / :meth:`finalize` /
    :meth:`reference`, and :func:`register_op` an instance; every entry
    point (``compile``, ``CensusService`` requests) then accepts it by
    name.  ``kernel_key`` names another op whose kernel and accumulator
    slice this one shares.

    The batch kernel maps ``(graph_arrays, n, u, v, valid, n_cand)`` — a
    batch of canonical dyads, padded lanes masked by ``valid`` and holding
    the inert dyad ``(0, 1)`` — to ``(bins,)`` int64 partial counts,
    additive across batches.  ``n_cand`` is the batch's ragged candidate
    count ``sum(deg u + deg v)`` over the valid dyads (see
    :mod:`repro_torch.core.census`).  Only the ``"search"`` backend passes
    it; on ``"tiles"`` the ``triad_census`` slice runs the CUDA kernel and
    every other kernel gets ``n_cand=None``, since no built-in op outside
    the census slice reads it.  A kernel that needs it raises there."""

    name: str = ""
    bins: int = 0
    kernel_key: Optional[str] = None  # None -> own kernel, keyed by name
    #: Locality contract of the delta engine (:mod:`repro_torch.engine.
    #: delta`): ``True`` promises that the batch kernel's contribution for
    #: a dyad ``(u, v)`` depends only on ``n`` and the arcs between
    #: ``{u, v}`` and ``{u, v} ∪ N(u) ∪ N(v)``, and that any once
    #: contribution is a whole-graph function the delta pass may
    #: recompute outright.  An op that reads beyond that sets ``False``;
    #: ``Plan.apply_delta`` then always recomputes in full.
    delta_local: bool = True

    def make_batch_fn(self, meta, config) -> Optional[Callable]:
        """The per-chunk device kernel, or ``None``."""
        return None

    def make_once_fn(self, meta, config) -> Optional[Callable]:
        """The per-run device contribution ``(graph_arrays, n) -> (bins,)``
        int64, or ``None``.  The arrays are padded to the plan's buckets:
        ``out_ptr[-1]`` is the true arc count and vertices at index >= n
        are padding."""
        return None

    def finalize(self, raw: np.ndarray, g: CSRGraph) -> Any:
        """Host step from raw int64 bins to the op's result; must give the
        right answer from all-zero ``raw`` when ``g.m == 0``."""
        raise NotImplementedError

    def unpermute_raw(self, raw: np.ndarray, perm: np.ndarray,
                      g: CSRGraph) -> np.ndarray:
        """Map this kernel's raw bins from relabeled vertex ids back to the
        original ones (``perm[old_id] = new_id`` is the relabeling the run
        used; see :mod:`repro_torch.core.reorder`).  The identity by
        default: every built-in op's bins are vertex-anonymous
        aggregates.  An op whose bin ``i`` belongs to vertex ``i``
        overrides it with the gather ``out[:n] = raw[perm]``.  Must be
        linear in ``raw``: the delta engine folds corrections computed in
        relabeled ids through it."""
        return raw

    def reference(self, g: CSRGraph) -> Any:
        """Numpy oracle of the op's result, for small graphs."""
        raise NotImplementedError


# ----------------------------------------------------------------------------
# built-in ops
# ----------------------------------------------------------------------------


class TriadCensusOp(GraphOp):
    """The paper's analytic: the 16-type Batagelj–Mrvar triad census.
    Finalize adds the type-003 closed form (paper line 29)."""

    name = "triad_census"
    bins = 16

    def make_batch_fn(self, meta, config):
        return make_census_batch_fn(meta.member_iters)

    def finalize(self, raw: np.ndarray, g: CSRGraph) -> CensusResult:
        counts = raw.astype(np.int64).copy()
        c3 = _c3(g.n)
        if c3 > np.iinfo(np.int64).max:
            # from n = 3,810,780 on, bin 003 passes int64: Python ints
            counts = counts.astype(object)
        counts[0] = c3 - int(counts.sum())
        return CensusResult(counts=counts)

    def reference(self, g: CSRGraph) -> CensusResult:
        return brute_force_census(g)


class DyadCensusOp(GraphOp):
    """MAN dyad census: two ``IsEdge`` probes per streamed dyad; null pairs
    from the C(n, 2) closed form in finalize."""

    name = "dyad_census"
    bins = 3  # [mutual, asymmetric, 0]

    def make_batch_fn(self, meta, config):
        member = make_member_fn(meta.member_iters)

        def dyad_fn(arrays, n, u, v, valid, n_cand):
            e_uv = member(arrays.out_ptr, arrays.out_idx, u, v)
            e_vu = member(arrays.out_ptr, arrays.out_idx, v, u)
            mut = (e_uv & e_vu & valid).sum()
            asym = ((e_uv ^ e_vu) & valid).sum()
            return torch.stack([mut, asym, torch.zeros_like(mut)])

        return dyad_fn

    def finalize(self, raw: np.ndarray, g: CSRGraph) -> DyadCensus:
        mutual, asymmetric = int(raw[0]), int(raw[1])
        return DyadCensus(mutual, asymmetric, _c2(g.n) - mutual - asymmetric)

    def reference(self, g: CSRGraph) -> DyadCensus:
        a = dense_adjacency(g)
        mutual = int(np.logical_and(a, a.T).sum()) // 2
        asymmetric = int(np.logical_and(a, ~a.T).sum())
        return DyadCensus(mutual, asymmetric, _c2(g.n) - mutual - asymmetric)


class DegreeStatsOp(GraphOp):
    """In/out-degree histograms and maxima: a vertex-space analytic, one
    once contribution per run and no per-dyad kernel.  In-degrees come
    from a scatter-add over the out-arc columns, padded entries masked."""

    name = "degree_stats"
    H = 16  # log2 histogram bins (see DegreeStats)
    bins = 2 * H + 2  # out_hist, in_hist, max_out, max_in

    def make_once_fn(self, meta, config):
        H = self.H

        def once(arrays, n):
            dev = arrays.out_ptr.device
            nb = arrays.out_ptr.shape[0] - 1
            vmask = torch.arange(nb, device=dev) < n
            out_deg = (arrays.out_ptr[1:] - arrays.out_ptr[:-1]).long()
            m = arrays.out_ptr[-1]  # padded rows repeat the last offset
            pos = torch.arange(arrays.out_idx.shape[0], device=dev)
            in_deg = torch.zeros(nb, dtype=torch.int64, device=dev)
            in_deg.index_add_(0, arrays.out_idx.long(), (pos < m).long())
            shifts = torch.arange(H - 1, device=dev)

            def hist(deg):
                # bin = min(bit_length(deg), H - 1); 0 stays in bin 0
                b = ((deg[:, None] >> shifts[None, :]) > 0).sum(1)
                return torch.zeros(H, dtype=torch.int64,
                                   device=dev).index_add_(0, b, vmask.long())

            def mx(deg):
                return torch.where(vmask, deg, 0).max().reshape(1)

            return torch.cat([hist(out_deg), hist(in_deg), mx(out_deg),
                              mx(in_deg)])

        return once

    def finalize(self, raw: np.ndarray, g: CSRGraph) -> DegreeStats:
        H = self.H
        if g.m == 0:  # no chunks ran: all n vertices sit in bin 0
            out_hist = np.zeros(H, np.int64)
            out_hist[0] = g.n
            in_hist = out_hist.copy()
            mx_out = mx_in = 0
        else:
            raw = raw.astype(np.int64)
            out_hist, in_hist = raw[:H].copy(), raw[H:2 * H].copy()
            mx_out, mx_in = int(raw[2 * H]), int(raw[2 * H + 1])
        mean = g.m / g.n if g.n else 0.0
        return DegreeStats(out_hist, in_hist, mx_out, mx_in, mean, mean)

    def reference(self, g: CSRGraph) -> DegreeStats:
        H = self.H
        out_deg = np.diff(g.host.out_ptr[: g.n + 1]).astype(np.int64)
        idx = g.host.out_idx[: g.m]
        in_deg = np.bincount(idx, minlength=g.n)[: g.n].astype(np.int64)

        def hist(d):
            b = np.where(d == 0, 0, np.minimum(
                np.floor(np.log2(np.maximum(d, 1))).astype(np.int64) + 1,
                H - 1))
            return np.bincount(b, minlength=H)[:H].astype(np.int64)

        mean = g.m / g.n if g.n else 0.0
        return DegreeStats(hist(out_deg), hist(in_deg),
                           int(out_deg.max(initial=0)),
                           int(in_deg.max(initial=0)), mean, mean)


#: connected (mutual + asymmetric) dyads per triad type, from the MAN name.
_CONNECTED = tuple(int(nm[0]) + int(nm[1]) for nm in TRIAD_NAMES)


class TriadicProfileOp(GraphOp):
    """Transitivity and triangle statistics from the census bins.

    ``kernel_key = "triad_census"``: fused with the census it shares its
    kernel and slice, alone it runs the census kernel.  Finalize weighs
    each triad type by its connected-dyad count: 3 is a triangle (three
    closed wedges), 2 one open wedge."""

    name = "triadic_profile"
    kernel_key = "triad_census"
    bins = 16

    def make_batch_fn(self, meta, config):
        return make_census_batch_fn(meta.member_iters)

    def _profile(self, counts, n: int) -> TriadicProfile:
        tri = sum(int(c) for c, k in zip(counts, _CONNECTED) if k == 3)
        wedges = sum(int(c) * (3 if k == 3 else 1)
                     for c, k in zip(counts, _CONNECTED) if k >= 2)
        transitivity = 3.0 * tri / wedges if wedges else 0.0
        density = tri / _c3(n) if n >= 3 else 0.0
        return TriadicProfile(tri, wedges - 3 * tri, transitivity, density)

    def finalize(self, raw: np.ndarray, g: CSRGraph) -> TriadicProfile:
        # raw bin 0 ("003") is 0 and has connected weight 0: no closed form
        return self._profile(raw, g.n)

    def reference(self, g: CSRGraph) -> TriadicProfile:
        return self._profile(brute_force_census(g).counts, g.n)


# ----------------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------------

_REGISTRY: "dict[str, GraphOp]" = {}


def register_op(op: GraphOp, *, overwrite: bool = False) -> GraphOp:
    """Register a :class:`GraphOp` instance under ``op.name``, so every
    ``ops`` argument accepts it by name.  Returns ``op``."""
    if not op.name:
        raise ValueError("GraphOp needs a non-empty name")
    if op.bins < 1:
        raise ValueError(f"GraphOp {op.name!r} needs bins >= 1")
    if op.name in _REGISTRY and not overwrite:
        raise ValueError(f"GraphOp {op.name!r} is already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[op.name] = op
    return op


def unregister_op(name: str) -> None:
    """Remove a registered op (no-op if absent).  Plans already compiled
    against it keep working; only name lookup is affected."""
    _REGISTRY.pop(name, None)


def get_op(name: str) -> GraphOp:
    """Look up a registered :class:`GraphOp` by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown GraphOp {name!r}; registered: "
                       f"{list_ops()}") from None


def list_ops() -> "tuple[str, ...]":
    """Names of every registered :class:`GraphOp`, sorted."""
    return tuple(sorted(_REGISTRY))


def resolve_ops(ops) -> "tuple[GraphOp, ...]":
    """Normalize an ops spec — a name, a :class:`GraphOp`, or a sequence of
    either — into a tuple of op instances (order kept, no duplicates)."""
    if isinstance(ops, (str, GraphOp)):
        ops = (ops,)
    out = tuple(get_op(o) if isinstance(o, str) else o for o in ops)
    if not out:
        raise ValueError("ops must name at least one GraphOp")
    for op in out:
        if not isinstance(op, GraphOp):
            raise TypeError(f"ops entries must be GraphOp names or "
                            f"instances, got {op!r}")
    names = [op.name for op in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate ops in {names}")
    return out


for _op in (TriadCensusOp(), DyadCensusOp(), DegreeStatsOp(),
            TriadicProfileOp()):
    register_op(_op)


# ----------------------------------------------------------------------------
# fused accumulator layout
# ----------------------------------------------------------------------------


class OpLayout:
    """Accumulator layout + fused kernels for one plan's ops.

    Ops are deduplicated by ``kernel_key`` (the first op bearing a key
    owns its kernel, unless the key's namesake is among the ops); each
    kernel owns a contiguous slice of the ``(total_bins,)`` int64
    accumulator, and :meth:`finalize` hands each op its slice."""

    def __init__(self, ops, meta, config):
        self.ops = tuple(ops)
        owners: dict = {}
        self.keys: list = []
        for op in self.ops:
            key = op.kernel_key or op.name
            if key not in owners:
                owners[key] = op
                self.keys.append(key)
            elif op.name == key:
                owners[key] = op  # a key's namesake always owns its kernel
        for op in self.ops:
            key = op.kernel_key or op.name
            if op.bins != owners[key].bins:
                raise ValueError(
                    f"op {op.name!r} shares kernel_key {key!r} but declares "
                    f"bins={op.bins} != {owners[key].bins} (the kernel "
                    f"owner's width) — sharers read the owner's slice and "
                    f"must agree on its size")
        self._owners = owners
        self.bins = tuple(owners[k].bins for k in self.keys)
        edges = np.concatenate([[0], np.cumsum(self.bins)]).astype(int)
        self.slices = {k: slice(int(edges[i]), int(edges[i + 1]))
                       for i, k in enumerate(self.keys)}
        self.total_bins = int(edges[-1])
        self._batch_fns = [owners[k].make_batch_fn(meta, config)
                           for k in self.keys]
        self._once_fns = [owners[k].make_once_fn(meta, config)
                          for k in self.keys]

    def has_batch(self, *, skip=()) -> bool:
        """True if any kernel outside ``skip`` has a per-dyad component."""
        return any(f is not None for k, f in zip(self.keys, self._batch_fns)
                   if k not in skip)

    def batch_kernel(self, *, skip=()):
        """Fused per-batch kernel ``(arrays, n, u, v, valid, n_cand) ->
        (total_bins,)`` int64.  Keys in ``skip`` contribute zeros — the
        tiles backend skips ``"triad_census"`` and fills that slice with
        the CUDA kernel instead."""
        fns = [None if k in skip else f
               for k, f in zip(self.keys, self._batch_fns)]
        return self._fuse(fns)

    def once_kernel(self):
        """Fused per-run kernel ``(arrays, n) -> (total_bins,)`` int64, or
        ``None`` when no op declares a once contribution."""
        if all(f is None for f in self._once_fns):
            return None
        return self._fuse(self._once_fns)

    def _fuse(self, fns):
        bins = self.bins

        def fused(arrays, n, *args):
            dev = arrays.out_ptr.device
            parts = [f(arrays, n, *args) if f is not None
                     else torch.zeros(b, dtype=torch.int64, device=dev)
                     for f, b in zip(fns, bins)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        return fused

    def unpermute(self, raw, perm, g: CSRGraph) -> np.ndarray:
        """Map fused raw bins from relabeled vertex ids back to the
        original ones, slice by slice through each kernel owner's
        :meth:`GraphOp.unpermute_raw`; returns ``raw`` itself when every
        owner keeps the identity (all built-in ops)."""
        out = None
        for k in self.keys:
            op = self._owners[k]
            if type(op).unpermute_raw is GraphOp.unpermute_raw:
                continue
            if out is None:
                out = np.array(raw, dtype=np.int64, copy=True)
            sl = self.slices[k]
            out[sl] = np.asarray(op.unpermute_raw(out[sl], perm, g),
                                 dtype=np.int64)
        return raw if out is None else out

    def finalize(self, raw, g: CSRGraph) -> dict:
        """Per-op results from the fused raw bins: ``{op.name: result}`` in
        the plan's op order."""
        with spans.span(spans.FINALIZE):
            raw = np.asarray(raw, dtype=np.int64)
            return {op.name:
                    op.finalize(raw[self.slices[op.kernel_key or op.name]], g)
                    for op in self.ops}
