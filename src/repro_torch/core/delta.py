"""Graph mutations and their exact blast radius (the delta-census core).

Counterpart of :mod:`repro.core.delta`, host numpy on the port's
:class:`~repro_torch.core.graph.CSRGraph` (its ``host`` arrays).  Every
per-dyad kernel contribution is a function of the dyad's own arcs and
the arcs between ``{u, v}`` and ``N(u) ∪ N(v)``, so an arc-only mutation
can change the contribution of a canonical dyad ``(u, v)`` only if ``u``
or ``v`` is an endpoint of a touched arc: a probe against a third vertex
``w`` tests membership of ``u`` or ``v`` in w's rows, and an arc between
``w`` and the dyad that changed puts ``u`` or ``v`` in the touched set.
The affected set is therefore exact, read from the undirected rows of the
touched vertices.

:class:`GraphDelta` holds validated, deduplicated arc lists,
:func:`affected_dyads` gives the affected canonical dyads of one graph,
and :func:`apply_delta_csr` the mutated graph.  The device correction
pass lives in :mod:`repro_torch.engine.delta`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import CSRGraph, arcs_host, from_edges

__all__ = ["GraphDelta", "affected_dyads", "apply_delta_csr"]


def _normalize_edges(edges, what: str) -> np.ndarray:
    """Coerce an arc spec (``None``, pairs, or a ``(k, 2)`` array) into a
    deduplicated ``(k, 2)`` int64 array: self-loops dropped, duplicates
    collapsed, negative endpoints rejected (upper bounds are checked
    against a graph by :meth:`GraphDelta.validate_for`)."""
    if edges is None:
        return np.zeros((0, 2), dtype=np.int64)
    a = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges,
                   dtype=np.int64)
    if a.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"{what} must be (k, 2) arc pairs, got shape "
                         f"{a.shape}")
    if (a < 0).any():
        raise ValueError(f"{what} endpoints must be >= 0")
    a = a[a[:, 0] != a[:, 1]]  # strict digraph: self-loops are inert
    if len(a):
        a = np.unique(a, axis=0)
    return a


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of arc mutations against a fixed vertex set.

    ``edges_removed`` are applied first, then ``edges_added``: an arc in
    both lists is present afterwards.  Removing an absent arc or adding a
    present one is a no-op, so deltas are safe to replay.  Both lists are
    normalized at construction (``(k, 2)`` int64, no self-loops, no
    duplicates, no negatives).
    """

    edges_added: np.ndarray = None
    edges_removed: np.ndarray = None

    def __post_init__(self):
        object.__setattr__(self, "edges_added",
                           _normalize_edges(self.edges_added, "edges_added"))
        object.__setattr__(self, "edges_removed",
                           _normalize_edges(self.edges_removed,
                                            "edges_removed"))

    @property
    def size(self) -> int:
        """Total arcs named by the delta (after normalization)."""
        return len(self.edges_added) + len(self.edges_removed)

    @property
    def is_empty(self) -> bool:
        """True when the delta cannot change any graph it is valid for."""
        return self.size == 0

    @property
    def touched(self) -> np.ndarray:
        """Sorted unique endpoints of every named arc: the seed set of the
        affected-dyad closure."""
        if self.is_empty:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate([self.edges_added.ravel(),
                                         self.edges_removed.ravel()]))

    def permuted(self, perm) -> "GraphDelta":
        """The same mutation in relabeled vertex ids: every endpoint ``x``
        becomes ``perm[x]``.  :func:`~repro_torch.core.graph.from_edges`
        is canonical over arc sets, so applying the permuted delta to the
        permuted graph gives the permutation of the mutated graph — the
        boundary translation of the engine's ``reorder=`` path."""
        p = np.asarray(perm, dtype=np.int64)
        return GraphDelta(
            edges_added=(p[self.edges_added] if len(self.edges_added)
                         else self.edges_added),
            edges_removed=(p[self.edges_removed] if len(self.edges_removed)
                           else self.edges_removed))

    def validate_for(self, g: CSRGraph) -> None:
        """Raise ``ValueError`` unless every endpoint is a vertex of ``g``."""
        if self.size and int(self.touched[-1]) >= g.n:
            raise ValueError(
                f"delta touches vertex {int(self.touched[-1])} but the graph "
                f"has n={g.n} vertices (the vertex set is fixed; rebuild via "
                "from_edges to grow it)")


def affected_dyads(g: CSRGraph, delta: GraphDelta
                   ) -> "tuple[np.ndarray, np.ndarray]":
    """Canonical dyads of ``g`` whose kernel contribution the delta can
    change: every ``(u, v), u < v`` of ``g`` with an endpoint in
    ``delta.touched``, as sorted ``(u, v)`` int32 arrays.  Dyads created
    or destroyed by the delta appear in only one graph's set, so the
    correction evaluates this on the old and the new graph."""
    delta.validate_for(g)
    t = delta.touched
    if not len(t) or g.n_dyads == 0:
        return (np.zeros(0, dtype=np.int32),) * 2
    nbr_ptr, nbr_idx = g.host.nbr_ptr, g.host.nbr_idx
    starts, ends = nbr_ptr[t], nbr_ptr[t + 1]
    deg = ends - starts
    total = int(deg.sum())
    if total == 0:
        return (np.zeros(0, dtype=np.int32),) * 2
    # multi-row CSR gather: position r of the concatenation maps to
    # starts[row(r)] + (r - cum_deg[row(r)])
    rows = np.repeat(t, deg)
    offs = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
    cols = nbr_idx[np.repeat(starts, deg) + offs]
    u = np.minimum(rows, cols)
    v = np.maximum(rows, cols)
    key = np.unique(u * np.int64(g.n) + v)  # canonicalize + dedup, sorted
    return ((key // g.n).astype(np.int32), (key % g.n).astype(np.int32))


def apply_delta_csr(g: CSRGraph, delta: GraphDelta) -> CSRGraph:
    """The mutated graph: ``g``'s arcs minus ``edges_removed`` plus
    ``edges_added``, rebuilt through :func:`~repro_torch.core.graph.
    from_edges` (so it equals a graph built from the mutated arc list),
    on ``g``'s device, with ``g``'s vertex count."""
    delta.validate_for(g)
    src, dst = arcs_host(g)
    if len(delta.edges_removed):
        key = src * np.int64(g.n) + dst
        rem = (delta.edges_removed[:, 0] * np.int64(g.n)
               + delta.edges_removed[:, 1])
        keep = ~np.isin(key, rem)
        src, dst = src[keep], dst[keep]
    if len(delta.edges_added):
        src = np.concatenate([src, delta.edges_added[:, 0]])
        dst = np.concatenate([dst, delta.edges_added[:, 1]])
    return from_edges(g.n, src, dst, directed=True, device=g.device)
