"""Locality-aware vertex reordering: relabel vertices so that neighbours
get nearby ids.

Counterpart of :mod:`repro.core.reorder` (pure host numpy, deterministic:
stable sorts, id tie-breaks, no RNG), over the port's
:class:`~repro_torch.core.graph.CSRGraph`.  The census reads the CSR rows
of essentially random vertices; packing topological neighbours into a
narrow id range turns those reads into near-sequential ones.

* :func:`compute_permutation` — ``"degree"`` (hubs first), ``"bfs"``
  (Gorder-style frontier order: each BFS level contiguous, hubs first
  within a level) or ``"rcm"`` (reverse Cuthill–McKee);
* :func:`permute_graph` — the relabeled graph, rebuilt through
  :func:`~repro_torch.core.graph.from_edges` so it keeps every canonical
  invariant and the same metadata bucket;
* :func:`locality_score` — mean ``|u - v|`` over adjacency entries.

Permutations follow ``perm[old_id] = new_id``.  The engine
(:mod:`repro_torch.engine.plan`) memoizes one permutation per (plan,
graph), runs on the relabeled graph and maps raw bins back through the
inverse permutation (``GraphOp.unpermute_raw``).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .graph import CSRGraph, arcs_host, from_edges

__all__ = ["REORDER_STRATEGIES", "compute_permutation",
           "inverse_permutation", "locality_score", "permute_graph"]

# strategies that relabel; the engine's knob adds "none"
REORDER_STRATEGIES = ("degree", "bfs", "rcm")


def _nbr_csr(g: CSRGraph):
    """Host undirected-neighbourhood CSR and degrees, int64."""
    nbr_ptr = g.host.nbr_ptr[: g.n + 1].astype(np.int64)
    nbr_idx = g.host.nbr_idx[: g.m_nbr].astype(np.int64)
    return nbr_ptr, nbr_idx, np.diff(nbr_ptr)


def _degree_order(g: CSRGraph) -> np.ndarray:
    """New-id -> old-id order: descending degree, ties by id."""
    _, _, deg = _nbr_csr(g)
    return np.lexsort((np.arange(g.n, dtype=np.int64), -deg))


def _bfs_order(g: CSRGraph) -> np.ndarray:
    """BFS from the highest-degree unvisited vertex, each level laid out
    contiguously with hubs first; restarts per connected component
    (isolated vertices sort last and seed trivial components)."""
    nbr_ptr, nbr_idx, deg = _nbr_csr(g)
    n = g.n
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    seeds = np.lexsort((np.arange(n, dtype=np.int64), -deg))
    si = 0
    while pos < n:
        while si < n and visited[seeds[si]]:
            si += 1
        root = seeds[si]
        visited[root] = True
        order[pos] = root
        pos += 1
        frontier = np.array([root], dtype=np.int64)
        while frontier.size:
            starts, counts = nbr_ptr[frontier], deg[frontier]
            total = int(counts.sum())
            if not total:
                break
            offs = (np.arange(total, dtype=np.int64)
                    - np.repeat(np.cumsum(counts) - counts, counts))
            nxt = np.unique(nbr_idx[np.repeat(starts, counts) + offs])
            nxt = nxt[~visited[nxt]]
            if not nxt.size:
                break
            nxt = nxt[np.lexsort((nxt, -deg[nxt]))]  # hubs first in level
            visited[nxt] = True
            order[pos: pos + nxt.size] = nxt
            pos += nxt.size
            frontier = nxt
    return order


def _rcm_order(g: CSRGraph) -> np.ndarray:
    """Reverse Cuthill–McKee: per component, breadth-first from a
    minimum-degree seed with neighbours enqueued by increasing degree,
    then the whole order reversed; ties break by vertex id."""
    nbr_ptr, nbr_idx, deg = _nbr_csr(g)
    n = g.n
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    seeds = np.lexsort((np.arange(n, dtype=np.int64), deg))
    si = 0
    queue: deque = deque()
    while pos < n:
        while si < n and visited[seeds[si]]:
            si += 1
        root = int(seeds[si])
        visited[root] = True
        queue.append(root)
        while queue:
            u = queue.popleft()
            order[pos] = u
            pos += 1
            nb = nbr_idx[nbr_ptr[u]: nbr_ptr[u + 1]]
            nb = nb[~visited[nb]]
            if nb.size:
                nb = nb[np.lexsort((nb, deg[nb]))]  # increasing degree
                visited[nb] = True
                queue.extend(int(w) for w in nb)
    return order[::-1].copy()


_ORDERS = {"degree": _degree_order, "bfs": _bfs_order, "rcm": _rcm_order}


def compute_permutation(g: CSRGraph, strategy: str) -> np.ndarray:
    """The relabeling ``perm[old_id] = new_id`` for one strategy; the same
    graph and strategy always give the same permutation."""
    if strategy not in _ORDERS:
        raise ValueError(
            f"unknown reorder strategy {strategy!r}: expected one of "
            f"{REORDER_STRATEGIES}")
    return inverse_permutation(_ORDERS[strategy](g))


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """The inverse relabeling: ``inv[perm[i]] == i`` for all ``i``."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return inv


def permute_graph(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """``g`` with vertex ``i`` relabeled to ``perm[i]``: an isomorphic
    graph rebuilt through :func:`from_edges` on ``g``'s device, with the
    same counts and degree maxima (hence the same plan bucket)."""
    perm = np.asarray(perm, dtype=np.int64)
    if perm.shape != (g.n,):
        raise ValueError(f"permutation must have shape ({g.n},), got "
                         f"{perm.shape}")
    src, dst = arcs_host(g)
    g_p = from_edges(g.n, perm[src], perm[dst], directed=True,
                     device=g.device)
    if (g_p.m, g_p.m_nbr, g_p.max_deg, g_p.max_out_deg) != (
            g.m, g.m_nbr, g.max_deg, g.max_out_deg):
        raise ValueError("permutation is not a bijection of the vertices")
    return g_p


def locality_score(g: CSRGraph) -> float:
    """Mean ``|u - v|`` over undirected adjacency entries (lower = more
    cache-local; 0.0 for an edgeless graph)."""
    if g.m_nbr == 0:
        return 0.0
    _, nbr_idx, deg = _nbr_csr(g)
    rows = np.repeat(np.arange(g.n, dtype=np.int64), deg)
    return float(np.abs(rows - nbr_idx).mean())
