"""Load balancing for irregular dyad workloads: cost models and packing.

Counterpart of :mod:`repro.core.balance`.  The task is the **canonical
dyad** ``(u, v), u < v``, and its cost the size of its candidate set
under one of the paper's Table 4.8 models:

  * ``canonical_uniform``    — ``|N(u)| + |N(v)| - 2``;
  * ``canonical_nonuniform`` — the exact ``|S| = |N(u) ∪ N(v) \\ {u, v}|``
    (:func:`exact_s_sizes`: torch ops on the graph's device, or the
    paper's sequential host loop);
  * ``vertex`` / ``dyad_uniform`` — weight 1.

:func:`chunk_bounds_by_cost` carves a task stream into contiguous chunks
of roughly equal predicted work — the dynamic schedule of
:mod:`repro_torch.engine.executor` — and :func:`pack_tasks` deals the
dyads into balanced static shards (``greedy_sequential``,
``sorted_snake``, ``greedy_lpt``).  Everything but the device route of
:func:`exact_s_sizes` is host numpy.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np
import torch

from .census import canonical_dyads, make_member_fn
from .graph import CSRGraph, tensor_arrays

__all__ = ["PACKING", "WEIGHTS", "ShardedTasks", "chunk_bounds_by_cost",
           "dyad_weights", "exact_s_sizes", "pack_tasks"]

WEIGHTS = ("vertex", "dyad_uniform", "canonical_uniform",
           "canonical_nonuniform")
PACKING = ("greedy_sequential", "sorted_snake", "greedy_lpt")


@dataclasses.dataclass(frozen=True)
class ShardedTasks:
    """Static per-shard dyad tasks: ``(T, L)`` padded dyad lists, their
    validity mask and each shard's modeled work."""

    u: np.ndarray  # (T, L) int32
    v: np.ndarray  # (T, L) int32
    valid: np.ndarray  # (T, L) bool
    weights: np.ndarray  # (T,) float64 — modeled per-shard work
    strategy: str
    weight_model: str

    @property
    def imbalance(self) -> float:
        """max/mean modeled work — 1.0 is perfect."""
        mean = self.weights.mean()
        return float(self.weights.max() / mean) if mean > 0 else 1.0


def dyad_weights(g: CSRGraph, u: np.ndarray, v: np.ndarray, model: str,
                 batch: int = 1024) -> np.ndarray:
    """Per-dyad cost under ``model`` (paper Table 4.8), float64."""
    if model in ("vertex", "dyad_uniform"):
        return np.ones(len(u), dtype=np.float64)
    if model == "canonical_uniform":
        deg = g.host.nbr_deg
        return (deg[u] + deg[v] - 2).astype(np.float64)
    if model == "canonical_nonuniform":
        return exact_s_sizes(g, u, v, batch=batch).astype(np.float64)
    raise ValueError(f"unknown weight model {model!r}; choose from "
                     f"{WEIGHTS}")


def _s_batch(arrays, uu: torch.Tensor, vv: torch.Tensor, K: int, member):
    """``|S|`` of a batch of dyads: both neighbourhoods as dense ``(B, K)``
    tiles, the other endpoint masked out, and N(v)'s members of N(u)
    dropped by the membership probe."""
    j = torch.arange(K, device=uu.device)
    last = arrays.nbr_idx.shape[0] - 1

    def gather(x):
        pos = arrays.nbr_ptr[x].long()[:, None] + j
        return (arrays.nbr_idx[pos.clamp(0, last)].long(),
                j < arrays.nbr_deg[x].long()[:, None])

    wu, mu = gather(uu)
    wv, mv = gather(vv)
    mu &= wu != vv[:, None]
    mv &= wv != uu[:, None]
    dup = member(arrays.nbr_ptr, arrays.nbr_idx, uu[:, None], wv)
    return mu.sum(1) + (mv & ~dup).sum(1)


def exact_s_sizes(g: CSRGraph, u: np.ndarray, v: np.ndarray,
                  batch: int = 1024, device: bool = True) -> np.ndarray:
    """``|S|`` per dyad, int64.  ``device=True`` runs batches of torch ops
    on the graph's device (the port's member probe); ``device=False`` is
    the paper's sequential host pre-computation."""
    if not device:
        nbr_ptr, nbr_idx = g.host.nbr_ptr, g.host.nbr_idx
        out = np.empty(len(u), dtype=np.int64)
        for i, (a, b) in enumerate(zip(u, v)):
            s = np.union1d(nbr_idx[nbr_ptr[a]: nbr_ptr[a + 1]],
                           nbr_idx[nbr_ptr[b]: nbr_ptr[b + 1]])
            out[i] = len(s) - np.isin([a, b], s).sum()
        return out
    d = len(u)
    if d == 0:
        return np.zeros(0, dtype=np.int64)
    K = max(1, g.max_deg)
    member = make_member_fn(max(1, math.ceil(math.log2(g.max_deg + 1))) + 1)
    pad = (-d) % batch
    uu = np.concatenate([u, np.zeros(pad, np.int64)]).astype(np.int64)
    vv = np.concatenate([v, np.ones(pad, np.int64)]).astype(np.int64)
    dev = g.device
    arrays = tensor_arrays(g.arrays, dev)
    outs = [_s_batch(arrays, torch.from_numpy(uu[i: i + batch]).to(dev),
                     torch.from_numpy(vv[i: i + batch]).to(dev), K, member)
            for i in range(0, len(uu), batch)]
    return torch.cat(outs).cpu().numpy()[:d].astype(np.int64)


def chunk_bounds_by_cost(weights: np.ndarray, capacity: int, *,
                         target: "float | None" = None) -> np.ndarray:
    """Cost-model chunk boundaries over a task stream.

    Splits ``[0, len(weights))`` into contiguous chunks of roughly equal
    *predicted* work, so heavy regions of the stream get **smaller**
    chunks.  ``capacity`` caps every chunk's length; ``target`` is the
    per-chunk cost quota, by default ``total / ceil(D / capacity)`` so the
    chunk count stays near the fixed-size schedule's.  Returns int64
    bounds ``b`` with ``b[0] == 0``, ``b[-1] == D`` and every span in
    ``(0, capacity]``; a task heavier than ``target`` gets its own chunk.
    """
    D = len(weights)
    if D == 0:
        return np.zeros(1, dtype=np.int64)
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    cum = np.concatenate([[0.0], np.cumsum(weights, dtype=np.float64)])
    if target is None:
        target = cum[-1] / max(1, -(-D // capacity))
    target = max(float(target), 1e-12)
    bounds = [0]
    while bounds[-1] < D:
        s = bounds[-1]
        e = int(np.searchsorted(cum, cum[s] + target, side="right")) - 1
        bounds.append(min(max(e, s + 1), s + capacity, D))
    return np.asarray(bounds, dtype=np.int64)


def _pad_shards(shards: "list[np.ndarray]", u, v):
    L = max((len(s) for s in shards), default=1) or 1
    T = len(shards)
    su = np.zeros((T, L), np.int32)
    sv = np.ones((T, L), np.int32)
    mask = np.zeros((T, L), bool)
    for t, s in enumerate(shards):
        su[t, : len(s)] = u[s]
        sv[t, : len(s)] = v[s]
        mask[t, : len(s)] = True
    return su, sv, mask


def pack_tasks(g: CSRGraph, n_shards: int, *,
               weight_model: str = "canonical_uniform",
               strategy: str = "sorted_snake",
               pad_multiple: int = 1) -> ShardedTasks:
    """Partition all canonical dyads into ``n_shards`` balanced shards."""
    u, v = canonical_dyads(g)
    w = dyad_weights(g, u, v, weight_model)
    D = len(u)
    idx = np.arange(D)
    if strategy == "greedy_sequential":
        # the paper's queue fill: natural order until the quota is reached
        quota = w.sum() / n_shards
        shards: list = [[] for _ in range(n_shards)]
        t, acc = 0, 0.0
        for i in idx:
            shards[t].append(i)
            acc += w[i]
            if acc > quota and t + 1 < n_shards:
                t, acc = t + 1, 0.0
        shard_idx = [np.array(s, dtype=np.int64) for s in shards]
    elif strategy == "sorted_snake":
        order = np.argsort(-w, kind="stable")
        pos = np.arange(D)
        r, c = pos // n_shards, pos % n_shards
        col = np.where(r % 2 == 0, c, n_shards - 1 - c)
        shard_of = np.empty(D, dtype=np.int64)
        shard_of[order] = col
        shard_idx = [idx[shard_of == t] for t in range(n_shards)]
    elif strategy == "greedy_lpt":
        order = np.argsort(-w, kind="stable")
        heap = [(0.0, t) for t in range(n_shards)]
        heapq.heapify(heap)
        shards = [[] for _ in range(n_shards)]
        for i in order:
            load, t = heapq.heappop(heap)
            shards[t].append(i)
            heapq.heappush(heap, (load + w[i], t))
        shard_idx = [np.array(s, dtype=np.int64) for s in shards]
    else:
        raise ValueError(f"unknown strategy {strategy!r}; choose from "
                         f"{PACKING}")
    su, sv, mask = _pad_shards(shard_idx, u, v)
    pad = (-su.shape[1]) % pad_multiple if pad_multiple > 1 else 0
    if pad:
        su = np.pad(su, ((0, 0), (0, pad)))
        sv = np.pad(sv, ((0, 0), (0, pad)), constant_values=1)
        mask = np.pad(mask, ((0, 0), (0, pad)))
    loads = np.array([w[s].sum() for s in shard_idx])
    return ShardedTasks(u=su, v=sv, valid=mask, weights=loads,
                        strategy=strategy, weight_model=weight_model)
