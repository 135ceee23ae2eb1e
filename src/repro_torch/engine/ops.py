"""Graph analytics as ops: the GraphOp protocol, the triad census, and the
accumulator layout.

Counterpart of :mod:`repro.engine.ops` for this slice of the port, which
carries one op, ``triad_census``.  A :class:`GraphOp` declares its
per-chunk kernel (``make_batch_fn``), its accumulator width (``bins``) and
its host finalize; :class:`OpLayout` gives each kernel a slice of the
plan's int64 accumulator.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.census import CensusResult, make_census_batch_fn
from ..core.graph import CSRGraph


def _c3(n: int) -> int:
    return n * (n - 1) * (n - 2) // 6 if n >= 3 else 0


class GraphOp:
    """One analytic: per-chunk kernel + host finalize.

    Set ``name`` and ``bins`` (accumulator width); ``kernel_key`` names
    another op whose kernel and slice this one shares.  The batch kernel
    maps ``(graph_arrays, n, u, v, valid, n_cand)`` — a batch of canonical
    dyads, invalid lanes masked, and the host-known ragged candidate count
    (see :mod:`repro_torch.core.census`) — to ``(bins,)`` int64 partial
    counts, additive across batches."""

    name: str = ""
    bins: int = 0
    kernel_key: Optional[str] = None

    def make_batch_fn(self, meta, config) -> Optional[Callable]:
        """The per-chunk device kernel, or ``None``."""
        return None

    def finalize(self, raw: np.ndarray, g: CSRGraph) -> Any:
        """Host-side step from raw int64 bins to the op's result; must give
        the right answer from all-zero ``raw`` when ``g.m == 0``."""
        raise NotImplementedError


class TriadCensusOp(GraphOp):
    """The paper's analytic: the 16-type Batagelj–Mrvar triad census.
    Finalize adds the type-003 closed form (paper line 29)."""

    name = "triad_census"
    bins = 16

    def make_batch_fn(self, meta, config):
        return make_census_batch_fn(meta.member_iters)

    def finalize(self, raw: np.ndarray, g: CSRGraph) -> CensusResult:
        counts = raw.astype(np.int64).copy()
        counts[0] = _c3(g.n) - int(counts.sum())
        return CensusResult(counts=counts)


_OPS: "dict[str, GraphOp]" = {op.name: op for op in (TriadCensusOp(),)}


def get_op(name: str) -> GraphOp:
    """Look up a built-in :class:`GraphOp` by name."""
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"unknown GraphOp {name!r}; available: "
                       f"{tuple(sorted(_OPS))}") from None


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


class OpLayout:
    """Accumulator layout + fused batch kernel for one plan's ops.

    Ops are deduplicated by ``kernel_key``; each kernel owns a contiguous
    slice of the ``(total_bins,)`` accumulator."""

    def __init__(self, ops, meta, config):
        self.ops = tuple(ops)
        owners: dict = {}
        for op in self.ops:
            owners.setdefault(op.kernel_key or op.name, op)
        self.keys = list(owners)
        self.bins = tuple(owners[k].bins for k in self.keys)
        edges = np.concatenate([[0], np.cumsum(self.bins)]).astype(int)
        self.slices = {k: slice(int(edges[i]), int(edges[i + 1]))
                       for i, k in enumerate(self.keys)}
        self.total_bins = int(edges[-1])
        self._batch_fns = [owners[k].make_batch_fn(meta, config)
                           for k in self.keys]

    def batch_kernel(self):
        """Fused per-batch kernel ``(arrays, n, u, v, valid, n_cand) ->
        (total_bins,)`` int64."""
        fns, bins = self._batch_fns, self.bins

        def fused(arrays, n, u, v, valid, n_cand):
            parts = [f(arrays, n, u, v, valid, n_cand) if f is not None
                     else torch.zeros(b, dtype=torch.int64, device=u.device)
                     for f, b in zip(fns, bins)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        return fused

    def finalize(self, raw, g: CSRGraph) -> dict:
        """Per-op results from the fused raw bins: ``{op.name: result}``."""
        raw = np.asarray(raw, dtype=np.int64)
        return {op.name:
                op.finalize(raw[self.slices[op.kernel_key or op.name]], g)
                for op in self.ops}
