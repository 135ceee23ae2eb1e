"""Incremental delta census: the affected-subset passes and the exact
correction.

Counterpart of :mod:`repro.engine.delta`.  :func:`delta_correction` turns
a :class:`~repro_torch.core.delta.GraphDelta` into the exact int64
correction of a plan's raw bins::

    raw(new) == raw(old) + delta_correction(plan, g_old, g_new, delta)

for every op that keeps the ``delta_local`` contract, on both backends.
It runs the plan's own chunk units, restricted to the affected canonical
dyads (:func:`~repro_torch.core.delta.affected_dyads`): one subset pass
over the old graph's affected dyads and one over the new graph's, each
with its graph's once contributions, into two rows of one accumulator;
their difference (possibly negative) is taken on the device in int64, and
one counted device→host copy fetches it.  An unaffected dyad contributes
the same to both graphs and is never computed.

The entry point is :meth:`repro_torch.engine.Plan.apply_delta`, which adds
the ``EngineConfig.delta_threshold`` cost model and returns a
:class:`DeltaResult`.  Deltas stay in original vertex ids under
``config.reorder``: :func:`run_delta` relabels the delta into the plan's
execution ids, runs both subset passes there and maps the correction
back (``OpLayout.unpermute`` is linear).  On a partitioned plan each
subset pass is :func:`repro_torch.engine.partition.subset_partitioned`:
only the shards owning affected dyads run (``stats["partition"]
["delta_shards"]``), still into one accumulator and one copy.  A
``FaultPlan`` with
``mutate_failure_calls`` makes chosen applications raise mid-mutate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.delta import GraphDelta, affected_dyads, apply_delta_csr
from ..core.graph import CSRGraph
from . import backends
from .faults import InjectedFault, resolve_faults

__all__ = ["DeltaResult", "affected_fraction", "delta_correction",
           "run_delta"]


class DeltaResult(NamedTuple):
    """Outcome of one :meth:`~repro_torch.engine.Plan.apply_delta`.

    ``graph`` is the mutated graph and ``raw`` its int64 bins (pass both
    to the next ``apply_delta``), ``results`` the per-op results for the
    new graph (equal to ``plan.run(graph)``), ``mode`` ``"delta"``
    (affected-subset correction) or ``"full"`` (recompute), and
    ``affected_fraction`` the footprint that decided: affected dyads over
    the larger of the two dyad streams."""

    graph: CSRGraph
    raw: np.ndarray
    results: dict
    mode: str
    affected_fraction: float


def affected_fraction(g_old: CSRGraph, g_new: CSRGraph,
                      n_old: int, n_new: int) -> float:
    """Mutation footprint: affected dyads over the larger dyad stream.  The
    delta pass walks the affected set twice (old and new graph), so its
    break-even against one full pass sits near 0.5."""
    return max(n_old, n_new) / max(g_old.n_dyads, g_new.n_dyads, 1)


def delta_correction(plan, g_old: CSRGraph, g_new: CSRGraph,
                     delta: GraphDelta, *, affected_old=None,
                     affected_new=None) -> np.ndarray:
    """Exact ``raw(g_new) - raw(g_old)`` of the plan's bins from two
    affected-subset passes; one counted device→host copy.  Both graphs
    must pass the plan's admission check.  ``affected_old`` /
    ``affected_new`` take precomputed :func:`affected_dyads` pairs."""
    old = (affected_dyads(g_old, delta) if affected_old is None
           else affected_old)
    new = (affected_dyads(g_new, delta) if affected_new is None
           else affected_new)
    return backends.run_subsets(plan, g_old, old, g_new, new)


def _inject_mutate_failure(plan) -> None:
    """Raise the plan's injected mid-mutate failure for this application,
    if any: keyed on a per-plan attempt counter (not the completed-run
    counters a failed attempt never advances), so a retry of a failed
    ordinal proceeds.  Stateful callers (the service's sessions) roll
    back to their pre-mutation snapshot."""
    fplan = resolve_faults(plan.config.fault_plan)
    if fplan is None:
        return
    ordinal = plan.stats.get("delta_attempts", 0)
    plan.stats["delta_attempts"] = ordinal + 1
    if fplan.mutate_fails(ordinal):
        raise InjectedFault(f"injected mid-mutate failure (delta "
                            f"application #{ordinal})")


def run_delta(plan, g: CSRGraph, delta: GraphDelta,
              raw: "np.ndarray | None") -> DeltaResult:
    """The :meth:`~repro_torch.engine.Plan.apply_delta` implementation:
    the affected-subset correction, or a full recompute when ``raw`` is
    missing, the footprint exceeds ``config.delta_threshold`` or an op
    sets ``delta_local=False``; bumps ``delta_runs`` / ``delta_fulls``.
    An empty delta changes nothing and costs no device work.  Under
    ``config.reorder`` the delta is relabeled with the plan's memoized
    permutation, the relabeled mutated graph is seeded into the memo, and
    the correction maps back to original ids."""
    if delta.is_empty:
        delta.validate_for(g)
        g_new = g
    else:
        g_new = apply_delta_csr(g, delta)
        plan._check(g_new)
    _inject_mutate_failure(plan)
    if delta.is_empty:
        if raw is None:
            raw = plan._execute_raw(g)
            plan.stats["delta_fulls"] += 1
            return DeltaResult(g, raw, plan.layout.finalize(raw, g), "full",
                               0.0)
        plan.stats["delta_runs"] += 1
        return DeltaResult(g, raw, plan.layout.finalize(raw, g), "delta", 0.0)
    g_x, perm = plan._reordered(g)
    if perm is not None:
        delta_x = delta.permuted(perm)
        g_new_x = apply_delta_csr(g_x, delta_x)
        plan._seed_reorder(g_new, g_new_x, perm)
    else:
        delta_x, g_new_x = delta, g_new
    affected_old = affected_dyads(g_x, delta_x)
    affected_new = affected_dyads(g_new_x, delta_x)
    frac = affected_fraction(g_x, g_new_x, len(affected_old[0]),
                             len(affected_new[0]))
    if (raw is not None and frac <= plan.config.delta_threshold
            and all(op.delta_local for op in plan.ops)):
        corr = delta_correction(plan, g_x, g_new_x, delta_x,
                                affected_old=affected_old,
                                affected_new=affected_new)
        if perm is not None:
            corr = plan.layout.unpermute(corr, perm, g_new)
        raw_new = np.asarray(raw, dtype=np.int64) + corr
        plan.stats["delta_runs"] += 1
        mode = "delta"
    else:
        raw_new = plan._execute_raw(g_new)
        plan.stats["delta_fulls"] += 1
        mode = "full"
    return DeltaResult(g_new, raw_new, plan.layout.finalize(raw_new, g_new),
                       mode, frac)
