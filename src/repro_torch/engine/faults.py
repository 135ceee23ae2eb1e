"""Poison graphs: the one fault injection the census service's member-wise
batch isolation needs.

Counterpart of the poison helpers of :mod:`repro.engine.faults`
(``FaultPlan`` and the coordinate-keyed injections come with the
executor's retry machinery).  :func:`poison` marks a live
:class:`~repro_torch.core.graph.CSRGraph` object so that any run or batch
containing it raises :class:`InjectedFault`.  The registry holds weak
references, so a poisoned graph un-poisons itself when collected.
"""
from __future__ import annotations

import weakref

__all__ = ["InjectedFault", "check_poisoned", "is_poisoned", "poison",
           "unpoison"]


class InjectedFault(RuntimeError):
    """A failure raised by the fault-injection harness, never by the
    hardware.  A plain ``RuntimeError`` subclass, so recovery code cannot
    treat injected faults apart from real ones."""


# id -> weakref: graphs are weak-referenceable but not hashable (eq=False
# dataclasses hash by identity, but the id key keeps the registry free of
# strong references).  Lookups check identity, and the ref's callback
# drops the entry, so a recycled id never marks another object.
_POISONED: dict = {}


def poison(graph) -> None:
    """Mark a live graph object as poisoned: any plan run or batch
    containing it raises :class:`InjectedFault`."""
    key = id(graph)
    _POISONED[key] = weakref.ref(graph,
                                 lambda _r, _k=key: _POISONED.pop(_k, None))


def unpoison(graph) -> None:
    """Remove a graph from the poison registry (no-op if absent)."""
    _POISONED.pop(id(graph), None)


def is_poisoned(graph) -> bool:
    """Is this graph object currently poisoned?  Identity-based: an equal
    copy is not."""
    ref = _POISONED.get(id(graph))
    return ref is not None and ref() is graph


def check_poisoned(graph) -> None:
    """Raise :class:`InjectedFault` if ``graph`` is poisoned (called by the
    plan's run paths on every admitted graph)."""
    if _POISONED and is_poisoned(graph):
        raise InjectedFault(
            f"injected poison graph (n={getattr(graph, 'n', '?')}, "
            f"m={getattr(graph, 'm', '?')}) — this request must fail "
            "without taking down its batch peers")
