"""Deterministic fault injection for the execution and serving layers.

Counterpart of :mod:`repro.engine.faults`.  A :class:`FaultPlan` is a
frozen, hashable description of which faults fire where; every decision
is a pure function of the plan's seed and the dispatch coordinates
(chunk start offset, attempt number, pool slot, dispatch ordinal), so a
run replayed under the same plan injects exactly the same faults, and
:func:`_hash01` gives the JAX package's floats bit for bit, so one seed
injects the same faults in both packages.

Faults are threaded through two hooks:

  * ``EngineConfig(fault_plan=FaultPlan(...))`` — per-plan injection (the
    plan is part of the plan-cache key, so faulty and clean plans never
    share state);
  * the ``REPRO_TORCH_FAULT_PLAN`` environment variable — a JSON object
    of :class:`FaultPlan` fields applied to every config whose own
    ``fault_plan`` is ``None``; an explicit inert ``FaultPlan()`` opts
    out.  The port reads its own variable, so a standing plan for the JAX
    package (``REPRO_FAULT_PLAN``, backend names ``pallas``/``xla``) never
    meets the port's backend-name validation.

Poison graphs are the one injection not keyed by coordinates:
:func:`poison` marks a live :class:`~repro_torch.core.graph.CSRGraph`
object so that any run or batch containing it raises
:class:`InjectedFault`.  The registry holds weak references, so a
poisoned graph un-poisons itself when collected.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import weakref
from typing import Optional, Tuple

__all__ = ["DeviceLostError", "ENV_VAR", "FaultPlan", "InjectedFault",
           "check_poisoned", "fault_plan_from_env", "is_poisoned", "poison",
           "resolve_faults", "unpoison"]

_BACKENDS = ("tiles", "search", "distributed")
ENV_VAR = "REPRO_TORCH_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """A failure raised by the fault-injection harness, never by the
    hardware.  A plain ``RuntimeError`` subclass, so recovery code cannot
    treat injected faults apart from real ones."""


class DeviceLostError(InjectedFault):
    """An injected *permanent* loss of a pool device: every dispatch on it
    raises.  The executor quarantines the device (its queued work goes to
    the survivors) instead of retrying in place."""


def _hash01(seed: int, *coords) -> float:
    """Deterministic uniform [0, 1) from (seed, coordinates): a pure
    counter-based hash, so fault decisions consume no RNG state."""
    payload = repr((int(seed),) + coords).encode()
    digest = hashlib.blake2b(payload, digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic schedule of injected faults.  The default
    plan is **inert**: no fault ever fires.

    Attributes:
        seed: hash seed — same seed, same coordinates, same faults.
        chunk_failure_rate: probability (per chunk, from ``hash(seed,
            chunk start)``) that a chunk's dispatch raises
            :class:`InjectedFault` on its first ``fail_attempts`` attempts.
        fail_attempts: consecutive failing attempts of a selected chunk;
            at or above ``EngineConfig.max_attempts`` it exhausts retry.
        device_loss: executor pool slots that die
            (:class:`DeviceLostError` on every dispatch at or past
            ``device_loss_after``).  The static schedule's one slot is 0;
            the ladder's static fallback rung runs with device loss
            suppressed (a fresh device).
        device_loss_after: per-slot dispatch ordinal from which a
            ``device_loss`` slot is dead (0 = dead on arrival).
        compile_failure: backends (``"tiles"``, ``"search"``,
            ``"distributed"``) whose chunk unit fails to build at plan
            construction (the distributed backend has no rung: it
            raises).
        runtime_failure: backends where **every** chunk dispatch raises.
        mutate_failure_calls: 0-based ordinals of a plan's
            ``apply_delta`` applications that raise mid-mutate.
        slow_chunk_rate: probability (per chunk) that a dispatch sleeps
            ``slow_s`` seconds first; it changes interleavings, never
            results.
        slow_s: the injected delay in seconds.
    """

    seed: int = 0
    chunk_failure_rate: float = 0.0
    fail_attempts: int = 1
    device_loss: Tuple[int, ...] = ()
    device_loss_after: int = 0
    compile_failure: Tuple[str, ...] = ()
    runtime_failure: Tuple[str, ...] = ()
    mutate_failure_calls: Tuple[int, ...] = ()
    slow_chunk_rate: float = 0.0
    slow_s: float = 0.001

    def __post_init__(self):
        # list-valued fields become tuples: the plan is a cache-key part
        object.__setattr__(self, "device_loss",
                           tuple(int(d) for d in self.device_loss))
        object.__setattr__(self, "compile_failure",
                           tuple(str(b) for b in self.compile_failure))
        object.__setattr__(self, "runtime_failure",
                           tuple(str(b) for b in self.runtime_failure))
        object.__setattr__(self, "mutate_failure_calls",
                           tuple(int(c) for c in self.mutate_failure_calls))
        for name in ("chunk_failure_rate", "slow_chunk_rate"):
            r = float(getattr(self, name))
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {r}")
            object.__setattr__(self, name, r)
        if self.fail_attempts < 1:
            raise ValueError(
                f"fail_attempts must be >= 1 (got {self.fail_attempts}); a "
                "selected chunk fails that many consecutive attempts")
        if any(d < 0 for d in self.device_loss):
            raise ValueError(f"device_loss indices must be >= 0, got "
                             f"{self.device_loss}")
        if self.device_loss_after < 0:
            raise ValueError("device_loss_after must be >= 0")
        for field in ("compile_failure", "runtime_failure"):
            bad = [b for b in getattr(self, field) if b not in _BACKENDS]
            if bad:
                raise ValueError(f"{field} names unknown backends {bad}; "
                                 f"choose from {_BACKENDS}")
        if any(c < 0 for c in self.mutate_failure_calls):
            raise ValueError("mutate_failure_calls ordinals must be >= 0")
        if float(self.slow_s) < 0:
            raise ValueError("slow_s must be >= 0")
        object.__setattr__(self, "slow_s", float(self.slow_s))

    @property
    def is_inert(self) -> bool:
        """True when no fault can ever fire (the executor then skips every
        injection check)."""
        return (self.chunk_failure_rate == 0.0 and not self.device_loss
                and not self.compile_failure and not self.runtime_failure
                and not self.mutate_failure_calls
                and self.slow_chunk_rate == 0.0)

    # -- decision points: pure functions of seed + coordinates ---------------

    def chunk_fails(self, start: int, attempt: int) -> bool:
        """Does the chunk at dyad offset ``start`` fail this attempt?"""
        return (attempt <= self.fail_attempts
                and _hash01(self.seed, "chunk", int(start))
                < self.chunk_failure_rate)

    def device_lost(self, dev_index: int, ordinal: int) -> bool:
        """Is pool slot ``dev_index`` dead at its ``ordinal``-th dispatch?"""
        return (dev_index in self.device_loss
                and ordinal >= self.device_loss_after)

    def compile_fails(self, backend: str) -> bool:
        """Does building ``backend``'s chunk unit fail?"""
        return backend in self.compile_failure

    def runtime_fails(self, backend: str) -> bool:
        """Does every chunk dispatch on ``backend`` fail?"""
        return backend in self.runtime_failure

    def mutate_fails(self, ordinal: int) -> bool:
        """Does the ``ordinal``-th ``apply_delta`` of a plan fail?"""
        return ordinal in self.mutate_failure_calls

    def maybe_delay(self, start: int) -> None:
        """Sleep ``slow_s`` if the chunk at ``start`` is a selected slow
        chunk."""
        if (self.slow_chunk_rate
                and _hash01(self.seed, "slow", int(start))
                < self.slow_chunk_rate):
            time.sleep(self.slow_s)


_ENV_SENTINEL = object()
_env_plan = _ENV_SENTINEL


def fault_plan_from_env() -> Optional[FaultPlan]:
    """The standing :class:`FaultPlan` of the ``REPRO_TORCH_FAULT_PLAN``
    environment variable (a JSON object of FaultPlan fields), or ``None``
    when it is unset; parsed once per process."""
    global _env_plan
    if _env_plan is _ENV_SENTINEL:
        raw = os.environ.get(ENV_VAR)
        if not raw:
            _env_plan = None
        else:
            try:
                _env_plan = FaultPlan(**json.loads(raw))
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"invalid {ENV_VAR} value {raw!r}: {e}") from e
    return _env_plan


def resolve_faults(fault_plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """The active plan of a config: its own plan when set (``None`` if
    inert — the explicit opt-out), else the environment's.  ``None``
    means no fault can fire."""
    plan = fault_plan if fault_plan is not None else fault_plan_from_env()
    return None if (plan is None or plan.is_inert) else plan


# -- poison graphs (the batch-isolation injection) ---------------------------

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
