"""Chunk dispatch over a device pool: the static and dynamic schedules,
bounded retry, quarantine and the dynamic→static rung.

Counterpart of :mod:`repro.engine.executor` (``run_pinned`` and
``run_sharded`` come with partitions).  The paper credits its multicore
speedups to OpenMP dynamic scheduling of degree-skewed dyad work; an
:class:`Executor` is that policy over torch devices:

  * ``schedule="static"``: the chunk tasks run in order on the plan's
    device;
  * ``schedule="dynamic"``: one worker thread per pool slot pulls the next
    task from a shared queue (tasks carved by the cost model of
    :mod:`repro_torch.core.balance`), so a slot stuck on a heavy chunk
    simply pulls fewer.  On ``"cuda"`` a slot is a device; on ``"cpu"``
    the slots are worker threads on the one CPU device.

The protocol is ``run(tasks, place=, step=, init=)``: ``place(device)``
gives a worker its context (the graph arrays and dyad stream on its
device; on the plan's own device it copies nothing), and ``step(ctx,
task)`` returns the task's whole ``(total_bins,)`` int64 contribution,
which the executor adds into an accumulator with one ``add_`` only after
the attempt succeeded — so a failed attempt folds nothing and a retried
chunk folds exactly once.  The static path adds into ``init`` itself;
each dynamic worker adds into its own accumulator on its device, and the
pool merges them into ``init`` on the primary device after every worker
joined (exact integer addition, for any task assignment).
:func:`_acc_fetch` is the run's one device→host copy, counted in
``stats["host_syncs"]``.

Backpressure (:func:`_throttle`): after each chunk a worker records a CUDA
event and, once more than ``pipeline_depth`` chunks are in flight on its
device, waits on the oldest — one window per worker.

**Faults.**  Every dispatch has ``EngineConfig.max_attempts`` attempts.
On the dynamic schedule a failed task is re-queued onto any surviving
slot; a slot that raises :class:`~repro_torch.engine.faults.DeviceLostError`
or fails :data:`Executor.QUARANTINE_AFTER` dispatches leaves the pool
(its accumulator, holding only successful folds, still merges).  A pool
with every slot gone raises :class:`PoolExhaustedError`, which becomes
the ``dynamic -> static`` rung under ``schedule_fallback``.  Recoveries
land in ``stats["faults"]`` and a bounded ``stats["fault_events"]``
trace.  Only a ``RuntimeError`` raised at dispatch — a launch's return
code, an injected fault — is retried (:func:`_retryable`).  Never
recovered here: a :class:`~repro_torch.kernels._build.KernelBuildError`
or any other exception type (a wrong argument is not cured by a retry),
both re-raised at once; and an asynchronous CUDA fault, which surfaces
at a :func:`_throttle` wait or at :func:`_acc_fetch`, outside any
attempt, and fails the run.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels._build import KernelBuildError
from .faults import DeviceLostError, InjectedFault, resolve_faults

#: cap on the per-plan fault-event trace (a diagnostic, not a log)
_MAX_EVENTS = 512


class ChunkTask(NamedTuple):
    """One span ``[start, end)`` of the dyad stream, its predicted work,
    and a static per-task key: the bucket width ``K`` on the tiles
    backend, the ragged candidate count on the search backend."""

    start: int
    end: int
    cost: float = 0.0
    key: Optional[int] = None


class WorkerFailures(RuntimeError):
    """The secondary errors of a multi-worker failure, attached as the
    ``__cause__`` of the primary raised error (``.errors`` holds them)."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__(
            f"{len(self.errors)} additional concurrent worker failure(s): "
            + "; ".join(repr(e) for e in self.errors))


class ChunkRetryError(RuntimeError):
    """A chunk failed its whole ``max_attempts`` budget (possibly across
    pool slots).  The last failure is the ``__cause__``; every attempt's
    exception is in ``.attempts``."""

    def __init__(self, message, attempts=()):
        self.attempts = list(attempts)
        super().__init__(message)


class PoolExhaustedError(RuntimeError):
    """Every slot of a dynamic pool was lost or quarantined while tasks
    remained.  With ``EngineConfig.schedule_fallback`` the executor turns
    it into the static single-device re-run.  Every dispatch or placement
    failure of the run is in ``.attempts``."""

    def __init__(self, message, attempts=()):
        self.attempts = attempts
        super().__init__(message)


def injected_only(e: BaseException) -> bool:
    """Whether every failure behind a :class:`ChunkRetryError` or
    :class:`PoolExhaustedError` was injected by the plan's ``FaultPlan``
    (:class:`~repro_torch.engine.faults.InjectedFault`, which includes
    :class:`~repro_torch.engine.faults.DeviceLostError`).  The runtime
    rung of the degradation ladder demotes only then: a real launch
    failure re-raises."""
    causes = list(getattr(e, "attempts", ()))
    if not causes and e.__cause__ is not None:
        causes = [e.__cause__]
    return bool(causes) and all(isinstance(c, InjectedFault) for c in causes)


def _raise_worker_errors(errors):
    """Raise the primary worker error with the others attached as its
    ``__cause__`` (:class:`WorkerFailures`)."""
    primary, rest = errors[0], errors[1:]
    if rest:
        raise primary from WorkerFailures(rest)
    raise primary


def _retryable(e: BaseException) -> bool:
    """A dispatch failure a retry may cure: a runtime error that is not a
    kernel build or load failure."""
    return isinstance(e, RuntimeError) and not isinstance(e, KernelBuildError)


def _acc_fetch(plan, acc: torch.Tensor) -> np.ndarray:
    """THE device→host copy of a run, a batch or a delta correction
    (counted once): ``acc`` is ``(total_bins,)``, or ``(B, total_bins)``
    for a batch of B graphs."""
    plan.stats["host_syncs"] += 1
    return acc.cpu().numpy().astype(np.int64)


def _throttle(window: collections.deque, device: torch.device,
              depth: int) -> None:
    """Allow at most ``depth`` chunks in flight on ``device`` (CPU ops run
    synchronously and need no window)."""
    if device.type != "cuda":
        return
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    window.append(event)
    if len(window) > depth:
        window.popleft().synchronize()


def _on(device: torch.device):
    """Make ``device`` current for the torch ops of a worker."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def pool_devices(primary: torch.device, n: int) -> "list[torch.device]":
    """The pool's ``n`` slots: the plan's device first, then the next CUDA
    devices in order; on the CPU, ``n`` slots of the one CPU device."""
    if primary.type != "cuda" or n == 1:
        return [primary] * n
    count = torch.cuda.device_count()
    base = (primary.index if primary.index is not None
            else torch.cuda.current_device())
    return [primary] + [torch.device("cuda", (base + i) % count)
                        for i in range(1, n)]


class Executor:
    """A device pool and dispatch policy for one plan's chunk tasks, built
    by :class:`repro_torch.engine.plan.Plan` from its config
    (``schedule``, ``max_attempts``, ``schedule_fallback``,
    ``fault_plan``) and the pool :func:`pool_devices` gives.  Dispatch
    counts land in ``stats["device_chunks"]`` (``{slot: chunks}``)."""

    #: generic (non-device-loss) dispatch failures on one slot before it
    #: is quarantined, provided another slot survives
    QUARANTINE_AFTER = 2

    def __init__(self, config, stats: dict, devices, *, backend: str):
        self.schedule = config.schedule
        self.depth = config.pipeline_depth
        self.max_attempts = config.max_attempts
        self.schedule_fallback = config.schedule_fallback
        self.backend = backend
        self.faults = resolve_faults(config.fault_plan)
        self.devices = list(devices)
        self.stats = stats
        self._flock = threading.Lock()
        self._suppress_device_loss = False

    @property
    def n_devices(self) -> int:
        """Pool width (1 = in-order dispatch on the plan's device)."""
        return len(self.devices)

    def _bump(self, dev_index: int, count: int) -> None:
        dc = self.stats["device_chunks"]
        dc[dev_index] = dc.get(dev_index, 0) + count

    def _note(self, *event, **counters) -> None:
        """Record fault counters and one trace event under the lock."""
        with self._flock:
            fs = self.stats["faults"]
            for k, v in counters.items():
                fs[k] += v
            trace = self.stats["fault_events"]
            if event and len(trace) < _MAX_EVENTS:
                trace.append(event)

    # -- one dispatch, with the plan's injected faults ------------------------

    def _dispatch(self, ctx, task, step, dev_index, ordinal, attempt):
        f = self.faults
        if f is not None:
            if (not self._suppress_device_loss
                    and f.device_lost(dev_index, ordinal)):
                self._note("device_loss", dev_index, device_losses=1)
                raise DeviceLostError(
                    f"injected loss of pool device {dev_index} at dispatch "
                    f"ordinal {ordinal}")
            if f.runtime_fails(self.backend):
                self._note("runtime_failure", self.backend, task.start,
                           chunk_failures=1)
                raise InjectedFault(
                    f"injected {self.backend} runtime failure for chunk at "
                    f"dyad {task.start}")
            if f.chunk_fails(task.start, attempt):
                self._note("chunk_failure", task.start, attempt,
                           chunk_failures=1)
                raise InjectedFault(
                    f"injected failure for chunk at dyad {task.start} "
                    f"(attempt {attempt})")
            f.maybe_delay(task.start)
        return step(ctx, task)

    def _attempt(self, ctx, task, step, dev_index, ordinal):
        """Bounded-retry dispatch of one task on one slot; returns its
        contribution (nothing is folded until an attempt succeeds)."""
        failures: list = []
        for attempt in range(1, self.max_attempts + 1):
            try:
                return self._dispatch(ctx, task, step, dev_index, ordinal,
                                      attempt)
            except RuntimeError as e:
                if not _retryable(e):
                    raise
                failures.append(e)
                if isinstance(e, DeviceLostError):
                    break  # the device is gone; retrying in place is futile
                if attempt < self.max_attempts:
                    self._note("retry", task.start, attempt, retries=1)
        raise ChunkRetryError(
            f"chunk [{task.start}, {task.end}) failed after "
            f"{len(failures)} attempt(s) on device {dev_index}",
            attempts=failures) from failures[-1]

    def run(self, tasks, *, place, step, init: torch.Tensor) -> torch.Tensor:
        """Run every task and add their contributions into ``init`` (which
        already holds the run's once contribution); returns ``init``."""
        tasks = list(tasks)
        if len(self.devices) > 1:
            try:
                self._run_workqueue(tasks, place, step, init)
            except PoolExhaustedError:
                if not self.schedule_fallback:
                    raise
                self._run_fallback(tasks, place, step, init)
            return init
        if (self.schedule == "dynamic" and self.schedule_fallback
                and self.faults is not None and self.faults.device_loss):
            # a one-slot pool whose only device dies takes the same rung
            # as a wide one: fold into a scratch accumulator, so the
            # rung restarts from ``init`` untouched
            work = torch.zeros_like(init)
            try:
                self._run_inorder(tasks, place, step, work)
            except ChunkRetryError as e:
                if not isinstance(e.__cause__, DeviceLostError):
                    raise
                self._run_fallback(tasks, place, step, init)
                return init
            return init.add_(work)
        self._run_inorder(tasks, place, step, init)
        return init

    def _run_fallback(self, tasks, place, step, init) -> None:
        """The dynamic→static rung: the whole task list in order on the
        primary device, device-loss injection suppressed (a fresh
        device), into the untouched ``init``."""
        self._note("schedule_fallback", "dynamic->static",
                   schedule_fallbacks=1)
        self._suppress_device_loss = True
        try:
            self._run_inorder(tasks, place, step, init)
        finally:
            self._suppress_device_loss = False

    def _run_inorder(self, tasks, place, step, acc) -> None:
        dev = self.devices[0]
        window: collections.deque = collections.deque()
        with _on(dev):
            ctx = place(dev)
            for ordinal, t in enumerate(tasks):
                acc.add_(self._attempt(ctx, t, step, 0, ordinal))
                # chunk and occupancy counters move together, so
                # sum(device_chunks) == chunks holds after any failure
                self.stats["chunks"] += 1
                self._bump(0, 1)
                _throttle(window, dev, self.depth)

    def _run_workqueue(self, tasks, place, step, init) -> None:
        # queue entries are (task, attempt): a failed task re-queues with
        # attempt + 1 for any surviving slot; a task dropped by a lost
        # slot re-queues at the same attempt (the slot was at fault)
        queue: collections.deque = collections.deque((t, 1) for t in tasks)
        qlock = threading.Lock()
        n = len(self.devices)
        accs: list = [None] * n
        counts = [0] * n
        fatal: list = []
        alive = set(range(n))
        failures = [0] * n
        seen: list = []  # every failure of the run, in order
        tried: dict = {}  # task -> its failed attempts

        def quarantine(i: int, reason: str) -> None:  # callers hold qlock
            alive.discard(i)
            self._note("quarantine", i, reason, quarantines=1)
            if not alive and queue and not fatal:
                fatal.append(PoolExhaustedError(
                    f"all {n} pool devices lost or quarantined with "
                    f"{len(queue)} task(s) remaining", attempts=seen))

        def on_failure(i, t, attempt, e) -> None:  # callers hold qlock
            if not _retryable(e):
                fatal.append(e)
                return
            seen.append(e)
            tried.setdefault(t, []).append(e)
            if isinstance(e, DeviceLostError):
                queue.append((t, attempt))
                quarantine(i, "device_loss")
                return
            failures[i] += 1
            if attempt >= self.max_attempts:
                err = ChunkRetryError(
                    f"chunk [{t.start}, {t.end}) failed after {attempt} "
                    "attempt(s) across the device pool", attempts=tried[t])
                err.__cause__ = e
                fatal.append(err)
                return
            self._note("retry", t.start, attempt, retries=1)
            queue.append((t, attempt + 1))
            if failures[i] >= self.QUARANTINE_AFTER and len(alive) > 1:
                quarantine(i, "repeated_failures")

        def worker(i: int, dev: torch.device) -> None:
            acc = None
            try:
                with _on(dev):
                    try:
                        ctx = place(dev)
                        acc = torch.zeros_like(init, device=dev)
                    except Exception as e:  # noqa: BLE001 — a slot
                        # whose context cannot be placed is dead on arrival
                        with qlock:
                            seen.append(e)
                            quarantine(i, "placement_failure")
                        return
                    window: collections.deque = collections.deque()
                    ordinal = 0
                    while True:
                        with qlock:
                            if not queue or fatal or i not in alive:
                                break
                            t, attempt = queue.popleft()
                        try:
                            part = self._dispatch(ctx, t, step, i, ordinal,
                                                  attempt)
                        except Exception as e:  # noqa: BLE001
                            ordinal += 1
                            with qlock:
                                on_failure(i, t, attempt, e)
                            continue
                        ordinal += 1
                        acc.add_(part)
                        counts[i] += 1
                        _throttle(window, dev, self.depth)
            except BaseException as e:  # noqa: BLE001 — any escape must
                # reach the caller: a silently dead worker would drop the
                # chunks it folded and the merged run would under-count
                with qlock:
                    fatal.append(e)
            finally:
                accs[i] = acc

        threads = [threading.Thread(target=worker, args=(i, d), daemon=True)
                   for i, d in enumerate(self.devices)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if fatal:
            # an exhausted pool outranks the rest: run() re-runs everything
            dead = [e for e in fatal if isinstance(e, PoolExhaustedError)]
            if dead:
                raise dead[0]
            _raise_worker_errors(fatal)
        # counters merge after join: exact under any interleaving
        self.stats["chunks"] += len(tasks)
        for i, c in enumerate(counts):
            if c:
                self._bump(i, c)
        for acc in accs:
            if acc is not None:
                init.add_(acc.to(init.device))
