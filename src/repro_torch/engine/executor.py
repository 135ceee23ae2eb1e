"""Chunk dispatch over a device pool: the static and dynamic schedules,
bounded retry, quarantine and the dynamic→static rung.

Counterpart of :mod:`repro.engine.executor`.  The paper credits its multicore
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
``stats["host_syncs"]``.  While a profiler records, a pass's chunk loop
is the ``census.dispatch`` span and each chunk ``census.chunk``
(:mod:`repro_torch.core.spans`); the in-order loop reads that once a
pass and otherwise runs without a span.

The partitioned engine (:mod:`repro_torch.engine.partition`) drives two
more entry points with contexts it stages itself: :meth:`Executor.
run_pinned` (one shard's tasks in order on the primary slot, the
``"serial"`` mode) and :meth:`Executor.run_sharded` (every shard's tasks
over the pool at once, each shard homed on one slot, the ``"pool"``
mode).  There one int64 accumulator per slot replaces the JAX package's
per-(device, shard) hi/lo lanes: integer addition is exact, so the merged
bins are the same for any homing or re-homing.

Backpressure (:func:`_throttle`): after each chunk a worker records a CUDA
event and, once more than ``pipeline_depth`` chunks are in flight on its
device, waits on the oldest — one window per worker.

On the distributed backend the pool is one slot, the rank's device (the
mesh owns the devices), and every retry happens inside the rank's share
of a run, before the merge over the mesh: a retried chunk cannot put the
ranks out of step, and a chunk that exhausts its retries fails the run
on every rank (:func:`repro_torch.core.distributed.merge_over_mesh`).

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
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import spans
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
    with spans.span(spans.FETCH):
        return acc.cpu().numpy().astype(np.int64)


def _throttle(window: collections.deque, device: torch.device,
              depth: int, traced: bool = False) -> None:
    """Allow at most ``depth`` chunks in flight on ``device`` (CPU ops run
    synchronously and need no window); a wait on a full window is the
    ``census.wait`` span when ``traced``."""
    if device.type != "cuda":
        return
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    window.append(event)
    if len(window) <= depth:
        return
    if traced:
        with spans.recording(spans.WAIT):
            window.popleft().synchronize()
    else:
        window.popleft().synchronize()


def _on(device: torch.device):
    """Make ``device`` current for the torch ops of a worker."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two pool slots are one device (``cuda`` and ``cuda:0`` are
    the same card when 0 is current)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return ((a.index if a.index is not None else cur())
            == (b.index if b.index is not None else cur()))


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
        with spans.span(spans.DISPATCH):
            return self._run(list(tasks), place, step, init)

    def _run(self, tasks, place, step, init) -> torch.Tensor:
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
        with _on(self.devices[0]):
            ctx = place(self.devices[0])
        self._run_pinned_once(tasks, ctx, step, acc)

    # -- pinned: in-order dispatch of a context staged by the caller --------

    def _run_pinned_once(self, tasks, ctx, step, acc) -> None:
        if spans.enabled():
            return self._run_pinned_traced(tasks, ctx, step, acc)
        dev = self.devices[0]
        window: collections.deque = collections.deque()
        with _on(dev):
            for ordinal, t in enumerate(tasks):
                acc.add_(self._attempt(ctx, t, step, 0, ordinal))
                # chunk and occupancy counters move together, so
                # sum(device_chunks) == chunks holds after any failure
                self.stats["chunks"] += 1
                self._bump(0, 1)
                _throttle(window, dev, self.depth)

    def _run_pinned_traced(self, tasks, ctx, step, acc) -> None:
        """:meth:`_run_pinned_once` with each chunk's spans, while a
        profiler records."""
        dev = self.devices[0]
        window: collections.deque = collections.deque()
        with _on(dev):
            for ordinal, t in enumerate(tasks):
                with spans.recording(spans.CHUNK):
                    part = self._attempt(ctx, t, step, 0, ordinal)
                    with spans.recording(spans.FOLD):
                        acc.add_(part)
                    self.stats["chunks"] += 1
                    self._bump(0, 1)
                    _throttle(window, dev, self.depth, traced=True)

    def run_pinned(self, tasks, *, ctx, step, init: torch.Tensor,
                   rebuild=None) -> torch.Tensor:
        """Run ``tasks`` in order on the primary slot over ``ctx``, a
        context the caller staged there once (the ``"serial"`` partition
        mode: one shard resident at a time), adding into ``init``; returns
        ``init``.  Bounded retry per chunk as on the static path.  A lost
        primary device under ``schedule_fallback`` re-runs the tasks with
        device-loss injection suppressed (a fresh device), over
        ``rebuild()`` when given, from ``init`` untouched: the first try
        folded into a scratch accumulator."""
        with spans.span(spans.DISPATCH):
            return self._run_pinned(list(tasks), ctx, step, init, rebuild)

    def _run_pinned(self, tasks, ctx, step, init, rebuild) -> torch.Tensor:
        if not (self.schedule_fallback and self.faults is not None
                and self.faults.device_loss):
            self._run_pinned_once(tasks, ctx, step, init)
            return init
        work = torch.zeros_like(init)
        try:
            self._run_pinned_once(tasks, ctx, step, work)
        except ChunkRetryError as e:
            if not isinstance(e.__cause__, DeviceLostError):
                raise
            self._note("schedule_fallback", "pinned-rerun",
                       schedule_fallbacks=1)
            self._suppress_device_loss = True
            try:
                self._run_pinned_once(
                    tasks, ctx if rebuild is None else rebuild(), step, init)
            finally:
                self._suppress_device_loss = False
            return init
        return init.add_(work)

    # -- sharded: every shard's tasks over the pool at once -------------------

    def run_sharded(self, shard_tasks, *, place, step, init: torch.Tensor,
                    pstats: dict) -> torch.Tensor:
        """Concurrent shard residency (the ``"pool"`` partition mode):
        drive EVERY shard's tasks through the pool at once, adding into
        ``init``; returns ``init``.

        ``shard_tasks`` is ``[(shard_id, [ChunkTask, ...]), ...]``; shard
        ``k`` is homed on slot ``k % width`` and ``place(shard_id,
        device)`` gives its context there (the caller stages each shard
        once and hands back the resident context).  Each slot's worker
        runs its shards' tasks interleaved, folding into its own
        accumulator; the accumulators merge into ``init`` after join.
        Faults as on the workqueue: a failed chunk retries on its home
        slot; a lost or quarantined slot **re-homes its shards onto
        survivors** (their queued tasks move and the new home places the
        context on first touch; ``pstats["rehomes"]`` counts the moves);
        an exhausted pool under ``schedule_fallback`` re-runs every shard
        in order on the primary slot into the untouched ``init``.  Per-
        shard wall-clock intervals land in ``pstats["shard_times"]``."""
        shard_tasks = [(s, list(ts)) for s, ts in shard_tasks]
        with spans.span(spans.DISPATCH):
            return self._run_sharded(shard_tasks, place, step, init, pstats)

    def _run_sharded(self, shard_tasks, place, step, init,
                     pstats) -> torch.Tensor:
        try:
            self._run_sharded_queue(shard_tasks, place, step, init, pstats)
        except PoolExhaustedError:
            if not self.schedule_fallback:
                raise
            self._note("schedule_fallback", "dynamic->static",
                       schedule_fallbacks=1)
            self._suppress_device_loss = True
            try:
                for s, ts in shard_tasks:
                    self._run_pinned_once(ts, place(s, self.devices[0]),
                                          step, init)
            finally:
                self._suppress_device_loss = False
        return init

    def _run_sharded_queue(self, shard_tasks, place, step, init,
                           pstats) -> None:
        t_base = time.perf_counter()
        times = pstats.setdefault("shard_times", {})
        if len(self.devices) == 1:
            # one slot: the shards in order on it, one placement each
            for s, ts in shard_tasks:
                ctx = place(s, self.devices[0])
                start = time.perf_counter() - t_base
                self._run_pinned(ts, ctx, step, init,
                                 lambda s=s: place(s, self.devices[0]))
                times[s] = dict(start=start, end=time.perf_counter() - t_base,
                                tasks=len(ts), device=0)
            return
        n = len(self.devices)
        home: dict = {}
        queues = [collections.deque() for _ in range(n)]
        by_slot: list = [[] for _ in range(n)]
        for k, (s, ts) in enumerate(shard_tasks):
            home[s] = k % n
            by_slot[k % n].append((s, ts))
        for i, lst in enumerate(by_slot):
            # a slot's shards advance together, task by task
            longest = max((len(ts) for _, ts in lst), default=0)
            for j in range(longest):
                queues[i].extend((s, ts[j], 1) for s, ts in lst
                                 if j < len(ts))
        cond = threading.Condition()
        ctxs: dict = {}  # shard -> (slot, context on that slot)
        accs: list = [None] * n
        counts = [0] * n
        fatal: list = []
        alive = set(range(n))
        failures = [0] * n
        seen: list = []
        tried: dict = {}
        first: dict = {}
        last: dict = {}
        # tasks not folded yet: a worker with an empty queue waits while
        # any remain, since a re-home may hand it work
        pending = [sum(len(ts) for _, ts in shard_tasks)]

        def rehome(i: int) -> None:  # callers hold cond
            moved, queues[i] = queues[i], collections.deque()
            if not alive:
                if moved and not fatal:
                    fatal.append(PoolExhaustedError(
                        f"all {n} pool devices lost or quarantined with "
                        f"{len(moved)} task(s) remaining", attempts=seen))
                cond.notify_all()
                return
            survivors = sorted(alive)
            assigned: dict = {}
            for s, t, a in moved:
                j = assigned.get(s)
                if j is None:
                    j = survivors[len(assigned) % len(survivors)]
                    assigned[s] = home[s] = j
                    pstats["rehomes"] = pstats.get("rehomes", 0) + 1
                    self._note("shard_rehome", s, i, j)
                queues[j].append((s, t, a))
            cond.notify_all()

        def quarantine(i: int, reason: str) -> None:  # callers hold cond
            alive.discard(i)
            self._note("quarantine", i, reason, quarantines=1)
            rehome(i)

        def on_failure(i, s, t, attempt, e) -> None:  # callers hold cond
            if not _retryable(e):
                fatal.append(e)
                cond.notify_all()
                return
            seen.append(e)
            tried.setdefault((s, t), []).append(e)
            if isinstance(e, DeviceLostError):
                queues[i].appendleft((s, t, attempt))  # the chunk is fine
                quarantine(i, "device_loss")
                return
            failures[i] += 1
            if attempt >= self.max_attempts:
                err = ChunkRetryError(
                    f"chunk [{t.start}, {t.end}) of shard {s} failed after "
                    f"{attempt} attempt(s)", attempts=tried[(s, t)])
                err.__cause__ = e
                fatal.append(err)
                cond.notify_all()
                return
            self._note("retry", t.start, attempt, retries=1)
            queues[i].append((s, t, attempt + 1))
            if failures[i] >= self.QUARANTINE_AFTER and len(alive) > 1:
                quarantine(i, "repeated_failures")
            cond.notify_all()

        def worker(i: int, dev: torch.device) -> None:
            mine: set = set()
            try:
                with _on(dev):
                    accs[i] = acc = torch.zeros_like(init, device=dev)
                    window: collections.deque = collections.deque()
                    ordinal = 0
                    while True:
                        with cond:
                            while (not fatal and i in alive and not queues[i]
                                   and pending[0] > 0):
                                cond.wait(0.05)
                            if fatal or i not in alive or not queues[i]:
                                break
                            s, t, attempt = queues[i].popleft()
                            hit = ctxs.get(s)
                            first.setdefault(s, time.perf_counter() - t_base)
                        if hit is not None and hit[0] == i:
                            ctx = hit[1]
                        else:
                            try:
                                ctx = place(s, dev)
                            except Exception as e:  # noqa: BLE001 — a
                                # slot that cannot hold the shard is out
                                with cond:
                                    seen.append(e)
                                    queues[i].appendleft((s, t, attempt))
                                    quarantine(i, "placement_failure")
                                break
                            with cond:
                                ctxs[s] = (i, ctx)
                        with spans.span(spans.CHUNK):
                            try:
                                part = self._dispatch(ctx, t, step, i,
                                                      ordinal, attempt)
                            except Exception as e:  # noqa: BLE001
                                ordinal += 1
                                with cond:
                                    on_failure(i, s, t, attempt, e)
                                continue
                            ordinal += 1
                            acc.add_(part)
                            mine.add(s)
                            counts[i] += 1
                            with cond:
                                pending[0] -= 1
                                if pending[0] <= 0:
                                    cond.notify_all()
                            _throttle(window, dev, self.depth)
            except BaseException as e:  # noqa: BLE001 — see _run_workqueue
                with cond:
                    fatal.append(e)
                    cond.notify_all()
            finally:
                # the end times record finished device work, not dispatch
                try:
                    _sync(dev)
                except Exception:  # noqa: BLE001 — timing only
                    pass
                with cond:
                    for s in mine:
                        last[s] = max(last.get(s, 0.0),
                                      time.perf_counter() - t_base)

        threads = [threading.Thread(target=worker, args=(i, d), daemon=True)
                   for i, d in enumerate(self.devices)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if fatal:
            dead = [e for e in fatal if isinstance(e, PoolExhaustedError)]
            if dead:
                raise dead[0]
            _raise_worker_errors(fatal)
        self.stats["chunks"] += sum(len(ts) for _, ts in shard_tasks)
        for i, c in enumerate(counts):
            if c:
                self._bump(i, c)
        for s, ts in shard_tasks:
            if s in first:
                times[s] = dict(start=first[s],
                                end=max(last.get(s, first[s]), first[s]),
                                tasks=len(ts), device=home[s])
        for acc in accs:
            if acc is not None:
                init.add_(acc.to(init.device))

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
                        with spans.span(spans.CHUNK):
                            try:
                                part = self._dispatch(ctx, t, step, i,
                                                      ordinal, attempt)
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
