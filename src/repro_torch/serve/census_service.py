"""Batched multi-graph, multi-analytic serving (the fleet front door).

Counterpart of :mod:`repro.serve.census_service`.  A
:class:`CensusService` accepts a stream of
:class:`~repro_torch.core.graph.CSRGraph` requests, each naming the
:class:`~repro_torch.engine.GraphOp` analytics it wants, groups them by
(:class:`~repro_torch.engine.GraphMeta` bucket, ops) key, and runs each
group as one batch through ``Plan.run_batch``: every member's chunks add
into its row of one accumulator, and the batch costs one device→host
copy.  That is the workload of triadic analysis over graph collections
(Chin et al., "Scalable Triadic Analysis of Large-Scale Graphs"): many
same-shape graphs and a family of analyses.

Design properties:

  * **Deterministic, clockless batching** — groups flush when they reach
    ``max_batch`` or when ``max_wait_requests`` newer requests have been
    submitted since the group's oldest member (bounded staleness without
    wall-clock timers, so behaviour is exactly reproducible in tests).
    The host clock is read only for :meth:`CensusService.stats`' queue
    wait; no decision reads it.
  * **Out-of-order completion, stable ids** — ``submit`` returns a
    monotonically increasing request id; completions surface in batch
    flush order, each tagged with its id, bucket and ops.
  * **Per-bucket stats** — batches formed, occupancy, host syncs, chunks
    and a per-ops request breakdown.
  * **Admission control, deadlines and member-wise isolation** — a full
    pending queue rejects or flushes (``max_pending``,
    ``reject_policy``), deadlines are counted in flush rounds, and a
    batch that fails (a poisoned member) retries member by member on the
    same plan, so only the bad request completes with an error.

Batches run synchronously inside ``submit``/``flush`` on the caller's
thread, one group after another (the device work itself is still
asynchronous under the engine's bounded in-flight window).  One
exception: under the dynamic executor schedule
(``EngineConfig(schedule="dynamic")``) :meth:`CensusService.flush` drains
a multi-group backlog concurrently — each (bucket, ops) group on its own
thread, at most the pool width at a time, its chunks work-queued over
the pool.  Per-slot chunk counts (``devices``) and the engine's recovery
counters (retries, quarantines, fallbacks) surface in
:meth:`CensusService.stats`.

Beyond the stateless request stream the service runs **subscribed
sessions** over evolving graphs: :meth:`CensusService.subscribe` pins a
graph and its ops, :meth:`~CensusService.mutate` applies a
:class:`~repro_torch.core.delta.GraphDelta` through ``Plan.apply_delta``
(work proportional to the footprint, one device→host copy, a full
recompute past ``delta_threshold``, a recompile through the plan cache
when the graph outgrows its buckets), and :meth:`~CensusService.poll`
reads fresh results from the session's raw bins.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

from ..core import spans
from ..core.delta import GraphDelta, apply_delta_csr
from ..core.graph import CSRGraph
from ..engine.config import EngineConfig
from ..engine.ops import get_op, resolve_ops
from ..engine.plan import GraphMeta, PlanShapeError, compile

__all__ = ["AdmissionError", "CensusCompletion", "CensusService",
           "DeadlineExceeded", "ServiceConfig"]

_DEFAULT_OPS = ("triad_census",)

REJECT_POLICIES = ("reject", "flush_oldest")

#: why a group flushed: it reached ``max_batch``, it went stale under
#: ``max_wait_requests``, admission control flushed it (``flush_oldest``),
#: or :meth:`CensusService.flush` did
FLUSH_REASONS = ("full", "stale", "admission", "explicit")
#: requests whose queue wait :meth:`CensusService.stats` summarizes
QUEUE_WAIT_WINDOW = 4096
#: the clock of the queue-wait statistics (seconds)
clock = time.perf_counter


class AdmissionError(RuntimeError):
    """Backpressure signal: the service's pending queue is at
    ``ServiceConfig.max_pending`` and ``reject_policy="reject"`` refused
    a new request.  Typed so load-shedding callers can catch admission
    rejections apart from execution failures; the rejected request was
    never assigned an id and holds no service state."""


class DeadlineExceeded(RuntimeError):
    """A request's ``deadline_rounds`` budget ran out before its group
    executed: the request completes with this as its
    ``CensusCompletion.error`` payload instead of result data.
    Deadlines are measured in *flush rounds* (group executions), never
    wall clocks, so expiry is exactly reproducible in tests."""


def _normalize_ops(ops) -> Tuple[str, ...]:
    """Per-request ops spec -> validated tuple of registered op names.

    Validation happens here, at submit time, so a bad spec (typo'd name,
    unregistered instance) rejects the one request instead of surfacing
    at flush time and taking its whole batch group down with it.  Groups
    are keyed (and flushed) by *name*, so a GraphOp instance is accepted
    only if it IS the registered op of that name — a name-colliding
    unregistered instance must not be silently swapped for the
    registry's implementation."""
    if ops is None:
        return _DEFAULT_OPS
    names = []
    for op in resolve_ops(ops):
        if get_op(op.name) is not op:  # KeyError if the name is unknown
            raise ValueError(
                f"service requests resolve ops by name at flush time, but "
                f"the submitted {op.name!r} instance is not the registered "
                f"one — register_op(...) it (overwrite=True to replace the "
                f"existing registration) before submitting")
        names.append(op.name)
    return tuple(names)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Batching policy for a :class:`CensusService`.

    Attributes:
        max_batch: flush a group as soon as it holds this many requests —
            the batch width the service aims for.
        max_wait_requests: bounded-staleness valve.  A partial group is
            force-flushed once this many *other-group* requests have
            been submitted since the group's oldest member — a rare
            bucket can never wait forever behind hot ones, while a hot
            bucket's own burst is still allowed to fill to
            ``max_batch``.  ``0`` disables waiting entirely: every
            submit flushes immediately (B = 1, the unbatched baseline).
            Counted in requests, not seconds, so tests are
            deterministic.
        census: the :class:`~repro_torch.engine.EngineConfig` every request
            executes under — together with the request's (bucket, ops)
            key it pins the plan-cache entry, so one service maps to at
            most one cached plan per (bucket, ops) group.
        max_sessions: cap on concurrently subscribed evolving-graph
            sessions (:meth:`CensusService.subscribe`).  Each live
            session pins its current graph, raw accumulator bins and a
            plan-cache reference, so the cap bounds the service's
            resident state; ``subscribe`` past it raises until a session
            is :meth:`~CensusService.unsubscribe`\\ d.
        max_pending: admission-control cap on submitted-but-not-executed
            requests (``None`` = unbounded).
            A submit that would exceed it triggers ``reject_policy``.
            Every pending request pins its graph in host memory, so this
            is the service's backpressure valve.
        max_attempts: execution attempts per *request* when its batch
            fails: after a failed ``run_batch`` the group retries
            member-wise, each member up to ``max_attempts`` times, so
            one poison graph surfaces as a single failed
            :class:`CensusCompletion` (with ``error`` payload) instead
            of taking down its batch peers.  Independent of the engine's
            per-chunk ``EngineConfig.max_attempts``.
        reject_policy: what a full pending queue does to a new submit —
            ``"reject"`` raises :class:`AdmissionError` (shed load onto
            the caller), ``"flush_oldest"`` synchronously flushes the
            group holding the oldest pending request to free capacity,
            then admits.
    """

    max_batch: int = 8
    max_wait_requests: int = 64
    census: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    max_sessions: int = 64
    max_pending: Optional[int] = None
    max_attempts: int = 2
    reject_policy: str = "reject"

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_requests < 0:
            raise ValueError("max_wait_requests must be >= 0")
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 (got {self.max_pending}); use "
                "None for an unbounded pending queue")
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1 (got {self.max_attempts}); it "
                "is the per-request execution budget after a batch failure")
        if self.reject_policy not in REJECT_POLICIES:
            raise ValueError(
                f"reject_policy must be one of {REJECT_POLICIES}, got "
                f"{self.reject_policy!r}")


class CensusCompletion(NamedTuple):
    """One finished request: the id ``submit`` returned, its result, the
    metadata bucket it was batched under, and the ops it ran.  For a
    single-op request (the default census-only case) ``result`` is that
    op's bare result object — a ``CensusResult`` for ``triad_census`` —
    and for a multi-op request it is the fused ``{op_name: result}``
    dict.  A request that *failed* (poison graph, exhausted retries, a
    missed deadline, a failed group or dead group thread) still
    completes — with
    ``result=None`` and the failure as its ``error`` payload — so one
    bad request never silently drops, and never takes its batch peers'
    results down with it."""

    request_id: int
    result: Any
    meta: GraphMeta
    ops: Tuple[str, ...] = _DEFAULT_OPS
    error: Optional[BaseException] = None


class _Request(NamedTuple):
    """One pending entry: stable id, the graph, the flush-round number
    after which the request expires (None = no deadline), and the
    :data:`clock` reading at its submit."""

    rid: int
    graph: CSRGraph
    expiry: Optional[int] = None
    t_submit: float = 0.0


@dataclasses.dataclass
class _Session:
    """One subscribed evolving graph: its current state + plan + counters."""

    graph: CSRGraph
    ops: Tuple[str, ...]
    plan: Any
    raw: Any  # (total_bins,) int64 — the plan's raw fused accumulator
    mutations: int = 0
    deltas: int = 0      # mutations served by the affected-subset path
    fulls: int = 0       # mutations that fell back to a full recompute
    recompiles: int = 0  # mutations that outgrew the plan's buckets
    failed: int = 0      # mutations rolled back after a mid-mutate failure


class CensusService:
    """Plan-cache-aware batched serving over a mixed-analytic request
    stream.

    ::

        svc = CensusService(ServiceConfig(
            max_batch=8, census=EngineConfig(backend="tiles")))
        rid = svc.submit(graph)                        # census request
        rid2 = svc.submit(graph, ops=("triad_census",
                                      "degree_stats")) # fused multi-op
        done = svc.flush()             # force-run all partial groups
        for c in done:                 # CensusCompletion, flush order
            ...

    Requests are grouped by (graph bucket, ops): a census-only fleet and
    a multi-analytic fleet over the same graphs batch separately (they
    run different fused plans), but everything inside a group rides one
    batch.

    ``mesh`` is forwarded to every ``compile`` for the distributed
    backend (``None``: the engine's default mesh).  A distributed service
    is SPMD, one instance per rank: every rank must submit the same
    requests, subscribe and mutate the same sessions and flush, all in
    the same order, since each batch, run and delta ends in a merge over
    the mesh that every rank joins.
    """

    def __init__(self, config: Optional[ServiceConfig] = None, *,
                 mesh=None):
        self.config = config or ServiceConfig()
        self.mesh = mesh
        # (meta, ops) -> [(rid, graph)] / oldest rid
        self._pending: Dict[tuple, list] = {}
        self._first_seq: Dict[tuple, int] = {}
        self._completed: List[CensusCompletion] = []
        self._seq = 0
        self._bucket_stats: Dict[GraphMeta, dict] = {}
        self._device_chunks: Dict[int, int] = {}
        self._sessions: Dict[int, _Session] = {}
        self._session_seq = 0
        # flush-round clock (one tick per executed/failed group) — the
        # clockless time base request deadlines are measured against.
        self._rounds = 0
        self._health = dict(retries=0, quarantines=0, backend_fallbacks=0,
                            schedule_fallbacks=0, rejections=0, poisoned=0,
                            expired=0, batch_failures=0, group_failures=0,
                            mutate_failures=0)
        self._flushes = dict.fromkeys(FLUSH_REASONS, 0)
        self._queue_wait: collections.deque = collections.deque(
            maxlen=QUEUE_WAIT_WINDOW)

    # -- request path --------------------------------------------------------

    def _admit(self) -> None:
        """Admission control: enforce ``max_pending`` per the configured
        ``reject_policy`` before a new request takes a queue slot."""
        cap = self.config.max_pending
        if cap is None:
            return
        while self.pending >= cap:
            if self.config.reject_policy == "reject":
                self._health["rejections"] += 1
                raise AdmissionError(
                    f"pending queue full ({self.pending} >= max_pending="
                    f"{cap}); flush(), poll later, or configure "
                    f"reject_policy='flush_oldest'")
            # flush_oldest: free capacity by executing the group holding
            # the oldest pending request, then admit.
            oldest = min(self._first_seq, key=self._first_seq.get)
            self._flush_group(oldest, "admission")

    def submit(self, graph: CSRGraph, ops=None, *,
               deadline_rounds: Optional[int] = None) -> int:
        """Queue one analytic request; returns its stable request id.

        ``ops`` names the :class:`~repro_torch.engine.GraphOp` set to run — a
        name, a sequence of names, or ``None`` for the census-only
        default.  If the request fills its (bucket, ops) group to
        ``max_batch``, the group executes immediately (synchronously);
        any group gone stale under ``max_wait_requests`` is flushed too.
        Completions are held until :meth:`poll`.

        ``deadline_rounds`` bounds how long the request may sit pending,
        measured in flush rounds (group executions — the service's
        clockless time base): a request still pending after that many
        further rounds completes with a :class:`DeadlineExceeded` error
        payload instead of executing.  ``None`` = no deadline.  A full
        pending queue (``max_pending``) applies ``reject_policy`` first —
        ``"reject"`` raises :class:`AdmissionError` before an id is
        assigned.
        """
        if deadline_rounds is not None and deadline_rounds < 0:
            raise ValueError(
                f"deadline_rounds must be >= 0 (got {deadline_rounds}); "
                "use None for no deadline")
        self._expire_overdue()
        self._admit()
        rid = self._seq
        self._seq += 1
        ops_t = _normalize_ops(ops)
        meta = GraphMeta.from_graph(graph, k=self.config.census.k)
        key = (meta, ops_t)
        group = self._pending.setdefault(key, [])
        if not group:
            self._first_seq[key] = rid
        expiry = (None if deadline_rounds is None
                  else self._rounds + deadline_rounds)
        group.append(_Request(rid, graph, expiry, clock()))
        st = self._bucket_stats.setdefault(
            meta, dict(requests=0, batches=0, batched_graphs=0,
                       host_syncs=0, chunks=0, by_ops={}))
        st["requests"] += 1
        st["by_ops"][ops_t] = st["by_ops"].get(ops_t, 0) + 1
        if len(group) >= self.config.max_batch:
            self._flush_group(key, "full")
        # staleness: count only OTHER groups' arrivals since a group's
        # oldest member — a hot group's own burst must still be allowed
        # to fill to max_batch.
        for stale in [k for k, s in self._first_seq.items()
                      if (self._seq - s - len(self._pending[k])
                          >= self.config.max_wait_requests)]:
            self._flush_group(stale, "stale")
        return rid

    def _expire_overdue(self) -> None:
        """Complete (with :class:`DeadlineExceeded` payloads) every
        pending request whose flush-round deadline has passed.  Runs at
        every submit and flush entry, so an expired request is surfaced
        by the next service interaction — never left pending."""
        for key in list(self._pending):
            group = self._pending[key]
            dead = [r for r in group
                    if r.expiry is not None and self._rounds > r.expiry]
            if not dead:
                continue
            keep = [r for r in group if r not in dead]
            meta, ops_t = key
            self._health["expired"] += len(dead)
            self._completed.extend(
                CensusCompletion(r.rid, None, meta, ops_t,
                                 error=DeadlineExceeded(
                                     f"request {r.rid} expired after "
                                     f"deadline round {r.expiry} (now round "
                                     f"{self._rounds})"))
                for r in dead)
            if keep:
                self._pending[key] = keep
            else:
                del self._pending[key]
                del self._first_seq[key]

    def poll(self, session: Optional[int] = None):
        """Without arguments: drain and return completions accumulated
        since the last poll (order is batch flush order — generally NOT
        submission order; match on ``request_id``).

        With a ``session`` id (from :meth:`subscribe`): the subscribed
        graph's fresh analytics — finalized from the session's cached raw
        accumulator bins, so polling costs host-side closed forms only,
        no device work.  Single-op sessions return the bare result object
        (a ``CensusResult`` for the census default), multi-op sessions
        the ``{op_name: result}`` dict — same unwrapping as request
        completions."""
        if session is not None:
            return self._session_results(self._session(session))
        out, self._completed = self._completed, []
        return out

    # -- subscribed evolving-graph sessions ----------------------------------

    def _session(self, session: int) -> _Session:
        try:
            return self._sessions[session]
        except KeyError:
            raise KeyError(f"unknown session {session!r}; live sessions: "
                           f"{sorted(self._sessions)}") from None

    def _session_results(self, s: _Session):
        results = s.plan.layout.finalize(s.raw, s.graph)
        return results[s.ops[0]] if len(s.ops) == 1 else results

    def subscribe(self, graph: CSRGraph, ops=None) -> int:
        """Pin an evolving graph; returns its session id.

        The session compiles (or reuses from the plan cache) the fused
        plan for ``(graph bucket, ops)``, runs one full pass to seed the
        raw accumulator state, and is then ready to take
        :meth:`mutate` streams; :meth:`poll`\\ (session) reads fresh
        counts at any time.  ``ops`` follows :meth:`submit`'s convention
        (``None`` = census only).  Raises once
        ``ServiceConfig.max_sessions`` sessions are live."""
        ops_t = _normalize_ops(ops)
        if len(self._sessions) >= self.config.max_sessions:
            raise RuntimeError(
                f"session limit reached (max_sessions="
                f"{self.config.max_sessions}); unsubscribe() a session "
                "before subscribing another graph")
        plan = compile(graph, ops_t, self.config.census, mesh=self.mesh)
        sid = self._session_seq
        self._session_seq += 1
        self._sessions[sid] = _Session(graph=graph, ops=ops_t, plan=plan,
                                       raw=plan.run_raw(graph))
        return sid

    def mutate(self, session: int, delta: GraphDelta) -> dict:
        """Apply one mutation batch to a subscribed graph.

        Rides ``Plan.apply_delta``: the affected-subset correction (work
        proportional to the delta's footprint, ONE device→host sync) when
        the mutation is local enough, the plan's full pass otherwise
        (``delta_threshold`` cost model) — results are bit-identical
        either way.  A mutation that outgrows the session plan's metadata
        buckets (degree or arc-count growth past the bucketized shape)
        transparently recompiles through the plan cache at the new shape
        and reseeds with one full pass.  Returns an ack dict: ``mode``
        (``"delta"`` | ``"full"`` | ``"recompile"``),
        ``affected_fraction``, and the new ``n`` / ``m``; read the fresh
        counts with :meth:`poll`\\ (session).

        **Failure atomicity**: a mutation that fails mid-way (an
        injected or real execution failure at any point — delta pass,
        full recompute, or recompile reseed) re-raises AND rolls the
        session back to its pre-mutation (graph, raw bins, plan)
        snapshot, so a subscribed session never serves corrupted counts
        — :meth:`poll`\\ (session) keeps answering from the last good
        state.  Rolled-back mutations are counted per session
        (``failed``) and in ``stats()["health"]["mutate_failures"]``."""
        s = self._session(session)
        snapshot = (s.graph, s.raw, s.plan)
        try:
            try:
                out = s.plan.apply_delta(s.graph, delta, s.raw)
                s.graph, s.raw = out.graph, out.raw
                mode, frac = out.mode, out.affected_fraction
                if mode == "delta":
                    s.deltas += 1
                else:
                    s.fulls += 1
            except PlanShapeError:
                # compute the whole new state BEFORE committing any of it:
                # a failure inside the recompile reseed must leave the
                # session on its old (graph, raw, plan) triple.
                g_new = apply_delta_csr(s.graph, delta)
                plan_new = compile(g_new, s.ops, self.config.census,
                                   mesh=self.mesh)
                raw_new = plan_new.run_raw(g_new)
                s.plan, s.graph, s.raw = plan_new, g_new, raw_new
                s.recompiles += 1
                mode, frac = "recompile", 1.0
        except Exception:
            s.graph, s.raw, s.plan = snapshot
            s.failed += 1
            self._health["mutate_failures"] += 1
            raise
        s.mutations += 1
        return dict(session=session, mode=mode, affected_fraction=frac,
                    n=s.graph.n, m=s.graph.m)

    def unsubscribe(self, session: int):
        """End a session, freeing its ``max_sessions`` slot; returns the
        final analytics (same shape :meth:`poll`\\ (session) returns)."""
        s = self._session(session)
        del self._sessions[session]
        return self._session_results(s)

    def flush(self) -> List[CensusCompletion]:
        """Execute every pending partial group, then drain completions.

        Sequentially, in submission order, by default: a group that fails
        as a whole completes each of its requests with the error payload
        and re-raises.  Under the dynamic executor schedule a multi-group
        backlog drains **concurrently**: every group's plan is compiled
        first (the plan cache is touched only from this thread, and a
        compile failure leaves every request pending), then each group
        runs on its own thread, at most the pool width at a time.  Every
        group is recorded in submission order — results for the live
        ones, explicit error completions for a dead one — so ``pending``
        is 0 afterwards and peers keep their results.  Per-request
        failures inside a live group (poison graphs) are isolated
        member-wise by :meth:`_execute_group`."""
        self._expire_overdue()
        keys = list(self._pending)
        if len(keys) > 1 and self.config.census.schedule == "dynamic":
            plans = {key: compile(key[0], key[1], self.config.census,
                                  mesh=self.mesh)
                     for key in keys}
            jobs = [(key, self._take(key, "explicit")) for key in keys]
            # more group threads than pool slots would only oversubscribe
            # the pool (each group's executor starts one worker a slot)
            width = max(p.executor.n_devices for p in plans.values())
            with ThreadPoolExecutor(max_workers=min(len(jobs), width)) as ex:
                futs = [ex.submit(self._execute_group, plans[key], group)
                        for key, group in jobs]
                outs = [f.exception() or f.result() for f in futs]
            for (key, group), out in zip(jobs, outs):
                self._record_outcome(key, group, out)
        else:
            for key in keys:
                self._flush_group(key, "explicit")
        return self.poll()

    def run_fleet(self, graphs: Iterable[CSRGraph], ops=None) -> List[Any]:
        """Submit a whole fleet (one ``ops`` set for all), flush, and
        return results in input order.

        Completions belonging to requests submitted *before* this call
        (drained by the flush) are retained for the next :meth:`poll` —
        never discarded.  A fleet member that *failed* (poison graph,
        exhausted retries) yields ``None`` in its slot — check the
        completion stream via :meth:`submit` + :meth:`flush` directly
        when per-request error payloads matter.
        """
        ids = [self.submit(g, ops) for g in graphs]
        mine = set(ids)
        done = {}
        others = []
        for c in self.flush():
            if c.request_id in mine:
                done[c.request_id] = c.result
            else:
                others.append(c)
        self._completed.extend(others)
        return [done[i] for i in ids]

    @property
    def pending(self) -> int:
        """Number of submitted-but-not-yet-executed requests."""
        return sum(len(g) for g in self._pending.values())

    # -- execution -----------------------------------------------------------

    def _take(self, key, reason: str) -> list:
        """Pop ``key``'s pending group to run it, counting the flush under
        ``reason`` (one of :data:`FLUSH_REASONS`) and each request's wait
        since its submit."""
        group = self._pending.pop(key)
        self._first_seq.pop(key)
        self._flushes[reason] += 1
        now = clock()
        self._queue_wait.extend(1e3 * (now - r.t_submit) for r in group)
        return group

    def _flush_group(self, key, reason: str) -> None:
        with spans.span(spans.FLUSH):
            meta, ops_t = key
            group = self._take(key, reason)
            plan = compile(meta, ops_t, self.config.census, mesh=self.mesh)
            try:
                out = self._execute_group(plan, group)
            except BaseException as e:
                # the group's requests fail explicitly, never silently drop.
                self._record_outcome(key, group, e)
                raise
            self._record_outcome(key, group, out)

    def _execute_group(self, plan, group) -> dict:
        """Run one group's batch; returns results + the plan-stat deltas.

        **Member-wise isolation**: if the batch fails as a unit (one
        poison graph fails the whole batch), every member retries
        individually on the same plan — up to
        ``ServiceConfig.max_attempts`` each — so healthy peers still
        produce results and only the bad request carries an error
        payload.  No exception escapes for per-member failures.  Safe to
        run beside other groups: distinct (bucket, ops) keys map to
        distinct plans, and service bookkeeping stays on the flush
        caller's thread (:meth:`_record_outcome`)."""
        before = {k: plan.stats[k] for k in ("host_syncs", "chunks")}
        before_dev = dict(plan.stats["device_chunks"])
        before_faults = dict(plan.stats["faults"])
        graphs = [r.graph for r in group]
        errors: list = [None] * len(group)
        batch_failed = 0
        try:
            results = plan.run_batch(graphs)
        except Exception:
            # the batch failed as a unit — retry member-wise so one
            # bad graph costs one failed completion, not the group.
            batch_failed = 1
            results = [None] * len(group)
            for i, g in enumerate(graphs):
                for _ in range(self.config.max_attempts):
                    try:
                        results[i] = plan.run(g)
                        errors[i] = None
                        break
                    except Exception as e:
                        errors[i] = e
        dev = {d: c - before_dev.get(d, 0)
               for d, c in plan.stats["device_chunks"].items()
               if c - before_dev.get(d, 0)}
        faults = {k: v - before_faults.get(k, 0)
                  for k, v in plan.stats["faults"].items()}
        part = plan.stats.get("partition")
        return dict(results=results, errors=errors, batch_failed=batch_failed,
                    host_syncs=plan.stats["host_syncs"] - before["host_syncs"],
                    chunks=plan.stats["chunks"] - before["chunks"],
                    device_chunks=dev, faults=faults,
                    partitions=plan.partitions,
                    partition=dict(part) if part else None)

    def _record_outcome(self, key, group, out) -> None:
        """Fold one executed (or failed) group into service state, always
        on the flush caller's thread.  ``out`` is :meth:`_execute_group`'s
        dict for a live group, or the exception that failed it (or killed
        its thread) — in which case every request completes
        explicitly with that error as payload (the queue was already
        popped; nothing stays pending)."""
        meta, ops_t = key
        self._rounds += 1
        if isinstance(out, BaseException):
            self._health["group_failures"] += 1
            self._completed.extend(
                CensusCompletion(r.rid, None, meta, ops_t, error=out)
                for r in group)
            return
        results = out["results"]
        errors = out["errors"]
        if len(ops_t) == 1:  # single-op requests complete with bare results
            results = [r if r is None else r[ops_t[0]] for r in results]
        st = self._bucket_stats[meta]
        st["batches"] += 1
        st["batched_graphs"] += len(group)
        st["host_syncs"] += out["host_syncs"]
        st["chunks"] += out["chunks"]
        for d, c in out["device_chunks"].items():
            self._device_chunks[d] = self._device_chunks.get(d, 0) + c
        if out["partition"]:
            # the last partitioned layout this bucket ran
            st["partitions"] = out["partitions"]
            st["partition"] = out["partition"]
        for k in ("retries", "quarantines", "backend_fallbacks",
                  "schedule_fallbacks"):
            self._health[k] += out["faults"][k]
        self._health["batch_failures"] += out["batch_failed"]
        self._health["poisoned"] += sum(1 for e in errors if e is not None)
        self._completed.extend(
            CensusCompletion(r.rid, res, meta, ops_t, error=err)
            for r, res, err in zip(group, results, errors))

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Service-level + per-bucket serving statistics.

        ``buckets`` maps each :class:`GraphMeta` to its request/batch
        counts, ``occupancy`` (batched graphs per flushed batch slot —
        1.0 means every batch left full), the host syncs / chunks its
        batches cost, and ``by_ops`` (requests per ops tuple — the
        mixed-analytic split); a bucket served by a partitioned plan also
        reports ``partitions`` and ``partition``, the last run's shard
        layout and staging (see
        :func:`repro_torch.engine.partition.run_partitioned`).
        ``mean_batch`` is the fleet-wide average
        batch width.  ``devices`` maps each executor pool slot to the
        chunks the service dispatched there (all on slot 0 under the
        static schedule).  ``sessions`` maps each live subscribed-session id
        to its mutation counters — ``mutations`` split into ``deltas``
        (affected-subset path), ``fulls`` (cost-model fallback) and
        ``recompiles`` (bucket outgrowth), plus ``failed`` (mutations
        rolled back to the pre-mutation snapshot) — plus the session's
        current graph size and ops.  ``rounds`` is the flush-round clock
        deadlines are measured against, and ``health`` counts the
        recoveries: the engine's ``retries`` / ``quarantines`` /
        ``backend_fallbacks`` / ``schedule_fallbacks`` (summed from the
        plans' ``stats["faults"]``), and the service's ``rejections``
        (admission control),
        ``expired`` (missed deadlines), ``batch_failures`` (groups that
        retried member-wise), ``poisoned`` (requests completing with
        error payloads), ``group_failures`` (groups that failed as a
        whole) and ``mutate_failures`` (rolled-back session mutations) —
        all zeros on a healthy service.  ``flushes`` counts the groups
        flushed for each reason of :data:`FLUSH_REASONS`: ``full`` (the
        group reached ``max_batch``), ``stale`` (the ``max_wait_requests``
        valve), ``admission`` (``reject_policy="flush_oldest"``) and
        ``explicit`` (:meth:`flush`).  ``queue_wait_ms`` summarizes, over
        the last :data:`QUEUE_WAIT_WINDOW` requests flushed, the time from
        each one's ``submit`` to the start of its group's flush: ``n`` and
        the ``p50``, ``p95`` (numpy's linear percentiles) and ``max`` in
        milliseconds, None while ``n`` is 0.
        """
        buckets = {}
        total_batches = total_graphs = 0
        for meta, st in self._bucket_stats.items():
            occ = (st["batched_graphs"]
                   / (st["batches"] * self.config.max_batch)
                   if st["batches"] else 0.0)
            buckets[meta] = {**st, "by_ops": dict(st["by_ops"]),
                             "occupancy": occ}
            total_batches += st["batches"]
            total_graphs += st["batched_graphs"]
        return dict(
            requests=self._seq,
            pending=self.pending,
            batches=total_batches,
            mean_batch=(total_graphs / total_batches
                        if total_batches else 0.0),
            buckets=buckets,
            devices=dict(self._device_chunks),
            rounds=self._rounds,
            health=dict(self._health),
            flushes=dict(self._flushes),
            queue_wait_ms=_summary(self._queue_wait),
            sessions={sid: dict(mutations=s.mutations, deltas=s.deltas,
                                fulls=s.fulls, recompiles=s.recompiles,
                                failed=s.failed,
                                n=s.graph.n, m=s.graph.m, ops=s.ops)
                      for sid, s in self._sessions.items()},
        )


def _summary(waits) -> dict:
    """``n``, ``p50``, ``p95`` and ``max`` of ``waits`` (None while empty)."""
    if not waits:
        return dict(n=0, p50=None, p95=None, max=None)
    w = np.fromiter(waits, dtype=np.float64)
    p50, p95 = np.percentile(w, [50, 95])
    return dict(n=len(w), p50=float(p50), p95=float(p95), max=float(w.max()))
