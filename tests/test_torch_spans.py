"""The port's program spans and the census service's flush and queue-wait
counters, on the CPU: a traced run records each per-pass span once and
one ``census.chunk`` per chunk inside its ``census.dispatch``; an
untraced run builds no span at all; the service counts its flushes by
reason exactly and its queue waits on the clock it is given."""
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import generators as tgen
from repro_torch.core import spans
from repro_torch.engine import EngineConfig, clear_plan_cache, compile
from repro_torch.serve import CensusService, ServiceConfig, census_service

CPU = EngineConfig(backend="tiles", device="cpu", batch=32, chunk_dyads=32)


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _plan(ops=("triad_census",)):
    g = tgen.rmat(6, edge_factor=4, seed=3, device="cpu")
    plan = compile(g, ops, CPU)
    plan.run(g)  # untraced: a profiling session after it starts a tally
    return g, plan


def _count_recordings(monkeypatch):
    made = []
    orig = spans.recording

    def counting(name):
        made.append(name)
        return orig(name)

    monkeypatch.setattr(spans, "recording", counting)
    return made


def test_traced_run_records_each_pass_span_once_and_a_chunk_per_chunk():
    g, plan = _plan()
    chunks0 = plan.stats["chunks"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan.layout.finalize(plan.run_raw(g), g)
    chunks = plan.stats["chunks"] - chunks0
    assert chunks > 1
    events = [e for e in prof.events()
              if e.name.startswith(("census.", "service."))]
    names = [e.name for e in events]
    for once in (spans.RUN, spans.STREAM, spans.DISPATCH, spans.FETCH,
                 spans.FINALIZE):
        assert names.count(once) == 1, once
    for per_chunk in (spans.CHUNK, spans.CHECK, spans.REDUCE, spans.FOLD):
        assert names.count(per_chunk) == chunks, per_chunk
    dispatch, = [e.time_range for e in events if e.name == spans.DISPATCH]
    for e in events:
        if e.name == spans.CHUNK:
            assert (dispatch.start <= e.time_range.start
                    and e.time_range.end <= dispatch.end)
    # the tally of the same session agrees with the trace
    tally = spans.totals()
    assert tally[spans.CHUNK]["n"] == chunks
    assert tally[spans.DISPATCH]["n"] == 1
    assert 0 < tally[spans.CHUNK]["s"] <= tally[spans.DISPATCH]["s"]


@pytest.mark.parametrize("ops", [("triad_census",),
                                 ("triad_census", "degree_stats")],
                         ids=["census", "fused"])
def test_untraced_run_builds_no_span(ops, monkeypatch):
    g, plan = _plan(ops)
    made = _count_recordings(monkeypatch)
    rf = []
    orig_rf = spans._record
    monkeypatch.setattr(spans, "_record",
                        lambda *a: rf.append(a) or orig_rf(*a))
    chunks0 = plan.stats["chunks"]
    plan.run_batch([g, g])
    assert plan.stats["chunks"] - chunks0 > 3
    assert made == [] and rf == []
    with profile(activities=[ProfilerActivity.CPU]):
        plan.run(g)
    assert made.count(spans.CHUNK) > 1 and len(rf) == len(made)


def test_tally_starts_afresh_with_each_profiling_session():
    g, plan = _plan()
    with profile(activities=[ProfilerActivity.CPU]):
        plan.run_raw(g)
        plan.run_raw(g)
    assert spans.totals()[spans.RUN]["n"] == 2
    plan.run_raw(g)  # untraced: the tally stands
    assert spans.totals()[spans.RUN]["n"] == 2
    with profile(activities=[ProfilerActivity.CPU]):
        plan.run_raw(g)
    assert spans.totals()[spans.RUN]["n"] == 1


def _graphs():
    a = [tgen.rmat(5, edge_factor=4, seed=s, device="cpu") for s in (0, 2)]
    b = tgen.rmat(6, edge_factor=4, seed=0, device="cpu")
    return a, b


def _service(**kw):
    return CensusService(ServiceConfig(census=CPU, **kw))


def test_flushes_counted_by_reason():
    (a0, a1), b = _graphs()
    svc = _service(max_batch=2, max_wait_requests=3)
    svc.submit(a0)
    svc.submit(a1)       # A reaches max_batch
    svc.submit(b)        # B's oldest
    svc.submit(a0)
    svc.submit(a1)       # A full again; B has seen 2 other submits
    svc.submit(a0)       # 3 other submits: B goes stale
    done = svc.flush()   # A's last request
    assert svc.stats()["flushes"] == dict(full=2, stale=1, admission=0,
                                          explicit=1)
    assert len(done) == 6 and all(c.error is None for c in done)

    svc = _service(max_batch=8, max_wait_requests=64, max_pending=2,
                   reject_policy="flush_oldest")
    svc.submit(a0)
    svc.submit(b)
    svc.submit(a1)       # the queue is full: A (the oldest) flushes
    svc.flush()          # B and the new A
    assert svc.stats()["flushes"] == dict(full=0, stale=0, admission=1,
                                          explicit=2)


def test_queue_wait_on_the_services_clock(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(census_service, "clock", lambda: now[0])
    (a0, a1), _ = _graphs()
    svc = _service(max_batch=2, max_wait_requests=64)
    assert svc.stats()["queue_wait_ms"] == dict(n=0, p50=None, p95=None,
                                                max=None)
    svc.submit(a0)
    now[0] = 1.0
    svc.submit(a1)       # flushes full at t = 1 s: waits 1,000 and 0 ms
    now[0] = 2.5
    svc.submit(a0)
    now[0] = 4.0
    svc.flush()          # waited 1,500 ms
    q = svc.stats()["queue_wait_ms"]
    assert q == dict(n=3, p50=1000.0, p95=pytest.approx(1450.0),
                     max=1500.0)
    assert svc._queue_wait.maxlen == census_service.QUEUE_WAIT_WINDOW
