"""The port's executor pool and dynamic schedule against the JAX engine:
the dynamic task lists equal the JAX ones (tiles ↔ ``_pallas_bucket_tasks``,
search ↔ ``_dyad_tasks``); every backend, schedule and pool width gives
the JAX engine's raw bins and the brute-force census for all four ops, in
one device→host copy, with ``sum(device_chunks) == chunks``; the config,
the plan-cache entries and the service report the pool as the JAX
package does; a many-worker stress run loses no fold; and the default
census plan launches once per degree bucket (the bucket-wide schedule),
equal to search and to 8,192-dyad chunks, while every other plan keeps
its task list.  Graphs are
small R-MATs built in both packages from the same arc arrays; tolerance
0.  A CPU pool is ``n_executor_devices`` worker threads on the CPU.

The JAX package is imported inside the tests that compare with it, so
the CUDA case runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_executor.py``.
"""
import functools
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.census import canonical_dyads, host_bucket_schedule
from repro_torch.core.graph import arcs_host
from repro_torch.engine import (ChunkTask, EngineConfig, Executor, FaultPlan,
                                clear_plan_cache, compile, plan_cache_stats)
from repro_torch.engine import backends
from repro_torch.engine.backends import (_bucket_spans, _bucket_tasks,
                                         _search_tasks, tiles_geometry)
from repro_torch.kernels.triad_census import SENTINEL, census_csr
from repro_torch.serve import CensusService, ServiceConfig

ALL_OPS = ("triad_census", "dyad_census", "degree_stats", "triadic_profile")
SMALL = dict(batch=16, chunk_dyads=64)
#: every dispatch sleeps briefly, so a CPU pool's workers interleave
JITTER = FaultPlan(slow_chunk_rate=1.0, slow_s=0.005)


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_plan_cache()
    yield
    clear_plan_cache()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census kernel has no CPU mode")
    return torch.device("cuda")


def port_graph(scale, seed):
    return tgen.rmat(scale, edge_factor=4, seed=seed, device="cpu")


def jax_graph(g):
    from repro.core.graph import from_edges

    return from_edges(g.n, *arcs_host(g), directed=True)


def cfg(backend, **kw):
    return EngineConfig(backend=backend, device="cpu", **{**SMALL, **kw})


@functools.lru_cache(maxsize=None)
def jax_raw(scale, seed, backend):
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    jg = jax_graph(port_graph(scale, seed))
    raw = jcompile(jg, ALL_OPS, JConfig(backend=backend, **SMALL)).run_raw(jg)
    jclear()
    return np.asarray(raw)


# -- task lists ----------------------------------------------------------------

@pytest.mark.parametrize("buckets", [(32, 128, 512), (4, 8, 16)])
@pytest.mark.parametrize("scale,seed", [(6, 1), (7, 2)])
def test_dynamic_tiles_tasks_equal_jax_pallas(scale, seed, buckets):
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import compile as jcompile
    from repro.engine.backends import _pallas_bucket_tasks

    g = port_graph(scale, seed)
    jg = jax_graph(g)
    plan = compile(g, ("triad_census",), cfg(
        "tiles", schedule="dynamic", buckets=buckets))
    _, chunk, ks = tiles_geometry(plan)
    counts, need = host_bucket_schedule(g, ks, with_needs=True)
    got = _bucket_tasks(ks, counts, chunk, need)
    jplan = jcompile(jg, ("triad_census",), JConfig(
        backend="pallas", schedule="dynamic", buckets=buckets, **SMALL))
    want = _pallas_bucket_tasks(jplan, jg, ks, chunk)
    assert [tuple(t) for t in got] == [tuple(t) for t in want]
    assert len(got) > len(_bucket_tasks(ks, counts, chunk))  # finer


@pytest.mark.parametrize("schedule", ["static", "dynamic"])
@pytest.mark.parametrize("model", ["canonical_uniform", "canonical_nonuniform",
                                   "dyad_uniform"])
def test_search_tasks_equal_jax_dyad_tasks(schedule, model):
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import compile as jcompile
    from repro.engine.backends import _dyad_tasks

    g = port_graph(7, 4)
    jg = jax_graph(g)
    plan = compile(g, ("triad_census",), cfg(
        "search", schedule=schedule, weight_model=model))
    u, v = canonical_dyads(g)
    got = _search_tasks(plan, g, u, v, plan.chunk)
    jplan = jcompile(jg, ("triad_census",), JConfig(
        backend="xla", schedule=schedule, weight_model=model, **SMALL))
    want = _dyad_tasks(jplan, jg)
    assert [t[:3] for t in got] == [tuple(t[:3]) for t in want]
    deg = g.host.nbr_deg.astype(np.int64)
    assert all(t.key == int((deg[u[t.start:t.end]]
                             + deg[v[t.start:t.end]]).sum()) for t in got)


# -- bins ----------------------------------------------------------------------

@pytest.mark.parametrize("schedule,pool", [("static", 1), ("dynamic", 1),
                                           ("dynamic", 4)])
@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("scale,seed", [(5, 0), (6, 7)])
def test_run_raw_equals_jax_and_brute_force(scale, seed, backend, schedule,
                                            pool):
    g = port_graph(scale, seed)
    plan = compile(g, ALL_OPS, cfg(backend, schedule=schedule,
                                   n_executor_devices=pool))
    assert plan.executor.n_devices == pool
    raw = plan.run_raw(g)
    np.testing.assert_array_equal(raw, jax_raw(scale, seed, "xla"))
    if (scale, backend) == (5, "tiles"):
        np.testing.assert_array_equal(raw, jax_raw(scale, seed, "pallas"))
    res = plan.layout.finalize(raw, g)
    np.testing.assert_array_equal(res["triad_census"].counts,
                                  brute_force_census(g).counts)
    assert plan.stats["host_syncs"] == 1
    assert sum(plan.stats["device_chunks"].values()) == plan.stats["chunks"]
    assert not any(plan.stats["faults"].values())


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_four_slot_pool_spreads_and_stays_exact(backend):
    g = port_graph(7, 3)
    want = compile(g, ALL_OPS, cfg(backend)).run_raw(g)
    plan = compile(g, ALL_OPS, cfg(backend, schedule="dynamic",
                                   n_executor_devices=4, fault_plan=JITTER))
    for runs in (1, 2):
        np.testing.assert_array_equal(plan.run_raw(g), want)
        assert plan.stats["host_syncs"] == runs
    dc = plan.stats["device_chunks"]
    assert set(dc) <= {0, 1, 2, 3} and len(dc) > 1
    assert sum(dc.values()) == plan.stats["chunks"]


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_dynamic_batch_and_delta_bit_identical(backend):
    from repro_torch.core.delta import GraphDelta

    gs = [port_graph(6, s) for s in (0, 2, 3)]
    static = compile(gs[0], ALL_OPS, cfg(backend))
    plan = compile(gs[0], ALL_OPS, cfg(backend, schedule="dynamic",
                                       n_executor_devices=3,
                                       delta_threshold=1.0))
    got = plan.run_batch(gs)
    assert plan.stats["host_syncs"] == 1
    for res, g in zip(got, gs):
        np.testing.assert_array_equal(res["triad_census"].counts,
                                      static.run(g)["triad_census"].counts)
        assert res["dyad_census"] == static.run(g)["dyad_census"]
    g = gs[0]
    d = GraphDelta(edges_added=[(0, 5), (7, 3)], edges_removed=[(1, 0)])
    out = plan.apply_delta(g, d, plan.run_raw(g))
    assert out.mode == "delta"
    np.testing.assert_array_equal(out.raw, static.run_raw(out.graph))


# -- config, cache, service ----------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(schedule="guided"), "schedule"),
    (dict(n_executor_devices=0), "n_executor_devices"),
    (dict(weight_model="degree"), "weight_model"),
    (dict(max_attempts=0), "max_attempts"),
    (dict(schedule_fallback=1), "schedule_fallback"),
])
def test_executor_knobs_validated(kwargs, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kwargs)


def test_pool_width_resolution_and_cache_key():
    assert EngineConfig(device="cpu").resolve_executor_devices() == 1
    assert EngineConfig(device="cpu", schedule="static",
                        n_executor_devices=4).resolve_executor_devices() == 1
    assert EngineConfig(device="cpu", schedule="dynamic"
                        ).resolve_executor_devices() == 1
    assert EngineConfig(device="cpu", schedule="dynamic",
                        n_executor_devices=6).resolve_executor_devices() == 6
    g = port_graph(5, 0)
    a = compile(g, "triad_census", cfg("tiles", schedule="dynamic"))
    b = compile(g, "triad_census", cfg("tiles", schedule="dynamic",
                                       n_executor_devices=1))
    c = compile(g, "triad_census", cfg("tiles", n_executor_devices=8))
    d = compile(g, "triad_census", cfg("tiles"))
    assert a is b and c is d and a is not d


def test_plan_cache_entries_carry_the_pool():
    g = port_graph(6, 1)
    compile(g, "triad_census", cfg("tiles")).run(g)
    compile(g, "triad_census", cfg("search", schedule="dynamic",
                                   n_executor_devices=2)).run(g)
    by = {e["backend"]: e for e in plan_cache_stats()["entries"]}
    assert (by["tiles"]["schedule"], by["tiles"]["n_devices"]) == ("static", 1)
    assert (by["search"]["schedule"], by["search"]["n_devices"]) == (
        "dynamic", 2)
    for e in by.values():
        assert sum(e["device_chunks"].values()) == e["chunks"] > 0
        assert e["requested_backend"] == e["backend"]
        assert e["degradation"] == [] and e["fault_events"] == []
        assert set(e["faults"]) == {
            "chunk_failures", "retries", "device_losses", "quarantines",
            "backend_fallbacks", "schedule_fallbacks"}


def test_service_devices_match_jax_and_spread_on_a_pool():
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.serve import CensusService as JService
    from repro.serve import ServiceConfig as JServiceConfig

    # one request a batch: the JAX batch runs one vmapped chunk schedule
    # for all its members, the port one schedule per member
    gs = [port_graph(6, s) for s in range(4)] + [port_graph(5, 0)]
    svc = CensusService(ServiceConfig(max_batch=1, census=cfg("search")))
    jsvc = JService(JServiceConfig(max_batch=1,
                                   census=JConfig(backend="xla", **SMALL)))
    for g in gs:
        svc.submit(g)
        jsvc.submit(jax_graph(g))
    svc.flush()
    jsvc.flush()
    jclear()
    assert svc.stats()["devices"] == jsvc.stats()["devices"]
    pool = CensusService(ServiceConfig(max_batch=8, census=cfg(
        "tiles", schedule="dynamic", n_executor_devices=3,
        fault_plan=JITTER)))
    done = pool.run_fleet(gs)
    for res, g in zip(done, gs):
        np.testing.assert_array_equal(res.counts, brute_force_census(g).counts)
    st = pool.stats()
    assert sum(st["devices"].values()) == sum(
        b["chunks"] for b in st["buckets"].values())
    assert len(st["devices"]) > 1 and set(st["devices"]) <= {0, 1, 2}


def test_workqueue_stress_loses_no_fold():
    """16 CPU slots (twice the cores) over 2,000 one-bin tasks with a short
    switch interval: every fold and every counter lands exactly once."""
    conf = EngineConfig(device="cpu", schedule="dynamic",
                        n_executor_devices=16)
    stats = {"chunks": 0, "device_chunks": {}, "faults": dict.fromkeys(
        ("chunk_failures", "retries", "device_losses", "quarantines",
         "backend_fallbacks", "schedule_fallbacks"), 0), "fault_events": []}
    ex = Executor(conf, stats, [torch.device("cpu")] * 16, backend="search")
    tasks = [ChunkTask(i, i + 1) for i in range(2000)]
    acc = torch.zeros(3, dtype=torch.int64)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=ex.run, kwargs=dict(
            tasks=tasks, place=lambda dev: None,
            step=lambda ctx, t: torch.tensor([1, t.start, 2]), init=acc))
        th.start()
        th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive()
    assert acc.tolist() == [2000, sum(range(2000)), 4000]
    assert stats["chunks"] == sum(stats["device_chunks"].values()) == 2000


# -- the bucket-wide schedule ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def wide_graph():
    """An R-MAT whose largest degree bucket holds more than 8,192 dyads
    (15,251 of 26,654 in the 512 bucket)."""
    return tgen.rmat(12, edge_factor=8, seed=0, device="cpu")


@functools.lru_cache(maxsize=None)
def wide_search_raw():
    g = wide_graph()
    return compile(g, ("triad_census",), EngineConfig(
        backend="search", device="cpu")).run_raw(g)


def census_calls(monkeypatch):
    """Record ``(lanes, live dyads, k)`` of every ``census_csr`` call of
    the tiles chunk unit."""
    calls = []

    def recorded(u, v, n, arrays, *, k, block):
        calls.append((u.shape[0], int((u != SENTINEL).sum()), k))
        return census_csr(u, v, n, arrays, k=k, block=block)

    monkeypatch.setattr(backends, "census_csr", recorded)
    return calls


def fixed_chunks(ks, counts, chunk):
    """The static schedule's fixed-size chunks, ``(start, end, K)``: each
    runs ``chunk`` lanes from its start, and its end is its bucket's."""
    out, off = [], 0
    for K, c in zip(ks, counts):
        out += [(s, off + c, K) for s in range(off, off + c, chunk)]
        off += int(c)
    return out


@pytest.mark.parametrize("counts", [
    (2970, 7536, 15251, 897), (0, 100, 0, 5), (40, 3, 3, 70), (64, 0, 0, 0),
    (5, 0, 0, 0), (0, 0, 0, 33)])
def test_bucket_spans_cover_the_stream_one_task_a_bucket(counts):
    """One task per bucket of at least a block, contiguous over the
    stream, every edge but the last on a whole block, and each task's
    width at least the bucket of every dyad it holds."""
    ks, block = (32, 128, 512, 1024), 32
    tasks = _bucket_spans(ks, counts, block)
    assert tasks == _bucket_tasks(ks, counts, None, block=block)
    assert tasks[0].start == 0 and tasks[-1].end == sum(counts)
    assert all(a.end == b.start for a, b in zip(tasks, tasks[1:]))
    assert all(t.end % block == 0 for t in tasks[:-1])
    assert len(tasks) <= sum(1 for c in counts if c)
    if all(c >= block for c in counts if c):
        assert [t.key for t in tasks] == [K for K, c in zip(ks, counts) if c]
    edges = np.cumsum(counts)
    for t in tasks:  # the bucket of the task's last dyad bounds all of it
        assert ks[int(np.searchsorted(edges, t.end - 1, side="right"))] \
            <= t.key
        assert t.cost == float(t.key * (t.end - t.start))


def test_default_census_plan_launches_once_per_bucket(monkeypatch):
    """The default tiles census: one task and one launch per non-empty
    bucket, each launch at most its dyads plus block - 1 sentinel lanes,
    counted in ``bucket_passes``; bins equal the search backend's and an
    explicit 8,192-dyad plan's; a batch equals single runs."""
    g = wide_graph()
    plan = compile(g, ("triad_census",), EngineConfig(backend="tiles",
                                                      device="cpu"))
    block, chunk, ks = tiles_geometry(plan)
    assert chunk is None and backends.bucket_wide(plan)
    counts, _ = host_bucket_schedule(g, ks, with_needs=False)
    assert max(counts) > 8192
    tasks = backends.tiles_stream(plan, g).tasks
    assert [t.key for t in tasks] == [K for K, c in zip(ks, counts) if c]
    assert (tasks[0].start, tasks[-1].end) == (0, g.n_dyads)
    calls = census_calls(monkeypatch)
    raw = plan.run_raw(g)
    assert [k for _, _, k in calls] == [t.key for t in tasks]
    assert all(lanes % block == 0 and lanes - live < block
               and live == t.end - t.start
               for (lanes, live, _), t in zip(calls, tasks))
    assert plan.stats["chunks"] == len(tasks)
    assert plan.stats["bucket_passes"] == 1
    np.testing.assert_array_equal(raw, wide_search_raw())
    chunked = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device="cpu", chunk_dyads=8192))
    np.testing.assert_array_equal(chunked.run_raw(g), raw)
    g2 = tgen.rmat(12, edge_factor=8, seed=1, device="cpu")
    batch = plan.run_batch([g, g2])
    assert plan.stats["bucket_passes"] == 3
    for res, one, gi in zip(batch, (raw, plan.run_raw(g2)), (g, g2)):
        np.testing.assert_array_equal(
            res["triad_census"].counts,
            plan.layout.finalize(one, gi)["triad_census"].counts)
    entry, = (e for e in plan_cache_stats()["entries"]
              if e["bucket_passes"])
    assert entry["bucket_passes"] == 4 and "chunks" in entry


@pytest.mark.parametrize("case", ["chunk_dyads", "dynamic", "dynamic_pool",
                                  "two_slots", "dyad_census", "search"])
def test_chunked_schedules_keep_their_task_lists(case):
    """Every plan outside the bucket-wide schedule keeps the task list it
    had: fixed 8,192-dyad chunks per bucket (search: over the stream),
    equal-need chunks under the dynamic schedule."""
    g = wide_graph()
    kw = dict(chunk_dyads=dict(chunk_dyads=8192), dynamic=dict(
        schedule="dynamic"), dynamic_pool=dict(
        schedule="dynamic", n_executor_devices=2)).get(case, {})
    ops = (("triad_census", "dyad_census") if case == "dyad_census"
           else ("triad_census",))
    plan = compile(g, ops, EngineConfig(
        backend="search" if case == "search" else "tiles", device="cpu",
        **kw))
    if case == "two_slots":  # a static plan handed a wider pool
        plan.executor.devices = [torch.device("cpu")] * 2
    assert not backends.bucket_wide(plan) and plan.chunk == 8192
    if case == "search":
        u, v = canonical_dyads(g)
        got = _search_tasks(plan, g, u, v, plan.chunk)
        assert [(t.start, t.end) for t in got] == [
            (s, min(s + 8192, g.n_dyads)) for s in range(0, g.n_dyads, 8192)]
    else:
        block, chunk, ks = tiles_geometry(plan)
        assert chunk == 8192
        got = backends.tiles_stream(plan, g).tasks
        counts, need = host_bucket_schedule(g, ks, with_needs=True)
        if case.startswith("dynamic"):
            assert got == _bucket_tasks(ks, counts, chunk, need)
        else:
            assert [(t.start, t.end, t.key) for t in got] == fixed_chunks(
                ks, counts, chunk)
    raw = plan.run_raw(g)
    assert plan.stats["bucket_passes"] == 0
    assert plan.stats["chunks"] == len(got) >= 4
    np.testing.assert_array_equal(
        raw[plan.layout.slices["triad_census"]], wide_search_raw())


@pytest.mark.parametrize("fault", ["injected", "kernel"])
def test_bucket_task_retry_folds_once(monkeypatch, fault):
    """A failed bucket-wide task folds nothing and its retry folds the
    whole bucket once: bins bit-identical to the clean run."""
    g = wide_graph()
    fp = FaultPlan(chunk_failure_rate=1.0) if fault == "injected" else None
    plan = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device="cpu", fault_plan=fp or FaultPlan()))
    assert backends.bucket_wide(plan)
    if fault == "kernel":  # the third bucket's first launch fails late
        failed = []

        def flaky(u, v, n, arrays, *, k, block):
            out = census_csr(u, v, n, arrays, k=k, block=block)
            if k == 512 and not failed:
                failed.append(k)
                raise RuntimeError("census_csr launch failed: injected")
            return out

        monkeypatch.setattr(backends, "census_csr", flaky)
    raw = plan.run_raw(g)
    np.testing.assert_array_equal(raw, wide_search_raw())
    tasks = backends.tiles_stream(plan, g).tasks
    faults = plan.stats["faults"]
    assert faults["retries"] == (len(tasks) if fp else 1)
    assert faults["chunk_failures"] == (len(tasks) if fp else 0)
    assert plan.stats["chunks"] == len(tasks)
    assert plan.stats["bucket_passes"] == 1


@pytest.mark.parametrize("path", ["delta", "partitions", "distributed"])
def test_subset_passes_take_the_bucket_schedule(monkeypatch, path):
    """Subset passes (a delta's affected dyads, partition shards, a
    rank's row) go bucket-wide under the same test and keep their bins."""
    from repro_torch.core.delta import GraphDelta, apply_delta_csr

    g = wide_graph()
    kw = dict(partitions=dict(partitions=2),
              distributed=dict(backend="distributed")).get(path, {})
    plan = compile(g, ("triad_census",), EngineConfig(**{
        "backend": "tiles", "device": "cpu", "delta_threshold": 1.0, **kw}))
    assert backends.bucket_wide(plan)
    if path == "delta":
        d = GraphDelta(edges_added=[(0, 5), (7, 3), (4000, 9)],
                       edges_removed=[tuple(int(x) for x in
                                            np.stack(arcs_host(g))[:, 0])])
        g_new = apply_delta_csr(g, d)
        want = compile(g_new, ("triad_census",), EngineConfig(
            backend="tiles", device="cpu", chunk_dyads=8192)).run_raw(g_new)
        calls = census_calls(monkeypatch)
        out = plan.apply_delta(g, d, wide_search_raw())
        assert out.mode == "delta"
        raw, passes = out.raw, 2  # the affected dyads of both graphs
    else:
        calls = census_calls(monkeypatch)
        raw, want = plan.run_raw(g), wide_search_raw()
        passes = 1
    np.testing.assert_array_equal(raw, want)
    _, _, ks = tiles_geometry(plan)
    assert plan.stats["bucket_passes"] == passes
    assert plan.stats["chunks"] == len(calls)
    assert len(calls) <= len(ks) * passes * plan.partitions
    assert all(lanes - live < plan.config.resolve_block()
               for lanes, live, _ in calls)


@pytest.mark.cuda
def test_cuda_dynamic_schedule_equals_static(cuda_device):
    g = tgen.rmat(10, edge_factor=8, seed=0, device=cuda_device)
    static = compile(g, ALL_OPS, EngineConfig(backend="tiles",
                                              device=cuda_device))
    plan = compile(g, ALL_OPS, EngineConfig(backend="tiles",
                                            device=cuda_device,
                                            schedule="dynamic"))
    census_csr.launches = 0
    raw = plan.run_raw(g)
    assert census_csr.launches == plan.stats["chunks"] > 0
    np.testing.assert_array_equal(raw, static.run_raw(g))
    assert plan.stats["host_syncs"] == 1
    assert plan.stats["device_chunks"] == {0: plan.stats["chunks"]}
