"""The port's batched runs and census service against the JAX package:
``Plan.run_batch`` equals sequential runs in one counted copy per batch;
the port's ``GraphMeta`` groups a fleet as JAX's does; and under the same
``ServiceConfig`` the port's ``CensusService`` (tiles and search, on the
CPU) completes the same request ids in the same order with results equal
to the JAX service's (xla), through eager and stale flushes, admission
control, deadlines and a poisoned member.

The JAX package is imported inside the tests that compare with it, so
the CUDA case runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_service.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.engine import (EngineConfig, GraphMeta, clear_plan_cache,
                                compile, plan_cache_stats, poison)
from repro_torch.kernels.triad_census import census_csr
from repro_torch.serve import CensusService, ServiceConfig

# a fleet over three buckets, by index: six rmat 5 graphs of one bucket
# and several sizes, four er 40 and two rmat 6
FLEET = ([("rmat", 5, s) for s in (0, 2, 3, 4, 6, 7)]
         + [("er", 40, s) for s in range(4)]
         + [("rmat", 6, s) for s in range(2)])
MIXED = ("triad_census", "degree_stats")


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


def _graph(gen, spec, **dev):
    kind, size, seed = spec
    if kind == "rmat":
        return gen.rmat(size, edge_factor=4, seed=seed, **dev)
    return gen.erdos_renyi(size, 3 * size, seed=seed, **dev)


def _norm(x):
    """A result as plain python values, comparable across the packages."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return (type(x).__name__, tuple(_norm(a) for a in x))
    if isinstance(x, np.ndarray):
        return tuple(x.tolist())
    if isinstance(x, np.integer):
        return int(x)
    return x


def _log(completions):
    return [(c.request_id, c.ops, _norm(c.result),
             type(c.error).__name__ if c.error is not None else None)
            for c in completions]


# -- scenarios: the same calls on either package's service -------------------
# each takes (svc, graphs, poison) and returns its event log


def _max_wait_zero(svc, gs, poison):
    return [_log(svc.poll()) for g in gs[:4] if svc.submit(g) is not None]


def _eager_full_batches(svc, gs, poison):
    log = []
    for i in range(5):
        svc.submit(gs[i], MIXED if i % 2 else None)
        log.append(_log(svc.poll()))
    svc.submit(gs[5], MIXED)
    return log + [_log(svc.flush())]


def _bounded_staleness(svc, gs, poison):
    log = []
    for i in (0, 6, 1, 7, 10, 2, 8, 3):
        svc.submit(gs[i], ("dyad_census",) if i == 10 else None)
        log.append(_log(svc.poll()))
    return log + [_log(svc.flush())]


def _admission(svc, gs, poison):
    log = []
    for i in (0, 6, 10, 1, 7, 2):
        try:
            svc.submit(gs[i])
            log.append("ok")
        except RuntimeError as e:
            log.append(type(e).__name__)
        log.append(_log(svc.poll()))
    return log + [_log(svc.flush())]


def _deadlines(svc, gs, poison):
    svc.submit(gs[10], deadline_rounds=0)   # its own bucket, waits
    svc.submit(gs[6], deadline_rounds=3)
    svc.submit(gs[0])
    svc.submit(gs[1])                       # flushes the rmat-5 pair
    log = [_log(svc.poll())]
    svc.submit(gs[2])                       # the round passed: 10 expires
    log.append(_log(svc.poll()))
    return log + [_log(svc.flush())]


def _poisoned_member(svc, gs, poison):
    poison(gs[2])
    log = []
    for i in range(4):
        svc.submit(gs[i], MIXED)
        log.append(_log(svc.poll()))
    log.append(_log(svc.flush()))
    return log + [svc.stats()["health"]["poisoned"]]


SCENARIOS = {
    "max_wait_0": (dict(max_batch=8, max_wait_requests=0), _max_wait_zero),
    "eager_full": (dict(max_batch=2, max_wait_requests=100),
                   _eager_full_batches),
    "staleness": (dict(max_batch=100, max_wait_requests=2),
                  _bounded_staleness),
    "reject": (dict(max_batch=8, max_wait_requests=100, max_pending=3),
               _admission),
    "flush_oldest": (dict(max_batch=8, max_wait_requests=100, max_pending=3,
                          reject_policy="flush_oldest"), _admission),
    "deadlines": (dict(max_batch=2, max_wait_requests=100), _deadlines),
    "poisoned": (dict(max_batch=4, max_wait_requests=100), _poisoned_member),
}


def _bucket_counts(stats):
    """Per-bucket counters both services keep, keyed by the meta's fields."""
    keys = ("requests", "batches", "batched_graphs", "host_syncs",
            "occupancy")
    return {tuple(dataclasses.asdict(m).values()):
            ({k: st[k] for k in keys}, {o: c for o, c in st["by_ops"].items()})
            for m, st in stats["buckets"].items()}


@functools.lru_cache(maxsize=None)
def _jax_scenario(name):
    pytest.importorskip("jax")
    from repro.core import generators as jgen
    from repro.engine import CensusConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import poison as jpoison
    from repro.serve import CensusService as JService
    from repro.serve import ServiceConfig as JServiceConfig

    kwargs, script = SCENARIOS[name]
    jclear()
    svc = JService(JServiceConfig(census=JConfig(backend="xla"), **kwargs))
    gs = [_graph(jgen, s) for s in FLEET]
    log = script(svc, gs, jpoison)
    out = (log, _bucket_counts(svc.stats()), svc.stats()["rounds"])
    jclear()
    return out


@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_service_completes_as_the_jax_service(scenario, backend):
    kwargs, script = SCENARIOS[scenario]
    svc = CensusService(ServiceConfig(
        census=EngineConfig(backend=backend, device="cpu"), **kwargs))
    gs = [_graph(tgen, s, device="cpu") for s in FLEET]
    log = script(svc, gs, poison)
    want_log, want_buckets, want_rounds = _jax_scenario(scenario)
    assert log == want_log
    st = svc.stats()
    assert _bucket_counts(st) == want_buckets
    assert st["rounds"] == want_rounds and st["pending"] == 0
    assert set(st["health"]) == {"retries", "quarantines",
                                 "backend_fallbacks", "schedule_fallbacks",
                                 "rejections", "poisoned", "expired",
                                 "batch_failures", "group_failures",
                                 "mutate_failures"}
    assert all(st["health"][k] == 0 for k in (
        "retries", "quarantines", "backend_fallbacks", "schedule_fallbacks"))
    # every completed census equals the oracle
    for entry in log:
        for rid, ops, res, err in (entry if isinstance(entry, list) else ()):
            if err is None and ops[0] == "triad_census":
                census = res["triad_census"] if len(ops) > 1 else res
                want = brute_force_census(gs[_submitted(scenario)[rid]])
                assert census[1][0] == tuple(want.counts.tolist())


def _submitted(scenario):
    """Fleet index of each request id, in submission order."""
    return {"max_wait_0": [0, 1, 2, 3], "eager_full": [0, 1, 2, 3, 4, 5],
            "staleness": [0, 6, 1, 7, 10, 2, 8, 3],
            "reject": [0, 6, 10, 1, 7, 2], "flush_oldest": [0, 6, 10, 1, 7, 2],
            "deadlines": [10, 6, 0, 1, 2],
            "poisoned": [0, 1, 2, 3]}[scenario]


def _port_log(scenario):
    kwargs, script = SCENARIOS[scenario]
    svc = CensusService(ServiceConfig(
        census=EngineConfig(backend="tiles", device="cpu"), **kwargs))
    return script(svc, [_graph(tgen, s, device="cpu") for s in FLEET], poison)


def test_reject_scenario_rejects_and_poisoned_scenario_isolates():
    """Two of the scenarios above do what they are named for."""
    assert _port_log("reject").count("AdmissionError") == 3
    log = _port_log("poisoned")
    done = [c for entry in log[:-1] for c in entry]
    assert [err for _, _, _, err in done].count("InjectedFault") == 1
    assert len(done) == 4 and log[-1] == 1


def test_graph_meta_groups_a_fleet_as_jax_does():
    pytest.importorskip("jax")
    from repro.core import generators as jgen
    from repro.engine import GraphMeta as JMeta

    fleet = FLEET + [("er", 48, 9), ("rmat", 7, 3)]
    port = [dataclasses.asdict(GraphMeta.from_graph(
        _graph(tgen, s, device="cpu"), k=k))
        for s in fleet for k in (None, 64)]
    jax = [dataclasses.asdict(JMeta.from_graph(_graph(jgen, s), k=k))
           for s in fleet for k in (None, 64)]
    assert port == jax
    assert len({tuple(m.values()) for m in port}) >= 4


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_run_batch_equals_sequential_runs_in_one_sync(backend):
    gs = [_graph(tgen, s, device="cpu") for s in FLEET[:6]]
    metas = {GraphMeta.from_graph(g) for g in gs}
    assert len(metas) == 1 and len({g.n_dyads for g in gs}) > 1
    cfg = EngineConfig(backend=backend, device="cpu", batch=16,
                       chunk_dyads=64)
    plan = compile(gs[0], ("triad_census", "dyad_census", "degree_stats"),
                   cfg)
    seq = [plan.run_raw(g) for g in gs]
    syncs = plan.stats["host_syncs"]
    for batch in (gs[:1], gs):
        got = plan.run_batch(batch)
        assert plan.stats["host_syncs"] == syncs + 1
        syncs += 1
        for g, res, raw in zip(batch, got, seq):
            assert _norm(res) == _norm(plan.layout.finalize(raw, g))
            np.testing.assert_array_equal(res["triad_census"].counts,
                                          brute_force_census(g).counts)
    assert (plan.stats["batch_runs"], plan.stats["batch_graphs"]) == (2, 7)
    entry, = plan_cache_stats()["entries"]
    assert (entry["batch_runs"], entry["batch_graphs"], entry["runs"]) == (
        2, 7, 13)
    assert plan.run_batch([]) == []
    view = compile(gs[0], ("triad_census",), cfg).census_view()
    for g, res in zip(gs, view.run_batch(gs)):
        np.testing.assert_array_equal(res.counts,
                                      brute_force_census(g).counts)


def test_run_batch_chunks_are_the_members_chunks():
    gs = [_graph(tgen, s, device="cpu") for s in FLEET[:4]]
    plan = compile(gs[0], ("triad_census",), EngineConfig(
        backend="tiles", device="cpu", batch=16, chunk_dyads=64))
    per = []
    for g in gs:
        before = plan.stats["chunks"]
        plan.run_raw(g)
        per.append(plan.stats["chunks"] - before)
    before = plan.stats["chunks"]
    plan.run_batch(gs)
    assert plan.stats["chunks"] - before == sum(per)


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_stats_per_bucket_counters(backend):
    svc = CensusService(ServiceConfig(max_batch=3, max_wait_requests=100,
                                      census=EngineConfig(backend=backend,
                                                          device="cpu")))
    gs = [_graph(tgen, s, device="cpu") for s in FLEET]
    out = svc.run_fleet(gs[:7] + gs[10:], ops=MIXED)
    for g, res in zip(gs[:7] + gs[10:], out):
        np.testing.assert_array_equal(res["triad_census"].counts,
                                      brute_force_census(g).counts)
    st = svc.stats()
    by_meta = {m.n_bucket: b for m, b in st["buckets"].items()}
    rmat5 = by_meta[32]
    assert (rmat5["requests"], rmat5["batches"], rmat5["batched_graphs"],
            rmat5["host_syncs"]) == (6, 2, 6, 2)
    assert rmat5["occupancy"] == 1.0 and rmat5["by_ops"] == {MIXED: 6}
    plans = {p.meta.n_bucket: p for p in _cached_plans()}
    assert rmat5["chunks"] == plans[32].stats["chunks"]
    assert st["batches"] == sum(b["batches"] for b in st["buckets"].values())
    assert st["requests"] == 9 and st["mean_batch"] == 9 / st["batches"]


def _cached_plans():
    from repro_torch.engine import plan as tplan
    return list(tplan._PLAN_CACHE.values())


@pytest.mark.cuda
def test_cuda_run_batch_and_service_equal_single_runs(cuda_device):
    gs = [tgen.rmat(9, edge_factor=8, seed=s, device=cuda_device)
          for s in range(6)]
    cfg = EngineConfig(backend="tiles", device=cuda_device)
    svc = CensusService(ServiceConfig(max_batch=4, max_wait_requests=100,
                                      census=cfg))
    before = census_csr.launches
    out = svc.run_fleet(gs, ops=MIXED)
    st = svc.stats()
    assert census_csr.launches - before == sum(
        b["chunks"] for b in st["buckets"].values())
    assert all(b["host_syncs"] == b["batches"]
               for b in st["buckets"].values())
    for g, res in zip(gs, out):
        plan = compile(g, MIXED, cfg)
        assert _norm(res) == _norm(plan.run(g))
        search = compile(g, MIXED, dataclasses.replace(cfg, backend="search"))
        assert _norm(res) == _norm(search.run(g))
