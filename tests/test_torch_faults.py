"""Fault injection and recovery in the port against the JAX package:
``FaultPlan`` decisions and the ``fault_events`` trace equal the JAX ones
for the same seed (backend names mapped ``pallas → tiles``, ``xla →
search``); recovered runs are bit-identical with one copy; retry
exhaustion, device loss and the ``dynamic → static`` rung, the
``tiles → search`` rungs at compile and at run time (on only when asked:
the port's ``backend_fallback`` defaults to ``False``), the environment
hook, and the service's health counters, per-slot counts, dead groups
and session rollback behave as in the JAX package.  A chunk whose census
launch fails after the other ops ran folds exactly once on its retry, and
a kernel build error is never retried or demoted.  Small R-MAT graphs
built in both packages from the same arc arrays; tolerance 0."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.delta import GraphDelta, apply_delta_csr
from repro_torch.core.graph import arcs_host
from repro_torch.engine import (ChunkRetryError, DeviceLostError,
                                EngineConfig, FaultPlan, InjectedFault,
                                PoolExhaustedError, WorkerFailures,
                                clear_plan_cache, compile, plan_cache_stats,
                                resolve_faults)
from repro_torch.engine import backends
from repro_torch.engine import faults as tfaults
from repro_torch.engine.executor import _raise_worker_errors
from repro_torch.kernels._build import KernelBuildError
from repro_torch.serve import CensusService, ServiceConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMALL = dict(batch=16, chunk_dyads=64)
CLEAN = FaultPlan()
CHAOS = FaultPlan(seed=3, chunk_failure_rate=0.5, fail_attempts=1)
#: the JAX backend names of the port's backends
JAX_NAME = {"tiles": "pallas", "search": "xla"}
PORT_NAME = {v: k for k, v in JAX_NAME.items()}


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_plan_cache()
    yield
    clear_plan_cache()


def graph(scale=6, seed=11):
    return tgen.rmat(scale, edge_factor=4, seed=seed, device="cpu")


def jax_graph(g):
    from repro.core.graph import from_edges

    return from_edges(g.n, *arcs_host(g), directed=True)


def cfg(backend, **kw):
    return EngineConfig(backend=backend, device="cpu", **{**SMALL, **kw})


def jax_fault_plan(fp):
    from repro.engine import FaultPlan as JFaultPlan

    return JFaultPlan(**{
        **fp.__dict__,
        "compile_failure": tuple(JAX_NAME[b] for b in fp.compile_failure),
        "runtime_failure": tuple(JAX_NAME[b] for b in fp.runtime_failure)})


def mapped(events):
    """A JAX fault trace with backend names in the port's words."""
    return [tuple(PORT_NAME.get(x, x) if isinstance(x, str) else x
                  for x in e) for e in events]


# -- FaultPlan: validation, decisions, resolution --------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(chunk_failure_rate=1.5), "chunk_failure_rate"),
    (dict(slow_chunk_rate=-0.1), "slow_chunk_rate"),
    (dict(fail_attempts=0), "fail_attempts"),
    (dict(device_loss=(-1,)), "device_loss"),
    (dict(device_loss_after=-1), "device_loss_after"),
    (dict(compile_failure=("pallas",)), "unknown backends"),
    (dict(runtime_failure=("xla",)), "unknown backends"),
    (dict(mutate_failure_calls=(-2,)), "mutate_failure_calls"),
    (dict(slow_s=-1.0), "slow_s"),
])
def test_fault_plan_validation_uses_the_port_names(kwargs, match):
    with pytest.raises(ValueError, match=match):
        FaultPlan(**kwargs)


@pytest.mark.parametrize("kwargs,match", [
    (dict(backend_fallback="yes"), "backend_fallback"),
    (dict(fault_plan="chaos"), "fault_plan"),
])
def test_engine_config_fault_knobs_validated(kwargs, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kwargs)


def test_backend_fallback_is_off_by_default():
    assert EngineConfig().backend_fallback is False
    assert EngineConfig().schedule_fallback is True
    assert EngineConfig().max_attempts == 3


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_decisions_equal_jax_bit_for_bit(seed):
    pytest.importorskip("jax")
    from repro.engine import faults as jfaults

    fp = FaultPlan(seed=seed, chunk_failure_rate=0.3, fail_attempts=2,
                   device_loss=[1, 2], device_loss_after=3,
                   slow_chunk_rate=0.4, mutate_failure_calls=[1],
                   runtime_failure=["tiles"], compile_failure=["search"])
    jfp = jax_fault_plan(fp)
    assert fp == FaultPlan(**{**fp.__dict__}) and hash(fp) == hash(
        FaultPlan(**fp.__dict__))
    for start in range(0, 5000, 37):
        for coord in ("chunk", "slow"):
            assert (tfaults._hash01(seed, coord, start)
                    == jfaults._hash01(seed, coord, start))
        for attempt in (1, 2, 3):
            assert fp.chunk_fails(start, attempt) == jfp.chunk_fails(
                start, attempt)
    for dev in range(4):
        for ordinal in range(6):
            assert fp.device_lost(dev, ordinal) == jfp.device_lost(dev,
                                                                   ordinal)
    assert [fp.mutate_fails(i) for i in range(3)] == [
        jfp.mutate_fails(i) for i in range(3)]
    assert fp.runtime_fails("tiles") and jfp.runtime_fails("pallas")
    assert fp.compile_fails("search") and jfp.compile_fails("xla")
    assert not fp.is_inert and FaultPlan().is_inert


def test_inert_plan_resolution():
    assert resolve_faults(CLEAN) is None
    assert resolve_faults(CHAOS) is CHAOS


# -- recovery --------------------------------------------------------------------

@pytest.mark.parametrize("schedule,pool", [("static", 1), ("dynamic", 1),
                                           ("dynamic", 4)])
@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_recovered_run_bit_identical_one_copy(backend, schedule, pool):
    g = graph()
    ops = ("triad_census", "dyad_census")
    plan = compile(g, ops, cfg(backend, schedule=schedule,
                               n_executor_devices=pool, fault_plan=CHAOS))
    raw = plan.run_raw(g)
    clean = compile(g, ops, cfg(backend, fault_plan=CLEAN)).run_raw(g)
    np.testing.assert_array_equal(raw, clean)
    np.testing.assert_array_equal(plan.layout.finalize(raw, g)[
        "triad_census"].counts, brute_force_census(g).counts)
    fs = plan.stats["faults"]
    assert fs["chunk_failures"] == fs["retries"] > 0
    assert plan.stats["host_syncs"] == 1
    assert sum(plan.stats["device_chunks"].values()) == plan.stats["chunks"]
    assert not plan.degradation


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_fault_trace_equals_jax(backend):
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    g = graph(5, 0) if backend == "tiles" else graph()
    jg = jax_graph(g)
    fp = FaultPlan(seed=5, chunk_failure_rate=0.6, fail_attempts=2)
    plan = compile(g, ("triad_census",), cfg(backend, fault_plan=fp))
    jplan = jcompile(jg, ("triad_census",), JConfig(
        backend=JAX_NAME[backend], fault_plan=jax_fault_plan(fp), **SMALL))
    np.testing.assert_array_equal(plan.run_raw(g), jplan.run_raw(jg))
    assert plan.stats["fault_events"] == mapped(jplan.stats["fault_events"])
    assert plan.stats["faults"] == jplan.stats["faults"]
    assert plan.stats["device_chunks"] == jplan.stats["device_chunks"]
    jclear()


def test_retry_exhaustion_raises_chunk_retry_error():
    g = graph()
    plan = compile(g, ("triad_census",), cfg(
        "search", max_attempts=2, fault_plan=FaultPlan(
            seed=3, chunk_failure_rate=0.5, fail_attempts=99)))
    with pytest.raises(ChunkRetryError) as exc:
        plan.run(g)
    assert len(exc.value.attempts) == 2
    assert isinstance(exc.value.__cause__, InjectedFault)


def test_max_attempts_one_disables_retry():
    g = graph()
    plan = compile(g, ("triad_census",), cfg("tiles", max_attempts=1,
                                             fault_plan=CHAOS))
    with pytest.raises(ChunkRetryError):
        plan.run(g)
    assert plan.stats["faults"]["retries"] == 0


@pytest.mark.parametrize("after", [0, 2])
@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_device_loss_takes_the_static_rung(backend, after):
    g = graph()
    plan = compile(g, ("triad_census",), cfg(
        backend, schedule="dynamic", n_executor_devices=1,
        fault_plan=FaultPlan(seed=1, device_loss=(0,),
                             device_loss_after=after)))
    raw = plan.run_raw(g)
    np.testing.assert_array_equal(
        plan.layout.finalize(raw, g)["triad_census"].counts,
        brute_force_census(g).counts)
    fs = plan.stats["faults"]
    assert fs["device_losses"] == 1 and fs["schedule_fallbacks"] == 1
    assert plan.stats["host_syncs"] == 1
    assert ("schedule_fallback", "dynamic->static") in plan.stats[
        "fault_events"]


def test_lost_slot_is_quarantined_and_survivors_finish():
    g = graph(7, 2)
    plan = compile(g, ("triad_census", "dyad_census"), cfg(
        "tiles", schedule="dynamic", n_executor_devices=4,
        fault_plan=FaultPlan(device_loss=(2,), slow_chunk_rate=1.0,
                             slow_s=0.002)))
    raw = plan.run_raw(g)
    np.testing.assert_array_equal(raw, compile(g, (
        "triad_census", "dyad_census"), cfg("tiles")).run_raw(g))
    fs = plan.stats["faults"]
    assert fs["device_losses"] == fs["quarantines"] == 1
    assert fs["schedule_fallbacks"] == 0
    assert 2 not in plan.stats["device_chunks"]
    assert sum(plan.stats["device_chunks"].values()) == plan.stats["chunks"]


def test_whole_pool_lost_takes_the_rung_or_surfaces():
    g = graph()
    lost = FaultPlan(device_loss=(0, 1, 2))
    plan = compile(g, ("triad_census",), cfg(
        "search", schedule="dynamic", n_executor_devices=3, fault_plan=lost))
    np.testing.assert_array_equal(
        plan.run(g)["triad_census"].counts, brute_force_census(g).counts)
    assert plan.stats["faults"]["schedule_fallbacks"] == 1
    assert plan.stats["faults"]["quarantines"] == 3
    strict = compile(g, ("triad_census",), cfg(
        "search", schedule="dynamic", n_executor_devices=3, fault_plan=lost,
        schedule_fallback=False))
    with pytest.raises(PoolExhaustedError):
        strict.run(g)
    one = compile(g, ("triad_census",), cfg(
        "search", schedule="dynamic", schedule_fallback=False,
        fault_plan=FaultPlan(device_loss=(0,))))
    with pytest.raises(ChunkRetryError) as exc:
        one.run(g)
    assert isinstance(exc.value.__cause__, DeviceLostError)


# -- the tiles -> search rungs ---------------------------------------------------

def test_compile_rung_demotes_when_enabled_and_raises_by_default():
    g = graph()
    fp = FaultPlan(compile_failure=("tiles",))
    with pytest.raises(InjectedFault):
        compile(g, ("triad_census",), cfg("tiles", fault_plan=fp))
    plan = compile(g, ("triad_census",), cfg("tiles", fault_plan=fp,
                                             backend_fallback=True))
    assert (plan.requested_backend, plan.backend) == ("tiles", "search")
    assert plan.degradation[0]["rung"] == "tiles->search"
    assert plan.degradation[0]["stage"] == "compile"
    np.testing.assert_array_equal(plan.run(g)["triad_census"].counts,
                                  brute_force_census(g).counts)
    assert plan.stats["faults"]["backend_fallbacks"] == 1
    entry = plan_cache_stats()["entries"][-1]
    assert entry["degradation"][0]["stage"] == "compile"
    assert entry["requested_backend"] == "tiles"


@pytest.mark.parametrize("schedule,pool", [("static", 1), ("dynamic", 3)])
def test_runtime_rung_demotes_when_enabled_and_raises_by_default(schedule,
                                                                 pool):
    g = graph()
    fp = FaultPlan(runtime_failure=("tiles",))
    strict = compile(g, ("triad_census",), cfg(
        "tiles", fault_plan=fp, schedule=schedule, n_executor_devices=pool))
    with pytest.raises((ChunkRetryError, PoolExhaustedError)):
        strict.run(g)
    assert strict.backend == "tiles" and not strict.degradation
    plan = compile(g, ("triad_census", "degree_stats"), cfg(
        "tiles", fault_plan=fp, backend_fallback=True, schedule=schedule,
        n_executor_devices=pool))
    want = compile(g, ("triad_census", "degree_stats"),
                   cfg("search")).run_raw(g)
    np.testing.assert_array_equal(plan.run_raw(g), want)
    assert plan.backend == "search"
    assert [d["stage"] for d in plan.degradation] == ["runtime"]
    np.testing.assert_array_equal(plan.run_raw(g), want)
    assert plan.stats["faults"]["backend_fallbacks"] == 1
    assert plan.stats["host_syncs"] == 2


def test_runtime_rung_covers_batches():
    g = graph(6, 1)
    src, dst = arcs_host(g)
    gs = [g, apply_delta_csr(g, GraphDelta(edges_removed=[(src[0], dst[0])]))]
    plan = compile(gs[0], ("triad_census",), cfg(
        "tiles", fault_plan=FaultPlan(runtime_failure=("tiles",)),
        backend_fallback=True))
    for res, g in zip(plan.run_batch(gs), gs):
        np.testing.assert_array_equal(res["triad_census"].counts,
                                      brute_force_census(g).counts)
    assert plan.backend == "search" and plan.stats["host_syncs"] == 1


def test_rungs_equal_jax_ladder():
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    g = graph(5, 0)
    jg = jax_graph(g)
    for fp in (FaultPlan(compile_failure=("tiles",)),
               FaultPlan(runtime_failure=("tiles",))):
        plan = compile(g, ("triad_census",), cfg(
            "tiles", fault_plan=fp, backend_fallback=True))
        jplan = jcompile(jg, ("triad_census",), JConfig(
            backend="pallas", fault_plan=jax_fault_plan(fp), **SMALL))
        np.testing.assert_array_equal(plan.run_raw(g), jplan.run_raw(jg))
        assert [(d["rung"], d["stage"]) for d in plan.degradation] == [
            (d["rung"].replace("pallas", "tiles").replace("xla", "search"),
             d["stage"]) for d in jplan.degradation]
        assert plan.stats["faults"] == jplan.stats["faults"]
        assert plan.stats["fault_events"] == mapped(
            jplan.stats["fault_events"])
    jclear()


def test_faulty_and_clean_configs_never_share_plans():
    g = graph()
    faulty = compile(g, ("triad_census",), cfg("search", fault_plan=CHAOS))
    clean = compile(g, ("triad_census",), cfg("search", fault_plan=CLEAN))
    assert faulty is not clean
    assert plan_cache_stats()["size"] == 2


# -- exactly-once folds, build errors, worker errors -----------------------------

def test_failed_census_launch_folds_the_chunk_exactly_once(monkeypatch):
    """census_csr raises on its first call, after the chunk's dyad census
    ran: the retry must not count that dyad census twice."""
    g = graph()
    ops = ("triad_census", "dyad_census")
    want = compile(g, ops, cfg("tiles")).run_raw(g)
    real, calls = backends.census_csr, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("census_csr launch failed: injected")
        return real(*args, **kwargs)

    monkeypatch.setattr(backends, "census_csr", flaky)
    plan = compile(g, ops, cfg("tiles", max_attempts=2))
    np.testing.assert_array_equal(plan.run_raw(g), want)
    assert plan.stats["faults"]["retries"] == 1
    assert plan.stats["faults"]["chunk_failures"] == 0  # not injected
    assert len(calls) == plan.stats["chunks"] + 1


@pytest.mark.parametrize("schedule,pool", [("static", 1), ("dynamic", 3)])
def test_real_launch_failure_is_never_demoted(monkeypatch, schedule, pool):
    """A census_csr launch that fails for real (not by the FaultPlan) is
    retried, then re-raises even with the runtime rung enabled."""
    def failing(*args, **kwargs):
        raise RuntimeError("census_csr launch failed: error 700")

    monkeypatch.setattr(backends, "census_csr", failing)
    g = graph()
    plan = compile(g, ("triad_census",), cfg(
        "tiles", backend_fallback=True, schedule=schedule,
        n_executor_devices=pool))
    with pytest.raises(ChunkRetryError) as exc:
        plan.run(g)
    assert all(not isinstance(a, InjectedFault)
               for a in exc.value.attempts) and exc.value.attempts
    assert plan.backend == "tiles" and not plan.degradation
    assert plan.stats["faults"]["backend_fallbacks"] == 0
    assert plan.stats["faults"]["retries"] > 0


def test_injected_only_reads_every_failure_behind_the_error():
    from repro_torch.engine.executor import injected_only

    real, fake = RuntimeError("launch failed"), InjectedFault("injected")
    assert injected_only(ChunkRetryError("x", attempts=[fake, fake]))
    assert injected_only(PoolExhaustedError(
        "x", attempts=[DeviceLostError("lost"), fake]))
    assert not injected_only(ChunkRetryError("x", attempts=[fake, real]))
    assert not injected_only(PoolExhaustedError("x", attempts=[real]))
    assert not injected_only(PoolExhaustedError("x"))
    chained = ChunkRetryError("x")
    chained.__cause__ = fake
    assert injected_only(chained)


@pytest.mark.parametrize("schedule,pool", [("static", 1), ("dynamic", 3)])
def test_kernel_build_error_is_never_retried_or_demoted(monkeypatch,
                                                        schedule, pool):
    def broken(*args, **kwargs):
        raise KernelBuildError("nvcc failed on census_csr.cu")

    monkeypatch.setattr(backends, "census_csr", broken)
    g = graph()
    plan = compile(g, ("triad_census",), cfg(
        "tiles", backend_fallback=True, schedule=schedule,
        n_executor_devices=pool))
    with pytest.raises(KernelBuildError):
        plan.run(g)
    assert plan.backend == "tiles" and not plan.degradation
    assert not any(plan.stats["faults"].values())


def test_raise_worker_errors_attaches_secondaries():
    e1, e2, e3 = RuntimeError("a"), RuntimeError("b"), RuntimeError("c")
    with pytest.raises(RuntimeError, match="a") as exc:
        _raise_worker_errors([e1, e2, e3])
    assert isinstance(exc.value.__cause__, WorkerFailures)
    assert exc.value.__cause__.errors == [e2, e3]
    with pytest.raises(RuntimeError, match="solo") as exc:
        _raise_worker_errors([RuntimeError("solo")])
    assert exc.value.__cause__ is None


# -- the environment hook --------------------------------------------------------

def _run_with_env(code, value):
    env = {**os.environ, "PYTHONPATH": SRC, tfaults.ENV_VAR: value}
    env.pop("REPRO_FAULT_PLAN", None)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_env_fault_plan_governs_default_configs():
    code = """
import numpy as np
from repro_torch.core import brute_force_census, generators
from repro_torch.engine import EngineConfig, FaultPlan, compile
g = generators.rmat(6, edge_factor=4, seed=11, device="cpu")
cfg = dict(backend="tiles", device="cpu", batch=16, chunk_dyads=64)
env = compile(g, "triad_census", EngineConfig(**cfg))
assert np.array_equal(env.run(g)["triad_census"].counts,
                      brute_force_census(g).counts)
assert env.stats["faults"]["retries"] > 0
opt = compile(g, "triad_census", EngineConfig(fault_plan=FaultPlan(), **cfg))
opt.run(g)
assert opt.stats["faults"]["retries"] == 0
print("ok")
"""
    r = _run_with_env(code, json.dumps(dict(seed=3, chunk_failure_rate=0.5)))
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_env_fault_plan_rejects_malformed_json():
    code = """
from repro_torch.engine import EngineConfig, compile
from repro_torch.core import generators
g = generators.rmat(5, edge_factor=4, seed=0, device="cpu")
compile(g, "triad_census", EngineConfig(device="cpu"))
"""
    for bad in ("{not json", json.dumps(dict(runtime_failure=["pallas"]))):
        r = _run_with_env(code, bad)
        assert r.returncode != 0
        assert tfaults.ENV_VAR in r.stderr, r.stderr


# -- the service -----------------------------------------------------------------

def test_service_health_and_devices_equal_jax():
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.serve import CensusService as JService
    from repro.serve import ServiceConfig as JServiceConfig

    gs = [graph(6, s) for s in (1, 2, 5)]
    svc = CensusService(ServiceConfig(max_batch=1, census=cfg(
        "search", fault_plan=CHAOS)))
    jsvc = JService(JServiceConfig(max_batch=1, census=JConfig(
        backend="xla", fault_plan=jax_fault_plan(CHAOS), **SMALL)))
    for g in gs:
        svc.submit(g)
        jsvc.submit(jax_graph(g))
    done, jdone = svc.flush(), jsvc.flush()
    jclear()
    assert [c.result.counts.tolist() for c in done] == [
        np.asarray(c.result.counts).tolist() for c in jdone]
    st, jst = svc.stats(), jsvc.stats()
    assert st["health"] == jst["health"] and st["health"]["retries"] > 0
    assert st["devices"] == jst["devices"]


def test_dynamic_flush_records_a_dead_group_explicitly():
    small, big = graph(5, 0), graph(7, 5)
    svc = CensusService(ServiceConfig(max_batch=8, census=cfg(
        "tiles", schedule="dynamic", n_executor_devices=2)))
    ok = svc.submit(small)
    doomed = svc.submit(big)
    real = svc._execute_group

    def sabotaged(plan, group):
        if group[0].rid == doomed:
            raise RuntimeError("group thread died mid-flush")
        return real(plan, group)

    svc._execute_group = sabotaged
    comps = {c.request_id: c for c in svc.flush()}
    assert svc.pending == 0
    assert comps[ok].error is None
    np.testing.assert_array_equal(comps[ok].result.counts,
                                  brute_force_census(small).counts)
    assert isinstance(comps[doomed].error, RuntimeError)
    assert comps[doomed].result is None
    assert svc.stats()["health"]["group_failures"] == 1


def test_dynamic_flush_runs_groups_concurrently_and_exactly():
    gs = [graph(5, s) for s in range(3)] + [graph(7, s) for s in range(3)]
    svc = CensusService(ServiceConfig(max_batch=8, census=cfg(
        "search", schedule="dynamic", n_executor_devices=3,
        fault_plan=FaultPlan(seed=2, chunk_failure_rate=0.3,
                             slow_chunk_rate=1.0, slow_s=0.001))))
    out = svc.run_fleet(gs)
    for res, g in zip(out, gs):
        np.testing.assert_array_equal(res.counts, brute_force_census(g).counts)
    st = svc.stats()
    assert st["health"]["retries"] > 0 and st["health"]["quarantines"] >= 0
    assert sum(st["devices"].values()) == sum(
        b["chunks"] for b in st["buckets"].values())


def test_mutate_failure_rolls_the_session_back():
    g = graph(7, 11)
    fp = FaultPlan(mutate_failure_calls=(1,))
    svc = CensusService(ServiceConfig(census=cfg("tiles", fault_plan=fp)))
    sid = svc.subscribe(g)
    ack = svc.mutate(sid, GraphDelta(edges_added=np.array([[0, 1], [2, 3]])))
    assert ack["mode"] != "recompile"  # one plan: its ordinals count on
    want = svc.poll(sid).counts
    d2 = GraphDelta(edges_added=np.array([[6, 7]]))
    with pytest.raises(InjectedFault):
        svc.mutate(sid, d2)
    np.testing.assert_array_equal(svc.poll(sid).counts, want)
    st = svc.stats()
    assert st["sessions"][sid]["failed"] == 1
    assert st["health"]["mutate_failures"] == 1
    svc.mutate(sid, d2)  # the failed ordinal is spent: the retry commits
    assert svc.stats()["sessions"][sid]["mutations"] == 2
    g_now = svc._sessions[sid].graph
    np.testing.assert_array_equal(svc.poll(sid).counts,
                                  brute_force_census(g_now).counts)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_recovery_and_rungs_through_the_kernel(cuda_device):
    from repro_torch.kernels.triad_census import census_csr

    g = tgen.rmat(10, edge_factor=8, seed=1, device=cuda_device)
    ops = ("triad_census", "dyad_census")
    base = dict(backend="tiles", device=cuda_device)
    clean = compile(g, ops, EngineConfig(**base)).run_raw(g)
    for schedule in ("static", "dynamic"):
        plan = compile(g, ops, EngineConfig(
            schedule=schedule, fault_plan=CHAOS, **base))
        census_csr.launches = 0
        np.testing.assert_array_equal(plan.run_raw(g), clean)
        assert census_csr.launches == plan.stats["chunks"] > 0
        assert plan.stats["faults"]["retries"] > 0
        assert plan.stats["host_syncs"] == 1
    broken = FaultPlan(runtime_failure=("tiles",))
    with pytest.raises(ChunkRetryError):
        compile(g, ops, EngineConfig(fault_plan=broken, **base)).run_raw(g)
    plan = compile(g, ops, EngineConfig(fault_plan=broken,
                                        backend_fallback=True, **base))
    census_csr.launches = 0
    np.testing.assert_array_equal(plan.run_raw(g), clean)
    assert census_csr.launches == 0 and plan.backend == "search"


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["static", "dynamic"])
def test_cuda_real_launch_failure_raises_with_the_rung_on(cuda_device,
                                                          monkeypatch,
                                                          schedule):
    """On the card a failing census_csr launch is never replaced by the
    search backend, even with ``backend_fallback=True``."""
    def failing(*args, **kwargs):
        raise RuntimeError("census_csr launch failed: error 700")

    monkeypatch.setattr(backends, "census_csr", failing)
    g = tgen.rmat(10, edge_factor=8, seed=1, device=cuda_device)
    plan = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device=cuda_device, backend_fallback=True,
        schedule=schedule))
    with pytest.raises(ChunkRetryError):
        plan.run_raw(g)
    assert plan.backend == "tiles" and not plan.degradation
    assert plan.stats["faults"]["backend_fallbacks"] == 0
