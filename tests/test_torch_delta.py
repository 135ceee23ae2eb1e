"""The port's incremental delta census: ``GraphDelta``, ``affected_dyads``
and ``apply_delta_csr`` equal the JAX package's, array for array; and
``Plan.apply_delta`` on the tiles and search backends equals the port's
full recompute of the mutated graph, the brute-force census and the JAX
package's full run of the same graph, in one counted copy.  (JAX's own
delta path is not the reference: its property test fails in the JAX
package, see ``ROADMAP.md``.)

The JAX package is imported inside the tests that compare with it, so
the CUDA case runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_delta.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.delta import (GraphDelta, affected_dyads,
                                    apply_delta_csr)
from repro_torch.core.graph import arcs_host
from repro_torch.engine import (EngineConfig, GraphOp, PlanShapeError,
                                clear_plan_cache, compile, get_op)
from repro_torch.kernels.triad_census import census_csr
from repro_torch.serve import CensusService, ServiceConfig

OPS = ("triad_census", "dyad_census", "degree_stats", "triadic_profile")
SMALL = dict(batch=16, chunk_dyads=64)


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


def _random_delta(g, k, seed):
    """k removals of existing arcs and k random additions."""
    rng = np.random.default_rng(seed)
    src, dst = arcs_host(g)
    sel = rng.choice(g.m, size=min(k, g.m), replace=False)
    return GraphDelta(edges_added=rng.integers(0, g.n, size=(k, 2)),
                      edges_removed=np.stack([src[sel], dst[sel]], 1))


DELTAS = {
    "k2": lambda g: _random_delta(g, 2, 0),
    "k6": lambda g: _random_delta(g, 6, 1),
    "remove_only": lambda g: GraphDelta(
        edges_removed=np.stack(arcs_host(g), 1)[:: max(1, g.m // 8)]),
    "messy": lambda g: GraphDelta(
        edges_added=[(1, 2), (1, 2), (3, 3), (4, 0), (0, 4)],
        edges_removed=[(4, 0), (5, 5), (2, 1)]),
}


def _jax_graph(g):
    """The JAX package's graph with the same arcs as the port's ``g``."""
    pytest.importorskip("jax")
    from repro.core.graph import from_edges as jfrom_edges
    return jfrom_edges(g.n, *arcs_host(g), directed=True)


@pytest.mark.parametrize("delta", sorted(DELTAS))
def test_delta_core_equals_jax(delta):
    pytest.importorskip("jax")
    from repro.core.delta import GraphDelta as JDelta
    from repro.core.delta import affected_dyads as jaffected
    from repro.core.delta import apply_delta_csr as japply

    g = tgen.rmat(6, edge_factor=4, seed=3, device="cpu")
    jg = _jax_graph(g)
    d = DELTAS[delta](g)
    jd = JDelta(edges_added=d.edges_added, edges_removed=d.edges_removed)
    for a, b in ((d.edges_added, jd.edges_added),
                 (d.edges_removed, jd.edges_removed),
                 (d.touched, jd.touched)):
        np.testing.assert_array_equal(a, b)
    assert (d.size, d.is_empty) == (jd.size, jd.is_empty)
    for a, b in zip(affected_dyads(g, d), jaffected(jg, jd)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    g_new, jg_new = apply_delta_csr(g, d), japply(jg, jd)
    assert (g_new.n, g_new.m, g_new.m_nbr, g_new.max_deg,
            g_new.max_out_deg) == (jg_new.n, jg_new.m, jg_new.m_nbr,
                                   jg_new.max_deg, jg_new.max_out_deg)
    for a, b in zip(g_new.host, jg_new.arrays[:5]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(affected_dyads(g_new, d), jaffected(jg_new, jd)):
        np.testing.assert_array_equal(a, b)
    assert g_new.device == g.device


def test_graph_delta_validates():
    with pytest.raises(ValueError, match=">= 0"):
        GraphDelta(edges_added=[(-1, 2)])
    with pytest.raises(ValueError, match=r"\(k, 2\)"):
        GraphDelta(edges_added=[(1, 2, 3)])
    g = tgen.rmat(5, edge_factor=4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="n=32"):
        apply_delta_csr(g, GraphDelta(edges_added=[(0, 32)]))


@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("delta", sorted(DELTAS))
def test_apply_delta_equals_full_recompute_and_jax_full_run(delta, backend):
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    g = tgen.rmat(7, edge_factor=4, seed=5, device="cpu")
    d = DELTAS[delta](g)
    plan = compile(g, OPS, EngineConfig(backend=backend, device="cpu",
                                        delta_threshold=1.0, **SMALL))
    raw = plan.run_raw(g)
    syncs = plan.stats["host_syncs"]
    res = plan.apply_delta(g, d, raw)
    assert res.mode == "delta" and plan.stats["delta_runs"] == 1
    assert plan.stats["host_syncs"] == syncs + 1
    assert 0 < res.affected_fraction <= 1
    full = plan.run_raw(res.graph)
    np.testing.assert_array_equal(res.raw, full)
    jg_new = _jax_graph(res.graph)
    np.testing.assert_array_equal(
        res.raw, np.asarray(jcompile(jg_new, OPS,
                                     JConfig(backend="xla")).run_raw(jg_new)))
    jclear()
    np.testing.assert_array_equal(res.results["triad_census"].counts,
                                  brute_force_census(res.graph).counts)
    for op in ("dyad_census", "triadic_profile"):
        assert res.results[op] == get_op(op).reference(res.graph)


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_delta_sequence_stays_exact(backend):
    g = tgen.erdos_renyi(60, 240, seed=3, device="cpu")
    plan = compile(g, ("triad_census", "dyad_census"), EngineConfig(
        backend=backend, device="cpu", delta_threshold=1.0, **SMALL))
    raw = plan.run_raw(g)
    for step in range(4):
        res = plan.apply_delta(g, _random_delta(g, 3, 10 + step), raw)
        g, raw = res.graph, res.raw
        np.testing.assert_array_equal(raw, plan.run_raw(g))
    assert plan.stats["delta_runs"] == 4


def test_negative_correction_is_exact():
    """Removing every arc of a hub lowers bins: the correction is negative
    in them and still exact."""
    g = tgen.rmat(6, edge_factor=4, seed=1, device="cpu")
    src, dst = arcs_host(g)
    hub = int(np.argmax(g.host.nbr_deg))
    mine = (src == hub) | (dst == hub)
    d = GraphDelta(edges_removed=np.stack([src[mine], dst[mine]], 1))
    plan = compile(g, ("triad_census", "dyad_census"), EngineConfig(
        backend="tiles", device="cpu", delta_threshold=1.0))
    raw = plan.run_raw(g)
    res = plan.apply_delta(g, d, raw)
    assert res.mode == "delta" and (res.raw - raw < 0).any()
    np.testing.assert_array_equal(res.raw, plan.run_raw(res.graph))
    np.testing.assert_array_equal(res.results["triad_census"].counts,
                                  brute_force_census(res.graph).counts)


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_full_fallbacks(backend):
    g = tgen.rmat(6, edge_factor=4, seed=2, device="cpu")
    d = _random_delta(g, 20, 4)
    plan = compile(g, ("triad_census",), EngineConfig(
        backend=backend, device="cpu", delta_threshold=0.05))
    raw = plan.run_raw(g)
    res = plan.apply_delta(g, d, raw)
    assert res.mode == "full" and res.affected_fraction > 0.05
    assert plan.stats["delta_fulls"] == 1
    np.testing.assert_array_equal(res.raw, plan.run_raw(res.graph))
    # no raw bins: a full run whatever the footprint
    assert plan.apply_delta(g, _random_delta(g, 1, 5)).mode == "full"

    class Global(GraphOp):
        name, bins, delta_local = "arc_count", 1, False

        def make_once_fn(self, meta, config):
            return lambda arrays, n: arrays.out_ptr[-1:].long()

        def finalize(self, raw, g):
            return int(raw[0])

    gplan = compile(g, ("triad_census", Global()), EngineConfig(
        backend=backend, device="cpu", delta_threshold=1.0))
    res = gplan.apply_delta(g, _random_delta(g, 1, 6), gplan.run_raw(g))
    assert res.mode == "full" and res.results["arc_count"] == res.graph.m


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_empty_delta_costs_no_sync(backend):
    g = tgen.rmat(6, edge_factor=4, seed=2, device="cpu")
    plan = compile(g, OPS, EngineConfig(backend=backend, device="cpu"))
    raw = plan.run_raw(g)
    before = dict(plan.stats)
    res = plan.apply_delta(g, GraphDelta(edges_added=[(3, 3)]), raw)
    assert res.mode == "delta" and res.affected_fraction == 0.0
    assert res.graph is g and res.raw is raw
    assert plan.stats["host_syncs"] == before["host_syncs"]
    assert plan.stats["chunks"] == before["chunks"]
    np.testing.assert_array_equal(res.results["triad_census"].counts,
                                  brute_force_census(g).counts)


def test_growth_past_buckets_raises_and_session_recompiles():
    g = tgen.rmat(5, edge_factor=4, seed=0, device="cpu")
    hub = [(0, w) for w in range(1, 32)] + [(w, 0) for w in range(1, 32)]
    d = GraphDelta(edges_added=hub)
    plan = compile(g, ("triad_census",), EngineConfig(backend="tiles",
                                                      device="cpu"))
    with pytest.raises(PlanShapeError):
        plan.apply_delta(g, d, plan.run_raw(g))
    svc = CensusService(ServiceConfig(census=EngineConfig(backend="tiles",
                                                          device="cpu")))
    sid = svc.subscribe(g, ("triad_census", "dyad_census"))
    ack = svc.mutate(sid, _random_delta(g, 1, 0))
    assert ack["mode"] == "delta"
    ack = svc.mutate(sid, d)
    assert ack["mode"] == "recompile" and ack["affected_fraction"] == 1.0
    g_now = svc._sessions[sid].graph
    res = svc.poll(sid)
    np.testing.assert_array_equal(res["triad_census"].counts,
                                  brute_force_census(g_now).counts)
    assert res["dyad_census"] == get_op("dyad_census").reference(g_now)
    counters = svc.stats()["sessions"][sid]
    assert (counters["mutations"], counters["deltas"],
            counters["recompiles"]) == (2, 1, 1)
    final = svc.unsubscribe(sid)
    assert final["dyad_census"] == res["dyad_census"]
    assert svc.stats()["sessions"] == {}


def test_session_split_follows_the_threshold():
    g = tgen.rmat(7, edge_factor=4, seed=5, device="cpu")
    svc = CensusService(ServiceConfig(census=EngineConfig(
        backend="search", device="cpu", delta_threshold=0.3)))
    sid = svc.subscribe(g)
    modes = []
    for k, seed in ((1, 0), (40, 1), (1, 3)):
        ack = svc.mutate(sid, _random_delta(svc._sessions[sid].graph, k,
                                            seed))
        modes.append(ack["mode"])
        assert (ack["mode"] == "delta") == (ack["affected_fraction"] <= 0.3)
        np.testing.assert_array_equal(
            svc.poll(sid).counts,
            brute_force_census(svc._sessions[sid].graph).counts)
    assert modes == ["delta", "full", "delta"]
    counters = svc.stats()["sessions"][sid]
    assert (counters["deltas"], counters["fulls"]) == (2, 1)


@pytest.mark.cuda
def test_cuda_apply_delta_equals_full_recompute(cuda_device):
    g = tgen.rmat(10, edge_factor=8, seed=1, device=cuda_device)
    raws = {}
    for backend in ("tiles", "search"):
        plan = compile(g, ("triad_census", "dyad_census", "degree_stats"),
                       EngineConfig(backend=backend, device=cuda_device,
                                    delta_threshold=1.0))
        raw = plan.run_raw(g)
        for k in (2, 16, 200):
            d = _random_delta(g, k, k)
            before = (census_csr.launches, plan.stats["host_syncs"],
                      plan.stats["chunks"])
            res = plan.apply_delta(g, d, raw)
            assert res.mode == "delta"
            assert plan.stats["host_syncs"] == before[1] + 1
            if backend == "tiles":
                assert (census_csr.launches - before[0]
                        == plan.stats["chunks"] - before[2])
            np.testing.assert_array_equal(res.raw, plan.run_raw(res.graph))
            raws[backend, k] = res.raw
    for k in (2, 16, 200):
        np.testing.assert_array_equal(raws["tiles", k], raws["search", k])
