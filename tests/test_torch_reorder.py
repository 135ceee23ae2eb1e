"""Locality reordering in the port against the JAX package: each
strategy's permutation, the relabeled graph's arrays and the locality
score equal the JAX ones (also on edgeless and disconnected graphs);
reordered runs, batches and deltas are bit-identical to unreordered ones
and to the JAX engine's, on both backends and schedules; a vertex-indexed
op's raw bins map back to original ids; ``GraphDelta.permuted`` equals
the JAX translation; and the reorder memo is bounded, counted and
cleared.  Small R-MAT graphs built in both packages from the same arc
arrays; tolerance 0."""
import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.delta import GraphDelta, apply_delta_csr
from repro_torch.core.graph import arcs_host, from_edges
from repro_torch.core.reorder import (REORDER_STRATEGIES, compute_permutation,
                                      inverse_permutation, locality_score,
                                      permute_graph)
from repro_torch.engine import (EngineConfig, GraphOp, clear_plan_cache,
                                compile, plan_cache_stats, register_op,
                                unregister_op)

ALL_OPS = ("triad_census", "dyad_census", "degree_stats", "triadic_profile")
SMALL = dict(batch=16, chunk_dyads=64)
FIELDS = ("out_ptr", "out_idx", "nbr_ptr", "nbr_idx", "nbr_deg")


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_plan_cache()
    yield
    clear_plan_cache()


def graph(scale=6, seed=12, edge_factor=4):
    return tgen.rmat(scale, edge_factor=edge_factor, seed=seed, device="cpu")


def jax_graph(g):
    from repro.core.graph import from_edges as jfrom_edges

    return jfrom_edges(g.n, *arcs_host(g), directed=True)


def cfg(backend, **kw):
    return EngineConfig(backend=backend, device="cpu", **{**SMALL, **kw})


def odd_graphs():
    """An edgeless graph and a disconnected one with isolated vertices."""
    empty = from_edges(9, [], [], device="cpu")
    parts = from_edges(14, [0, 1, 2, 5, 6, 9, 9, 11],
                       [1, 2, 0, 6, 5, 10, 11, 10], device="cpu")
    return [empty, parts]


@pytest.mark.parametrize("strategy", REORDER_STRATEGIES)
def test_permutation_and_relabel_equal_jax(strategy):
    pytest.importorskip("jax")
    from repro.core import reorder as jreorder

    for g in [graph(), graph(7, 3), *odd_graphs()]:
        jg = jax_graph(g)
        perm = compute_permutation(g, strategy)
        np.testing.assert_array_equal(
            perm, jreorder.compute_permutation(jg, strategy))
        assert sorted(perm.tolist()) == list(range(g.n))
        np.testing.assert_array_equal(inverse_permutation(perm)[perm],
                                      np.arange(g.n))
        gp, jgp = permute_graph(g, perm), jreorder.permute_graph(jg, perm)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(gp.host, f),
                                          np.asarray(getattr(jgp.arrays, f)))
        assert (gp.m, gp.m_nbr, gp.max_deg) == (g.m, g.m_nbr, g.max_deg)
        assert locality_score(gp) == jreorder.locality_score(jgp)
        assert locality_score(g) == jreorder.locality_score(jg)


def test_permutation_rejects_bad_input():
    g = graph()
    with pytest.raises(ValueError, match="unknown reorder strategy"):
        compute_permutation(g, "hilbert")
    with pytest.raises(ValueError, match="shape"):
        permute_graph(g, np.arange(g.n - 1))
    np.testing.assert_array_equal(
        permute_graph(g, np.arange(g.n)).host.nbr_idx, g.host.nbr_idx)


def test_delta_permuted_equals_jax_and_commutes():
    pytest.importorskip("jax")
    from repro.core.delta import GraphDelta as JDelta

    g = graph()
    perm = compute_permutation(g, "rcm")
    d = GraphDelta(edges_added=[(0, 7), (3, 9)], edges_removed=[(1, 0)])
    dp = d.permuted(perm)
    jdp = JDelta(edges_added=[(0, 7), (3, 9)],
                 edges_removed=[(1, 0)]).permuted(perm)
    np.testing.assert_array_equal(dp.edges_added, jdp.edges_added)
    np.testing.assert_array_equal(dp.edges_removed, jdp.edges_removed)
    a = apply_delta_csr(permute_graph(g, perm), dp)
    b = permute_graph(apply_delta_csr(g, d), perm)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a.host, f), getattr(b.host, f))
    assert GraphDelta().permuted(perm).is_empty


@pytest.mark.parametrize("schedule,pool", [("static", 1), ("dynamic", 3)])
@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("strategy", REORDER_STRATEGIES)
def test_reordered_run_bit_identical_all_ops(strategy, backend, schedule,
                                             pool):
    g = graph()
    want = compile(g, ALL_OPS, cfg(backend)).run_raw(g)
    plan = compile(g, ALL_OPS, cfg(backend, reorder=strategy,
                                   schedule=schedule,
                                   n_executor_devices=pool))
    np.testing.assert_array_equal(plan.run_raw(g), want)
    np.testing.assert_array_equal(plan.run(g)["triad_census"].counts,
                                  brute_force_census(g).counts)
    assert plan.stats["reorders"] == 1 and plan.stats["host_syncs"] == 2


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_reordered_raw_equals_jax_reordered(backend):
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    g = graph(5, 2)
    jg = jax_graph(g)
    jname = {"tiles": "pallas", "search": "xla"}[backend]
    for strategy in REORDER_STRATEGIES:
        got = compile(g, ALL_OPS, cfg(backend, reorder=strategy)).run_raw(g)
        want = jcompile(jg, ALL_OPS, JConfig(
            backend=jname, reorder=strategy, **SMALL)).run_raw(jg)
        np.testing.assert_array_equal(got, np.asarray(want))
    jclear()


def test_reordered_batch_matches_member_runs():
    g1 = graph(6, 9)
    g2 = apply_delta_csr(g1, GraphDelta(edges_added=[(0, 3), (9, 2)]))
    base = compile(g1, ALL_OPS, cfg("tiles"))
    plan = compile(g1, ALL_OPS, cfg("tiles", reorder="degree"))
    got = plan.run_batch([g1, g2])
    assert plan.stats["host_syncs"] == 1 and plan.stats["reorders"] == 2
    for res, g in zip(got, (g1, g2)):
        want = base.run(g)
        np.testing.assert_array_equal(res["triad_census"].counts,
                                      want["triad_census"].counts)
        assert res["dyad_census"] == want["dyad_census"]
        assert res["triadic_profile"] == want["triadic_profile"]


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_reordered_delta_equals_full_recompute(backend):
    g = graph()
    plan = compile(g, ALL_OPS, cfg(backend, reorder="rcm",
                                   delta_threshold=1.0))
    base = compile(g, ALL_OPS, cfg(backend))
    raw = plan.run_raw(g)
    rng = np.random.default_rng(13)
    d = GraphDelta(edges_added=rng.integers(0, g.n, size=(4, 2)),
                   edges_removed=[(1, 0)])
    res = plan.apply_delta(g, d, raw)  # the delta in ORIGINAL ids
    assert res.mode == "delta"
    want = apply_delta_csr(g, d)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res.graph.host, f),
                                      getattr(want.host, f))
    np.testing.assert_array_equal(res.raw, base.run_raw(res.graph))
    # the mutated graph's relabeling was seeded: no second permutation
    np.testing.assert_array_equal(plan.run_raw(res.graph), res.raw)
    assert plan.stats["reorders"] == 1


class _VertexOutDegOp(GraphOp):
    """A test op whose raw slice is vertex-indexed (bin i = out-degree of
    vertex i): the one kind of op whose bins a relabeling moves."""

    name = "_vertex_outdeg"
    bins = 32

    def make_once_fn(self, meta, config):
        B = self.bins

        def once(arrays, n):
            deg = (arrays.out_ptr[1:] - arrays.out_ptr[:-1]).long()
            deg = torch.where(torch.arange(deg.shape[0]) < n, deg, 0)
            out = torch.zeros(B, dtype=torch.int64, device=deg.device)
            out[: min(B, deg.shape[0])] = deg[:B]
            return out

        return once

    def finalize(self, raw, g):
        return np.asarray(raw[: g.n], dtype=np.int64)

    def unpermute_raw(self, raw, perm, g):
        out = np.array(raw, dtype=np.int64)
        out[: g.n] = raw[np.asarray(perm)]
        return out

    def reference(self, g):
        return np.diff(g.host.out_ptr[: g.n + 1]).astype(np.int64)


@pytest.fixture
def vertex_op():
    op = register_op(_VertexOutDegOp(), overwrite=True)
    yield op
    unregister_op(op.name)


def test_vertex_indexed_op_unpermutes(vertex_op):
    g = graph(5, 10)  # n = 32 = the op's bins
    ops = ("triad_census", vertex_op.name)
    base = compile(g, ops, cfg("tiles"))
    want = base.run_raw(g)
    for strategy in REORDER_STRATEGIES:
        plan = compile(g, ops, cfg("tiles", reorder=strategy))
        np.testing.assert_array_equal(plan.run_raw(g), want)
        np.testing.assert_array_equal(plan.run(g)[vertex_op.name],
                                      vertex_op.reference(g))
    plan = compile(g, ops, cfg("search", reorder="rcm", delta_threshold=1.0))
    res = plan.apply_delta(g, GraphDelta(edges_added=[(0, 7), (3, 9)],
                                         edges_removed=[(1, 0)]),
                           plan.run_raw(g))
    assert res.mode == "delta"
    np.testing.assert_array_equal(res.results[vertex_op.name],
                                  vertex_op.reference(res.graph))
    np.testing.assert_array_equal(res.raw, base.run_raw(res.graph))


def test_reorder_memo_bounded_counted_and_cleared():
    g = graph(5, 19, edge_factor=3)
    plan = compile(g, ("triad_census",), cfg("search", reorder="degree"))
    src, dst = arcs_host(g)
    graphs = [g] + [apply_delta_csr(g, GraphDelta(
        edges_removed=[(src[i], dst[i])])) for i in range(11)]
    for gi in graphs:
        np.testing.assert_array_equal(plan.run(gi)["triad_census"].counts,
                                      brute_force_census(gi).counts)
    plan.run(graphs[-1])
    assert plan.stats["reorders"] == 12
    assert 0 < len(plan._reorder_memo) <= 8
    entry = plan_cache_stats()["entries"][-1]
    assert entry["reorder"] == "degree"
    assert entry["reorder_memo"] == len(plan._reorder_memo)
    assert entry["reorders"] == 12
    clear_plan_cache()
    assert not plan._reorder_memo and not plan._task_memo


def test_reorder_config_and_cache_key():
    with pytest.raises(ValueError) as e:
        EngineConfig(reorder="hilbert")
    for name in ("none", "degree", "bfs", "rcm"):
        assert name in str(e.value)
    g = graph(5, 21, edge_factor=3)
    plain = compile(g, ("triad_census",), cfg("tiles"))
    assert compile(g, ("triad_census",), cfg("tiles", reorder="none")) is plain
    plans = [compile(g, ("triad_census",), cfg("tiles", reorder=s))
             for s in REORDER_STRATEGIES]
    assert len({id(p) for p in [plain, *plans]}) == 4
    assert plan_cache_stats()["size"] == 4


@pytest.mark.cuda
def test_cuda_reordered_runs_equal_unreordered():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census kernel has no CPU mode")
    from repro_torch.kernels.triad_census import census_csr

    g = tgen.rmat(10, edge_factor=8, seed=2, device="cuda")
    want = compile(g, ALL_OPS, EngineConfig(backend="tiles",
                                            device="cuda")).run_raw(g)
    for strategy in REORDER_STRATEGIES:
        plan = compile(g, ALL_OPS, EngineConfig(
            backend="tiles", device="cuda", reorder=strategy))
        census_csr.launches = 0
        np.testing.assert_array_equal(plan.run_raw(g), want)
        assert census_csr.launches == plan.stats["chunks"] > 0
