"""The port's fused GraphOps against the JAX engine and each op's numpy
oracle: every built-in op on the tiles and search backends equals the
JAX ``backend="xla"`` raw bins and ``reference``, bit for bit; the fused
pass equals the per-op passes in one device→host copy; the tiles backend
runs the census through ``census_csr`` and the other ops' programs on the
same chunks.

The JAX package is imported inside the tests that compare with it, so
the CUDA case runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_ops.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.census import make_census_batch_fn
from repro_torch.core.graph import from_edges, graph_from_reference_arrays
from repro_torch.engine import (DegreeStats, EngineConfig, GraphOp,
                                clear_plan_cache, compile, get_op, list_ops,
                                register_op, unregister_op)
from repro_torch.engine import backends
from repro_torch.engine import plan as tplan
from repro_torch.engine.ops import DegreeStatsOp
from repro_torch.kernels.triad_census import census_csr

OPS = ("triad_census", "dyad_census", "degree_stats", "triadic_profile")
GRAPHS = {
    "rmat5": lambda m, **d: m.rmat(5, edge_factor=4, seed=0, **d),
    "rmat7": lambda m, **d: m.rmat(7, edge_factor=4, seed=2, **d),
    "er60": lambda m, **d: m.erdos_renyi(60, 240, seed=3, **d),
}
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


@functools.lru_cache(maxsize=None)
def _jax_run(name, ops):
    """JAX ``run_raw`` of ``ops`` under xla, and the graph's host arrays."""
    pytest.importorskip("jax")
    from repro.core import generators as jgen
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    g = GRAPHS[name](jgen)
    raw = np.asarray(jcompile(g, ops, JConfig(backend="xla")).run_raw(g))
    jclear()
    host = type(g.arrays)(*(np.asarray(a) for a in g.arrays[:5]))
    return g.n, host, raw


def _port_graph(name, device="cpu"):
    n, host, _ = _jax_run(name, ("triad_census",))
    return graph_from_reference_arrays(n, host, device=device)


def _same(got, want):
    """Equality of op results, arrays compared element for element."""
    assert type(got) is type(want)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_op_equals_jax_xla_and_reference(name, op, backend):
    g = _port_graph(name)
    plan = compile(g, (op,), EngineConfig(backend=backend, device="cpu",
                                          **SMALL))
    raw = plan.run_raw(g)
    np.testing.assert_array_equal(raw, _jax_run(name, (op,))[2])
    assert plan.stats["host_syncs"] == 1
    _same(plan.layout.finalize(raw, g)[op], get_op(op).reference(g))


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_fused_pass_equals_per_op_passes(backend):
    g = _port_graph("rmat7")
    cfg = EngineConfig(backend=backend, device="cpu", **SMALL)
    plan = compile(g, OPS, cfg)
    raw = plan.run_raw(g)
    assert plan.stats["host_syncs"] == 1
    assert plan.layout.keys == ["triad_census", "dyad_census", "degree_stats"]
    np.testing.assert_array_equal(raw, _jax_run("rmat7", OPS)[2])
    for key, sl in plan.layout.slices.items():
        np.testing.assert_array_equal(
            raw[sl], compile(g, (key,), cfg).run_raw(g), err_msg=key)
    fused = plan.layout.finalize(raw, g)
    for op in OPS:
        _same(fused[op], get_op(op).reference(g))
    # one traversal: the fused pass runs the census pass's chunks
    census = compile(g, ("triad_census",), cfg)
    assert census.stats["runs"] == 1
    assert plan.stats["chunks"] == census.stats["chunks"]


def test_shared_kernel_key_gives_one_slice():
    g = _port_graph("rmat5")
    cfg = EngineConfig(backend="tiles", device="cpu")
    both = compile(g, ("triad_census", "triadic_profile"), cfg)
    assert both.layout.keys == ["triad_census"]
    assert both.layout.total_bins == 16
    alone = compile(g, ("triadic_profile",), cfg)
    assert alone.layout.keys == ["triad_census"]
    np.testing.assert_array_equal(both.run_raw(g), alone.run_raw(g))
    res = both.run(g)
    assert res["triadic_profile"] == get_op("triadic_profile").reference(g)
    np.testing.assert_array_equal(res["triad_census"].counts,
                                  brute_force_census(g).counts)

    class Narrow(GraphOp):
        name, bins, kernel_key = "narrow_profile", 8, "triad_census"

    with pytest.raises(ValueError, match="bins=8 != 16"):
        compile(g, ("triad_census", Narrow()), cfg)


class _ArcSum(GraphOp):
    """Counts arcs per canonical dyad (1 or 2) and dyads, as a custom op."""

    name, bins = "arc_sum", 2

    def __init__(self, scale=1):
        self.scale = scale

    def make_batch_fn(self, meta, config):
        dyad = get_op("dyad_census").make_batch_fn(meta, config)

        def fn(arrays, n, u, v, valid, n_cand):
            mut, asym, _ = dyad(arrays, n, u, v, valid, n_cand)
            return torch.stack([2 * mut + asym, valid.sum()]) * self.scale

        return fn

    def finalize(self, raw, g):
        return tuple(int(x) for x in raw)


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_custom_op_registers_and_reregistering_builds_a_fresh_plan(backend):
    g = _port_graph("er60")
    cfg = EngineConfig(backend=backend, device="cpu", **SMALL)
    register_op(_ArcSum())
    try:
        assert "arc_sum" in list_ops()
        with pytest.raises(ValueError, match="already registered"):
            register_op(_ArcSum())
        plan = compile(g, ("triad_census", "arc_sum"), cfg)
        res = plan.run(g)
        assert res["arc_sum"] == (g.m, g.n_dyads)
        np.testing.assert_array_equal(res["triad_census"].counts,
                                      brute_force_census(g).counts)
        register_op(_ArcSum(scale=3), overwrite=True)
        fresh = compile(g, ("triad_census", "arc_sum"), cfg)
        assert fresh is not plan
        assert fresh.run(g)["arc_sum"] == (3 * g.m, 3 * g.n_dyads)
        assert compile(g, ("triad_census", "arc_sum"), cfg) is fresh
    finally:
        unregister_op("arc_sum")
    assert "arc_sum" not in list_ops()
    with pytest.raises(KeyError):
        compile(g, ("arc_sum",), cfg)


def test_tiles_plan_without_the_census_launches_no_census_kernel(monkeypatch):
    """No arc flags, no bucket sort, no census_csr call: the dyads stream
    unsorted in fixed chunks keyed by the top width."""
    calls = []

    def forbidden(*args, **kwargs):
        raise AssertionError("a plan without the census built arc flags")

    def counting(*args, **kwargs):
        calls.append(1)
        return census_csr(*args, **kwargs)

    monkeypatch.setattr(tplan, "build_arc_flags_device", forbidden)
    monkeypatch.setattr(backends, "sort_dyads_by_bucket", forbidden)
    monkeypatch.setattr(backends, "census_csr", counting)
    g = _port_graph("rmat7")
    ops = ("dyad_census", "degree_stats")
    plan = compile(g, ops, EngineConfig(backend="tiles", device="cpu",
                                        **SMALL))
    raw = plan.run_raw(g)
    assert not calls and plan.stats["chunks"] > 1
    np.testing.assert_array_equal(raw, _jax_run("rmat7", ops)[2])
    st = backends.tiles_stream(plan, g)
    assert st.arrays.nbr_flag is None
    assert {t.key for t in st.tasks} == {plan.meta.k}


@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_arc_free_graph_finalizes_from_zero_bins(backend):
    g = from_edges(10, [], [], device="cpu")
    plan = compile(g, OPS, EngineConfig(backend=backend, device="cpu"))
    raw = plan.run_raw(g)
    assert not raw.any() and plan.stats["chunks"] == 0
    res = plan.layout.finalize(raw, g)
    for op in OPS:
        _same(res[op], get_op(op).reference(g))
    assert res["degree_stats"].out_hist[0] == 10
    assert res["dyad_census"].null == 45


@pytest.mark.parametrize("n", [3_810_779, 3_810_780, 2**22])
def test_census_finalize_stays_exact_past_int64(n):
    # from n = 3,810,780 on (the Patents stand-in has 2**22 vertices)
    # C(n, 3) passes int64: the counts become exact Python ints, held to
    # the same closed form computed in Python ints; below, to the JAX
    # package's finalize
    import types

    g = types.SimpleNamespace(n=n)
    raw = np.arange(16, dtype=np.int64) * 10**12
    c3 = n * (n - 1) * (n - 2) // 6
    counts = get_op("triad_census").finalize(raw, g).counts
    assert int(counts.sum()) == c3 and counts[0] == c3 - int(raw.sum())
    assert list(counts[1:]) == list(raw[1:])
    assert (counts.dtype == np.int64) == (c3 < 2**63)
    if c3 >= 2**63:
        exact = [int(x) for x in raw]
        exact[0] = c3 - sum(exact[1:])
        assert [int(x) for x in counts] == exact
        return
    pytest.importorskip("jax")
    from repro.engine.ops import get_op as jget_op

    np.testing.assert_array_equal(
        jget_op("triad_census").finalize(raw, g).counts, counts)


def test_degree_stats_mask_padded_out_idx():
    """Five arcs, none into vertex 0, in an 8-slot arc bucket padded with
    0: vertex 0's in-degree must stay 0."""
    g = from_edges(7, [1, 2, 3, 4, 5], [2, 3, 4, 5, 6], device="cpu")
    plan = compile(g, ("degree_stats",), EngineConfig(backend="tiles",
                                                      device="cpu"))
    arrays = plan.padded_arrays(g)
    assert arrays.out_idx.shape[0] == 8 and int(arrays.out_idx[5:].sum()) == 0
    once = DegreeStatsOp().make_once_fn(plan.meta, plan.config)(arrays, g.n)
    H = DegreeStatsOp.H
    assert int(once[H]) == 2  # in-degree 0: vertices 0 and 1
    want = DegreeStatsOp().reference(g)
    got = plan.run(g)["degree_stats"]
    _same(got, want)
    assert isinstance(got, DegreeStats) and got.max_in == 1


def test_op_needing_n_cand_raises_on_tiles():
    """Outside the census slice the tiles backend passes n_cand=None; the
    census batch program under another key says so."""

    class CensusCopy(GraphOp):
        name, bins = "census_copy", 16

        def make_batch_fn(self, meta, config):
            return make_census_batch_fn(meta.member_iters)

        def finalize(self, raw, g):
            return raw

    g = _port_graph("rmat5")
    res = compile(g, (CensusCopy(),), EngineConfig(
        backend="search", device="cpu")).run(g)["census_copy"]
    np.testing.assert_array_equal(res[1:], brute_force_census(g).counts[1:])
    with pytest.raises(ValueError, match="backend='search'"):
        compile(g, (CensusCopy(),), EngineConfig(
            backend="tiles", device="cpu")).run(g)


@pytest.mark.cuda
def test_cuda_fused_tiles_equals_search(cuda_device):
    g = tgen.rmat(9, edge_factor=8, seed=4, device=cuda_device)
    raws = {}
    for backend in ("tiles", "search"):
        plan = compile(g, OPS, EngineConfig(backend=backend,
                                            device=cuda_device))
        before = census_csr.launches
        raws[backend] = plan.run_raw(g)
        if backend == "tiles":
            assert census_csr.launches - before == plan.stats["chunks"]
        assert plan.stats["host_syncs"] == 1
    np.testing.assert_array_equal(raws["tiles"], raws["search"])
    res = plan.layout.finalize(raws["tiles"], g)
    _same(res["degree_stats"], get_op("degree_stats").reference(g))
    plan = compile(g, ("dyad_census", "degree_stats"),
                   EngineConfig(backend="tiles", device=cuda_device))
    before = census_csr.launches
    raw = plan.run_raw(g)
    assert census_csr.launches == before
    np.testing.assert_array_equal(raw, raws["search"][16:])
