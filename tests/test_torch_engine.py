"""The port's engine front door against the JAX engine and the brute-force
oracle: ``compile(g, ("triad_census",), EngineConfig(backend=b,
device="cpu")).run_raw(g)`` for the tiles and search backends equals the
JAX ``run_raw`` under pallas (interpret mode) and xla, bit for bit, in
one device→host copy per run."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import generators as jgen
from repro.engine import EngineConfig as JConfig
from repro.engine import clear_plan_cache as jclear
from repro.engine import compile as jcompile
from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.graph import from_edges, graph_from_reference_arrays
from repro_torch.engine import (CensusConfig, EngineConfig, GraphOp,
                                PlanShapeError, clear_plan_cache, compile,
                                compile_census, plan_cache_stats)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

GRAPHS = {
    "rmat5": lambda m, **d: m.rmat(5, edge_factor=4, seed=0, **d),
    "rmat6": lambda m, **d: m.rmat(6, edge_factor=4, seed=1, **d),
    "rmat7": lambda m, **d: m.rmat(7, edge_factor=4, seed=2, **d),
    "er60": lambda m, **d: m.erdos_renyi(60, 240, seed=3, **d),
}
PALLAS_GRAPHS = ("rmat5", "er60")  # interpret mode is slow: keep it to two


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_plan_cache()
    yield
    clear_plan_cache()


@functools.lru_cache(maxsize=None)
def _reference_raw(name):
    """JAX run_raw under xla (and pallas, interpret mode, for a subset)."""
    g = GRAPHS[name](jgen)
    raws = {"xla": jcompile(g, ("triad_census",),
                            JConfig(backend="xla")).run_raw(g)}
    if name in PALLAS_GRAPHS:
        raws["pallas"] = jcompile(g, ("triad_census",),
                                  JConfig(backend="pallas")).run_raw(g)
    jclear()
    host = type(g.arrays)(*(np.asarray(a) for a in g.arrays[:5]))
    return g.n, host, raws


@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_run_raw_equals_jax_engine_and_brute_force(name, backend):
    n, host, raws = _reference_raw(name)
    g = graph_from_reference_arrays(n, host, device="cpu")
    plan = compile(g, ("triad_census",),
                   EngineConfig(backend=backend, device="cpu"))
    raw = plan.run_raw(g)
    assert raw.dtype == np.int64
    for ref_backend, want in raws.items():
        np.testing.assert_array_equal(raw, np.asarray(want),
                                      err_msg=ref_backend)
    assert plan.stats["host_syncs"] == 1 and plan.stats["chunks"] >= 1
    counts = plan.layout.finalize(raw, g)["triad_census"].counts
    np.testing.assert_array_equal(counts, brute_force_census(g).counts)
    # the port's own generator gives the same graph, hence the same bins
    own = GRAPHS[name](tgen, device="cpu")
    np.testing.assert_array_equal(plan.run_raw(own), raw)
    assert plan.stats["host_syncs"] == 2


@pytest.mark.parametrize("overrides", [
    dict(chunk_dyads=64, batch=16),
    dict(block=8, buckets=(8, 32, 128)),
    dict(buckets=(4,), pipeline_depth=1),
    dict(k=256, pipeline_depth=3),
], ids=["small-chunks", "block8", "one-bucket", "k-override"])
@pytest.mark.parametrize("backend", ["tiles", "search"])
def test_chunking_and_buckets_leave_bins_unchanged(backend, overrides):
    g = tgen.rmat(7, edge_factor=4, seed=5, device="cpu")
    base = compile(g, ("triad_census",),
                   EngineConfig(backend="search", device="cpu")).run_raw(g)
    plan = compile(g, ("triad_census",),
                   EngineConfig(backend=backend, device="cpu", **overrides))
    np.testing.assert_array_equal(plan.run_raw(g), base)
    assert plan.stats["host_syncs"] == 1


def test_same_bucket_graph_hits_plan_cache():
    g1 = tgen.rmat(6, edge_factor=4, seed=0, device="cpu")
    g2 = tgen.rmat(6, edge_factor=4, seed=1, device="cpu")
    cfg = EngineConfig(backend="tiles", device="cpu")
    p1 = compile(g1, ("triad_census",), cfg)
    p2 = compile(g2, ("triad_census",), cfg)
    assert p1 is p2
    stats = plan_cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (1, 1, 1)
    for g in (g1, g2):
        np.testing.assert_array_equal(p2.run(g)["triad_census"].counts,
                                      brute_force_census(g).counts)
    assert p2.stats["runs"] == p2.stats["host_syncs"] == 2


def test_auto_and_census_views_share_the_tiles_plan():
    g = tgen.erdos_renyi(60, 240, seed=3, device="cpu")
    view = compile_census(g, CensusConfig(device="cpu"))
    plan = compile(g, "triad_census",
                   EngineConfig(backend="tiles", device="cpu"))
    assert view.backend == "tiles" and view._plan is plan
    np.testing.assert_array_equal(view.run(g).counts,
                                  brute_force_census(g).counts)


def test_default_device_raises_without_cuda():
    """``device=None`` means CUDA: with no card, compile(...).run raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    g = tgen.rmat(5, edge_factor=4, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile(g, ("triad_census",), EngineConfig(backend="tiles")).run(g)


def test_port_imports_neither_jax_nor_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib"))
       or m == "repro" or m.startswith("repro.")]
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": SRC},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_graph_outside_plan_buckets_is_rejected():
    small = tgen.rmat(5, edge_factor=4, seed=0, device="cpu")
    big = tgen.rmat(7, edge_factor=4, seed=0, device="cpu")
    plan = compile(small, ("triad_census",),
                   EngineConfig(backend="tiles", device="cpu"))
    with pytest.raises(PlanShapeError):
        plan.run(big)


def test_arc_free_graph_uses_the_closed_form():
    g = from_edges(10, [], [], device="cpu")
    res = compile(g, ("triad_census",),
                  EngineConfig(backend="tiles", device="cpu")).run(g)
    counts = res["triad_census"].counts
    assert counts[0] == 120 and counts[1:].sum() == 0


@pytest.mark.parametrize("bad", [
    dict(backend="pallas"), dict(batch=0), dict(block=0), dict(buckets=()),
    dict(buckets=(32, 8)), dict(buckets=(0, 8)), dict(chunk_dyads=0),
    dict(pipeline_depth=0),
])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        EngineConfig(**bad)


def test_tiles_backend_runs_only_the_census_kernel():
    """On the tiles backend the census kernel fills only the census slice:
    another op's kernel runs as its own program on the same chunks (with
    ``n_cand=None``), fused into the pass as on the search backend."""

    class DyadCount(GraphOp):
        name, bins = "dyad_count", 1

        def make_batch_fn(self, meta, config):
            return lambda a, n, u, v, valid, n_cand: valid.sum().reshape(1)

        def finalize(self, raw, g):
            return int(raw[0])

    g = tgen.rmat(5, edge_factor=4, seed=0, device="cpu")
    raws = {}
    for backend in ("tiles", "search"):
        plan = compile(g, ("triad_census", DyadCount()),
                       EngineConfig(backend=backend, device="cpu"))
        raws[backend] = plan.run_raw(g)
        res = plan.layout.finalize(raws[backend], g)
        assert res["dyad_count"] == g.n_dyads
        np.testing.assert_array_equal(res["triad_census"].counts,
                                      brute_force_census(g).counts)
    np.testing.assert_array_equal(raws["tiles"], raws["search"])
