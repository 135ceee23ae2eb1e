"""The port's load-balancing module against the JAX package's: the cost
models (``dyad_weights``, ``exact_s_sizes`` on both routes),
``chunk_bounds_by_cost`` and ``pack_tasks`` give equal arrays, tolerance
0, on small R-MAT graphs built in both packages from the same arc
arrays (made from a numpy seed by the port's generator)."""
import numpy as np
import pytest

from repro.core import balance as jbalance
from repro.core.graph import from_edges as jfrom_edges
from repro_torch.core import balance
from repro_torch.core import generators as tgen
from repro_torch.core.census import canonical_dyads
from repro_torch.core.graph import arcs_host


def graph_pair(scale, seed, edge_factor=4):
    """(JAX graph, port graph) over the same arc arrays."""
    g = tgen.rmat(scale, edge_factor=edge_factor, seed=seed, device="cpu")
    src, dst = arcs_host(g)
    return jfrom_edges(g.n, src, dst, directed=True), g


@pytest.fixture(scope="module", params=[(5, 0), (6, 3)], ids=lambda p: f"rmat{p[0]}s{p[1]}")
def pair(request):
    return graph_pair(*request.param)


@pytest.mark.parametrize("model", balance.WEIGHTS)
def test_dyad_weights_equal_jax(pair, model):
    jg, g = pair
    u, v = canonical_dyads(g)
    got = balance.dyad_weights(g, u, v, model, batch=64)
    want = jbalance.dyad_weights(jg, u, v, model, batch=64)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_exact_s_sizes_both_routes_equal_jax(pair):
    jg, g = pair
    u, v = canonical_dyads(g)
    want = jbalance.exact_s_sizes(jg, u, v, batch=64)
    np.testing.assert_array_equal(
        balance.exact_s_sizes(g, u, v, batch=64), want)
    np.testing.assert_array_equal(
        balance.exact_s_sizes(g, u, v, device=False), want)
    np.testing.assert_array_equal(
        jbalance.exact_s_sizes(jg, u, v, device=False), want)


def test_dyad_weights_rejects_unknown_model(pair):
    _, g = pair
    with pytest.raises(ValueError, match="weight model"):
        balance.dyad_weights(g, *canonical_dyads(g), "degree_squared")


@pytest.mark.parametrize("capacity", [1, 7, 64])
@pytest.mark.parametrize("target", [None, 3.5, 1e9])
def test_chunk_bounds_by_cost_equal_jax(capacity, target):
    rng = np.random.default_rng(capacity)
    for w in (rng.integers(0, 50, 300).astype(np.float64),
              rng.pareto(1.2, 257), np.zeros(40), np.ones(1)):
        got = balance.chunk_bounds_by_cost(w, capacity, target=target)
        np.testing.assert_array_equal(
            got, jbalance.chunk_bounds_by_cost(w, capacity, target=target))
        spans = np.diff(got)
        assert got[0] == 0 and got[-1] == len(w)
        assert spans.min() > 0 and spans.max() <= capacity


def test_chunk_bounds_degenerate():
    np.testing.assert_array_equal(balance.chunk_bounds_by_cost(np.zeros(0), 8),
                                  [0])
    with pytest.raises(ValueError, match="capacity"):
        balance.chunk_bounds_by_cost(np.ones(4), 0)


@pytest.mark.parametrize("strategy", balance.PACKING)
@pytest.mark.parametrize("model", ["canonical_uniform",
                                   "canonical_nonuniform", "vertex"])
def test_pack_tasks_equal_jax(pair, strategy, model):
    jg, g = pair
    got = balance.pack_tasks(g, 4, weight_model=model, strategy=strategy,
                             pad_multiple=8)
    want = jbalance.pack_tasks(jg, 4, weight_model=model, strategy=strategy,
                               pad_multiple=8)
    for f in ("u", "v", "valid", "weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.imbalance == want.imbalance
    assert got.u.shape[1] % 8 == 0
    # every canonical dyad lands in exactly one shard
    u, v = canonical_dyads(g)
    keys = np.sort((got.u * g.n + got.v)[got.valid])
    np.testing.assert_array_equal(keys, np.sort(u.astype(np.int64) * g.n + v))


def test_pack_tasks_rejects_unknown_strategy(pair):
    _, g = pair
    with pytest.raises(ValueError, match="strategy"):
        balance.pack_tasks(g, 2, strategy="round_robin")
