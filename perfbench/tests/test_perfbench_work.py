"""The census's work, counted by hand on a small graph, and the stand-in
generator's determinism and the laws it is held to."""
import math

import pytest
import torch

from perfbench import graphs, work
from perfbench.harness import load_config
from perfbench.tests.helpers import BENCH, tiny


def test_work_of_a_hand_counted_graph():
    # arcs 0->1, 1->0, 0->2, 3->0, 2->3, and a self-loop and a repeat
    src = torch.tensor([0, 1, 0, 3, 2, 2, 0])
    dst = torch.tensor([1, 0, 2, 0, 3, 2, 2])
    n = 5
    w = work.census_work(n, src, dst)
    # dyads {0,1} {0,2} {0,3} {2,3}; undirected degrees 0:3 1:1 2:2 3:2
    # compares: min * bitlen(max): 1*2 + 2*2 + 2*2 + 2*2 = 14
    assert w["compares"] == 14
    D, m = 4, 5
    assert w["bytes"] == (4 * (n + 1) + 8 * D) + (4 * (n + 1) + 4 * m) \
        + 8 * D + 8 * 16
    assert math.isclose(w["bound_s"], max(14 / work.INT32_OPS_PER_S,
                                          w["bytes"] / work.HBM_BYTES_PER_S))


def test_int32_lane_rate_is_the_architectures():
    assert work.INT32_OPS_PER_S == 132 * 64 * 1.98e9


def _graph(config, n):
    return tiny(n)(load_config(BENCH, config))["graph"]


@pytest.mark.parametrize("config", ["amazon", "patents"])
def test_stand_in_is_deterministic_by_seed(config):
    g = _graph(config, 2048)
    a = graphs.arcs(g, 2 ** 31 + 7, "cpu")
    b = graphs.arcs(g, 2 ** 31 + 7, "cpu")
    c = graphs.arcs(g, 2 ** 31 + 8, "cpu")
    assert a[0] == 2048 and a[1].numel() == g["m"]
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[1], c[1])
    assert int(a[1].max()) < 2048 and int(a[2].min()) >= 0


@pytest.mark.parametrize("config", ["amazon", "patents"])
def test_stand_in_has_exactly_m_distinct_loop_free_arcs(config):
    g = _graph(config, 4096)
    n, src, dst = graphs.arcs(g, 2 ** 32 + 1, "cpu")
    assert src.numel() == g["m"] and (src != dst).all()
    assert torch.unique(src * n + dst).numel() == g["m"]


def test_amazon_out_degree_is_at_most_its_draws():
    g = _graph("amazon", 4096)
    n, src, _ = graphs.arcs(g, 3, "cpu")
    out = torch.bincount(src, minlength=n)
    assert int(out.max()) == g["out"]["draws"] == 10


def test_patents_cites_only_older_patents():
    g = _graph("patents", 4096)
    _, src, dst = graphs.arcs(g, 4, "cpu")
    assert (dst < src).all()


def test_too_few_candidates_is_an_error_not_fewer_arcs():
    g = dict(_graph("amazon", 256), m=256 * 255 + 1)  # past n (n - 1)
    with pytest.raises(ValueError, match="draw more"):
        graphs.arcs(g, 1, "cpu")
