"""The plain reference census against a brute-force count, and its
lower-precision controls against the exact comparison."""
import itertools

import pytest
import torch

from perfbench import answers, graphs, reference, triads
from perfbench.tests.helpers import BENCH, tiny
from perfbench.harness import load_config


def stand_in(config: str, n: int, seed: int):
    """``(n, src, dst)`` of a configuration's stand-in cut to ``n``
    vertices."""
    return graphs.arcs(tiny(n)(load_config(BENCH, config))["graph"], seed,
                       "cpu")


def brute(n, src, dst):
    arcs = set(zip(src.tolist(), dst.tolist()))
    counts = [0] * 16
    for trip in itertools.combinations(range(n), 3):
        pos = {x: i for i, x in enumerate(trip)}
        a = {(pos[x], pos[y]) for x, y in itertools.permutations(trip, 2)
             if x != y and (x, y) in arcs}
        counts[triads.NAMES.index(triads.classify(a))] += 1
    return counts


def random_digraph(seed, n, m):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, n, (m,), generator=g),
            torch.randint(0, n, (m,), generator=g))


@pytest.mark.parametrize("seed,n,m", [(0, 9, 20), (1, 14, 60), (2, 17, 90),
                                      (3, 20, 160), (4, 12, 130)])
def test_census_equals_brute_force(seed, n, m):
    src, dst = random_digraph(seed, n, m)
    assert reference.census(n, src, dst, block=5) == brute(n, src, dst)


def test_table_matches_networkx():
    nx = pytest.importorskip("networkx.algorithms.triads")
    assert [triads.NAMES[t] for t in triads.TABLE] == \
        [nx.TRIAD_NAMES[c - 1] for c in nx.TRICODES]


@pytest.mark.parametrize("config", ["amazon", "patents"])
def test_census_equals_the_programs_oracle_on_the_stand_ins(config):
    from repro_torch.core.census import brute_force_census
    from repro_torch.core.graph import from_edges

    n, src, dst = stand_in(config, 128, 5)
    g = from_edges(n, src.numpy(), dst.numpy(), device="cpu")
    want = [int(x) for x in brute_force_census(g).counts]
    assert reference.census(n, src, dst, block=64) == want


def test_block_size_does_not_change_the_counts():
    n, src, dst = stand_in("amazon", 1024, 9)
    full = reference.census(n, src, dst)
    assert reference.census(n, src, dst, block=97) == full
    assert sum(full) == n * (n - 1) * (n - 2) // 6


def test_degree_stats_against_a_loop():
    src, dst = random_digraph(6, 40, 300)
    s, d = reference.directed_arcs(40, src, dst)
    out = [0] * 40
    inn = [0] * 40
    for a, b in zip(s.tolist(), d.tolist()):
        out[a] += 1
        inn[b] += 1

    def hist(deg):
        h = [0] * 16
        for x in deg:
            h[min(x.bit_length(), 15)] += 1
        return h

    r = reference.degree_stats(40, src, dst)
    assert r["out_hist"] == hist(out) and r["in_hist"] == hist(inn)
    assert (r["max_out"], r["max_in"]) == (max(out), max(inn))
    assert r["mean_out"] == r["mean_in"] == len(s) / 40


@pytest.mark.parametrize("acc", ["int32", "float32"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_lower_precision_control_fails_the_comparison(acc, seed):
    """The control at a size a test run holds: the Amazon stand-in cut
    to 8,192 vertices, where C(n, 3) and the one-dyad counts pass 2**31
    and 2**24."""
    from perfbench import control

    cfg = tiny(8192)(load_config(BENCH, "amazon"))
    r, = control.readings(cfg, seed, "cpu", precisions=(acc,))
    assert r["bins_off"] > r["limit"] == answers.op("triad_census").LIMIT
    assert r["graph"]["arcs"] == cfg["graph"]["m"]
    assert r["graph"]["max_out"] <= 10
