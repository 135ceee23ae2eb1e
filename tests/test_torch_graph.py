"""The port's graph core against the JAX package: CSR arrays, generators,
the triad table, the Pajek loader, and the CSR hand-over between the two
packages.  Inputs come from numpy seeds; both packages see the same arcs."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import generators as jgen
from repro.core import graph as jgraph
from repro.core import triad_table as jtable
from repro_torch.core import generators as tgen
from repro_torch.core import graph as tgraph
from repro_torch.core import triad_table as ttable

FIELDS = ("out_ptr", "out_idx", "nbr_ptr", "nbr_idx", "nbr_deg")


def _arcs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = 40
        return n, rng.integers(0, n, 160), rng.integers(0, n, 160), True
    if kind == "undirected":
        n = 30
        return n, rng.integers(0, n, 70), rng.integers(0, n, 70), False
    return 12, np.array([], np.int64), np.array([], np.int64), True


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 1),
                                       ("undirected", 2), ("empty", 0)])
def test_csr_arrays_equal_reference(kind, seed):
    """Same arcs -> the five CSR arrays and the metadata equal the JAX
    package's host arrays element by element."""
    n, src, dst, directed = _arcs(kind, seed)
    want, *want_meta = jgraph._build_host_arrays(n, src, dst,
                                                 directed=directed)
    g = tgraph.from_edges(n, src, dst, directed=directed, device="cpu")
    assert (g.m, g.m_nbr, g.max_deg, g.max_out_deg) == tuple(want_meta)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(g.host, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(g.arrays, f).numpy(),
                                      getattr(want, f))
        assert getattr(g.arrays, f).dtype == torch.int32


@pytest.mark.parametrize("make", [
    lambda m, dev: m.rmat(5, edge_factor=4, seed=0, **dev),
    lambda m, dev: m.rmat(7, edge_factor=4, seed=2, **dev),
    lambda m, dev: m.rmat(6, edge_factor=4, seed=1, directed=False, **dev),
    lambda m, dev: m.erdos_renyi(60, 240, seed=3, **dev),
    lambda m, dev: m.paper_profile("slashdot", scale_down=512, seed=0,
                                   **dev),
], ids=["rmat5", "rmat7", "rmat6-undirected", "er60", "slashdot-512"])
def test_generators_give_same_arcs(make):
    want = make(jgen, {})
    g = make(tgen, {"device": "cpu"})
    assert (g.n, g.m, g.m_nbr, g.max_deg) == (want.n, want.m, want.m_nbr,
                                              want.max_deg)
    for a, b in zip(tgraph.arcs_host(g), jgraph.arcs_host(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgraph.dense_adjacency(g),
                                  jgraph.dense_adjacency(want))


def test_paper_datasets_and_next_pow2_equal():
    assert tgen.PAPER_DATASETS == jgen.PAPER_DATASETS
    for x in (0, 1, 2, 3, 5, 64, 65, 6095, 8192, 8193):
        assert tgraph.next_pow2(x) == jgraph.next_pow2(x)


def test_triad_table_equal():
    np.testing.assert_array_equal(ttable.TRIAD_TABLE_64, jtable.TRIAD_TABLE_64)
    assert ttable.TRIAD_NAMES == jtable.TRIAD_NAMES
    np.testing.assert_array_equal(ttable.CLASS_MULTIPLICITY,
                                  jtable.CLASS_MULTIPLICITY)


def test_cuda_kernel_table_equals_triad_table():
    """The CUDA kernel carries its own copy of the table in constant
    memory; it must be TRIAD_TABLE_64 entry for entry."""
    src = (Path(tgraph.__file__).parents[1] / "kernels" / "csrc"
           / "census_tiles.cu").read_text()
    body = re.search(r"c_triad_table\[64\]\s*=\s*\{([^}]*)\}", src).group(1)
    values = [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]
    np.testing.assert_array_equal(values, ttable.TRIAD_TABLE_64)


def test_pajek_file_gives_same_csr(tmp_path):
    path = tmp_path / "g.net"
    path.write_text("% exported by an SNA tool\n*Vertices 7\n1 \"a\"\n"
                    "2 \"b\"\n*Arcs\n1 2\n2 3\n3 1\n6 7\n*Edges\n4 5\n"
                    "5 6\n")
    want = jgraph.load_pajek_or_edgelist(str(path))
    g = tgraph.load_pajek_or_edgelist(str(path), device="cpu")
    assert (g.n, g.m, g.m_nbr) == (want.n, want.m, want.m_nbr) == (7, 8, 12)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(g.host, f),
                                      np.asarray(getattr(want.arrays, f)))


def test_graph_from_reference_arrays_round_trips():
    """JAX arrays -> port graph equals the port's own build; the port's host
    arrays -> port graph round-trips."""
    want = jgen.rmat(6, edge_factor=4, seed=4)
    host = jgraph.GraphArrays(*(np.asarray(a) for a in want.arrays[:5]))
    g = tgraph.graph_from_reference_arrays(want.n, host, device="cpu")
    own = tgen.rmat(6, edge_factor=4, seed=4, device="cpu")
    again = tgraph.graph_from_reference_arrays(own.n, own.host, device="cpu")
    for h in (g, again):
        assert (h.n, h.m, h.m_nbr, h.max_deg, h.max_out_deg) == (
            own.n, own.m, own.m_nbr, own.max_deg, own.max_out_deg)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(h.arrays, f).numpy(),
                                          getattr(own.host, f))


def test_device_rule_never_falls_back_to_cpu():
    """``device=None`` means CUDA; without CUDA it raises."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: device=None runs on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.rmat(5, edge_factor=4, seed=0)
    assert tgraph.resolve_device("cpu") == torch.device("cpu")
