"""The CSR census kernel (``census_csr``, the census main path's kernel):
its plain torch version against the Pallas kernel (interpret mode), the
port's six-tile plain version and the brute-force census, integer-exact;
the arc flags and range counts against their numpy twin; the CUDA kernel
against the plain version where a card is present.

The JAX package is imported inside the tests that compare with it, so the
CUDA cases also run on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_census_csr.py``.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census
from repro_torch.core import census as tcensus
from repro_torch.core import generators as tgen
from repro_torch.core import triad_table as ttable
from repro_torch.core.delta import GraphDelta
from repro_torch.core.graph import from_edges
from repro_torch.engine import EngineConfig, compile
from repro_torch.engine import backends
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import census_csr_ref, census_tiles_ref
from repro_torch.kernels.triad_census import (SENTINEL, census_csr,
                                              census_tiles)

GRAPHS = {
    "rmat5": lambda **d: tgen.rmat(5, edge_factor=4, seed=0, **d),
    "rmat6": lambda **d: tgen.rmat(6, edge_factor=4, seed=1, **d),
    "rmat7": lambda **d: tgen.rmat(7, edge_factor=8, seed=2, **d),
    "er60": lambda **d: tgen.erdos_renyi(60, 240, seed=3, **d),
}
N_LARGE = 2**22 + 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census kernel has no CPU mode")
    return torch.device("cuda")


def _arrays(g, device="cpu", *, with_in_csr=False):
    plan = compile(g, ("triad_census",),
                   EngineConfig(backend="tiles", device=device))
    return plan.padded_arrays(g, with_flags=True, with_in_csr=with_in_csr)


def _dyads(g, block, n_pad, device="cpu"):
    """Canonical dyads of ``g`` followed by SENTINEL dyads, at least
    ``n_pad`` of them, to a multiple of ``block``."""
    u, v = tcensus.canonical_dyads(g)
    D = len(u) + n_pad
    D += (-D) % block
    uu = np.full(D, SENTINEL, np.int32)
    vv = np.full(D, SENTINEL, np.int32)
    uu[: len(u)], vv[: len(u)] = u, v
    return (torch.as_tensor(uu, device=device),
            torch.as_tensor(vv, device=device))


def _tiles(arrays, u, v, K):
    valid = u != SENTINEL
    t = tops.gather_tiles_device(arrays, u, v, valid, K=K)
    return [t[k] for k in tops.TILE_NAMES]


def _closed_form(g, partial_sum):
    counts = np.asarray(partial_sum, np.int64).copy()
    counts[0] = g.n * (g.n - 1) * (g.n - 2) // 6 - counts.sum()
    return counts


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_flags_and_counts_equal_numpy_twin(name):
    """Padding included: padded arcs get flag 0 and count 0."""
    g = GRAPHS[name](device="cpu")
    a = _arrays(g)
    flags, counts = tops.build_arc_flags(
        *(x.numpy() for x in (a.out_ptr, a.out_idx, a.nbr_ptr, a.nbr_idx)))
    np.testing.assert_array_equal(a.nbr_flag.numpy(), flags)
    np.testing.assert_array_equal(a.nbr_cnt.numpy(), counts)
    M = a.nbr_idx.shape[0]
    assert a.nbr_flag.dtype == torch.int8 and a.nbr_flag.shape == (M,)
    assert a.nbr_cnt.dtype == torch.int32 and a.nbr_cnt.shape == (M,)
    live = np.arange(M) < g.m_nbr
    assert (flags[live] > 0).all() and not flags[~live].any()
    assert not counts[~live].any()


def _wide(a):
    """``a`` with its range counts rebuilt in the wide layout."""
    flags, counts = tops.build_arc_flags_device(
        a.out_ptr, a.out_idx, a.nbr_ptr, a.nbr_idx, wide=True)
    assert torch.equal(flags, a.nbr_flag)
    return a._replace(nbr_cnt=counts)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_wide_counts_equal_numpy_twin_and_packed_fields(name):
    """The wide layout: two int32 rows, padding included, equal to the
    numpy twin and to the packed layout's two 16-bit fields."""
    g = GRAPHS[name](device="cpu")
    a = _arrays(g)
    wide = _wide(a).nbr_cnt
    flags, counts = tops.build_arc_flags(
        *(x.numpy() for x in (a.out_ptr, a.out_idx, a.nbr_ptr, a.nbr_idx)),
        wide=True)
    np.testing.assert_array_equal(a.nbr_flag.numpy(), flags)
    np.testing.assert_array_equal(wide.numpy(), counts)
    assert wide.dtype == torch.int32 and wide.shape == (2, a.nbr_idx.shape[0])
    packed = a.nbr_cnt.long()
    assert torch.equal(wide[0].long(), packed & 0xFFFF)
    assert torch.equal(wide[1].long(), (packed >> 16) & 0xFFFF)


@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_wide_counts_give_the_same_partials(name, block):
    g = GRAPHS[name](device="cpu")
    a = _arrays(g)
    u, v = _dyads(g, block, 5)
    assert torch.equal(census_csr(u, v, g.n, _wide(a), k=g.max_deg,
                                  block=block),
                       census_csr(u, v, g.n, a, k=g.max_deg, block=block))


@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("name", ["rmat5", "er60"])
def test_plain_version_equals_pallas_and_tile_plain_version(name, block):
    """Tolerance 0, row for row: the per-block partials equal the Pallas
    kernel's (interpret mode, reduce=False) on tiles from the JAX
    package's own gather, and the port's six-tile plain version's."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import generators as jgen
    from repro.engine import EngineConfig as JConfig
    from repro.engine import compile as jcompile
    from repro.kernels import ops as jops
    from repro.kernels.triad_census import census_tiles_pallas

    jg = {"rmat5": lambda: jgen.rmat(5, edge_factor=4, seed=0),
          "er60": lambda: jgen.erdos_renyi(60, 240, seed=3)}[name]()
    g = GRAPHS[name](device="cpu")
    assert block * g.n < 2**24  # the Pallas float32 epilogue is exact here
    a = _arrays(g, with_in_csr=True)
    u, v = _dyads(g, block, 11)
    got = census_csr(u, v, g.n, a, k=g.max_deg, block=block)
    assert got.dtype == torch.int32 and got.shape == (u.shape[0] // block, 16)

    ja = jcompile(jg, ("triad_census",), JConfig(backend="pallas")
                  ).padded_arrays(jg, with_in_csr=True)
    valid = u != SENTINEL
    jt = jops.gather_tiles_device(
        ja, jnp.asarray(torch.where(valid, u, 0).numpy()),
        jnp.asarray(torch.where(valid, v, 0).numpy()),
        jnp.asarray(valid.numpy()), K=g.max_deg)
    want = census_tiles_pallas(jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
                               g.n, *(jt[k] for k in tops.TILE_NAMES),
                               block=block, reduce=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tiles = _tiles(a, u, v, g.max_deg)
    np.testing.assert_array_equal(
        got.numpy(), census_tiles_ref(*tiles, u, v, g.n, block=block).numpy())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sum_over_run_equals_brute_force(name):
    g = GRAPHS[name](device="cpu")
    u, v = _dyads(g, 8, 3)
    total = census_csr_ref(u, v, g.n, _arrays(g))
    np.testing.assert_array_equal(_closed_form(g, total.numpy()),
                                  brute_force_census(g).counts)


def _large_n_graph(extras: bool):
    """The 32 asymmetric dyads (2i -> 2i+1) of the large-n tile case at
    n = 2**22 + 3, as a graph.  The tile case gives 16 of them (its seeded
    permutation) an extra neighbour w = n - 1 - i in N(u) with no arc to
    u: tiles can hold that, a CSR cannot (N is the union of the arcs).
    Without the extras every dyad adds n - 2 to bin 012 (32 * (n - 2) =
    134217760, the tile case's exact bin 012); with them, as mutual arcs
    u <-> w, bin 012 is 16 (n - 2) + 16 (n - 3)."""
    D = 32
    u = np.arange(D, dtype=np.int64) * 2
    src, dst = list(u), list(u + 1)
    if extras:
        pick = np.random.default_rng(0).permutation([True] * 16 + [False] * 16)
        w = N_LARGE - 1 - np.arange(D)
        src += list(u[pick]) + list(w[pick])
        dst += list(w[pick]) + list(u[pick])
    return from_edges(N_LARGE, np.asarray(src), np.asarray(dst), device="cpu")


def _large_n_inputs(extras, device="cpu"):
    g = _large_n_graph(extras)
    a = g.arrays
    flags, counts = tops.build_arc_flags_device(a.out_ptr, a.out_idx,
                                                a.nbr_ptr, a.nbr_idx)
    a = a._replace(nbr_flag=flags, nbr_cnt=counts)
    a = type(a)(*(None if t is None else t.to(device) for t in a))
    u, v = tcensus.canonical_dyads(g)
    u = torch.as_tensor(u, device=device)
    v = torch.as_tensor(v, device=device)
    D = u.shape[0] + (-u.shape[0]) % 32
    pad = torch.full((D - u.shape[0],), SENTINEL, dtype=torch.int32,
                     device=device)
    return g, a, torch.cat([u, pad]), torch.cat([v, pad])


@pytest.mark.parametrize("extras", [False, True], ids=["tile-case", "extras"])
def test_large_n_case_is_exact(extras):
    """block * n > 2**24: the int32 partials stay exact (the Pallas
    kernel's float32 epilogue would round here, ROADMAP Queue 3)."""
    g, a, u, v = _large_n_inputs(extras)
    got = census_csr(u, v, g.n, a, k=g.max_deg, block=32)
    bins = got.long().sum(0)
    if not extras:
        assert int(bins[1]) == 32 * (N_LARGE - 2) == 134217760
        return
    assert int(bins[1]) == 16 * (N_LARGE - 2) + 16 * (N_LARGE - 3)
    assert int(bins[2]) == 16 * (N_LARGE - 3)
    full = g.arrays._replace(nbr_flag=a.nbr_flag, nbr_cnt=a.nbr_cnt)
    in_ptr, in_idx = tops.build_in_csr_device(full.out_ptr, full.out_idx)
    full = full._replace(in_ptr=in_ptr, in_idx=in_idx)
    want = census_tiles_ref(*_tiles(full, u, v, g.max_deg), u, v, g.n,
                            block=32)
    assert torch.equal(got, want)


def test_tiles_backend_runs_csr_kernel_once_per_chunk(monkeypatch):
    """The main path calls census_csr once per chunk with the chunk's
    bucket width as its bound, and never gathers tiles."""
    calls = []

    def counting(u, v, n, arrays, *, k, block):
        valid = u != SENTINEL
        deg = arrays.nbr_ptr[1:] - arrays.nbr_ptr[:-1]
        rows = torch.cat([u[valid], v[valid]]).long()
        calls.append((k, int(deg[rows].max())))
        return census_csr(u, v, n, arrays, k=k, block=block)

    def forbidden(*args, **kwargs):
        raise AssertionError("the main path gathered tiles")

    monkeypatch.setattr(backends, "census_csr", counting)
    monkeypatch.setattr(backends, "gather_tiles_device", forbidden)
    g = GRAPHS["rmat7"](device="cpu")
    cfg = EngineConfig(backend="tiles", device="cpu", chunk_dyads=64,
                       batch=16)
    plan = compile(g, ("triad_census",), cfg)
    raw = plan.run_raw(g)
    assert len(calls) == plan.stats["chunks"] > 1
    widths = {min(b, plan.meta.k) for b in plan.config.buckets} | {
        plan.meta.k}
    assert all(k in widths and row <= k for k, row in calls)
    assert plan.meta.k in {k for k, _ in calls}
    counts = plan.layout.finalize(raw, g)["triad_census"].counts
    np.testing.assert_array_equal(counts, brute_force_census(g).counts)

    # the same rule at the fused, batch and delta-subset call sites
    fused = compile(g, ("triad_census", "dyad_census", "degree_stats"),
                    dataclasses.replace(cfg, delta_threshold=1.0))
    g2 = GRAPHS["rmat7"](device="cpu")
    u, v = tcensus.canonical_dyads(g)
    delta = GraphDelta(edges_removed=np.stack([u[:6], v[:6]], 1),
                       edges_added=[(1, 90), (90, 3), (7, 8)])
    raw = fused.run_raw(g)
    for run in (lambda: fused.run_raw(g),
                lambda: fused.run_batch([g, g2]),
                lambda: fused.apply_delta(g, delta, raw).mode == "delta"):
        calls.clear()
        chunks = fused.stats["chunks"]
        assert run() is not False
        assert len(calls) == fused.stats["chunks"] - chunks > 0
        assert all(k in widths and row <= k for k, row in calls)


def test_cpu_path_launches_no_kernel():
    g = GRAPHS["rmat5"](device="cpu")
    u, v = _dyads(g, 8, 0)
    before = census_csr.launches
    census_csr(u, v, g.n, _arrays(g), k=g.max_deg, block=8)
    assert census_csr.launches == before


@pytest.mark.parametrize("mutate,match", [
    (lambda a: dict(a, block=7), "multiple of block"),
    (lambda a: dict(a, n=2**27), "below 2\\*\\*30"),
    (lambda a: dict(a, u=a["u"].long()), "int32"),
    (lambda a: dict(a, arrays=a["arrays"]._replace(nbr_flag=None)),
     "nbr_flag and nbr_cnt"),
    (lambda a: dict(a, arrays=a["arrays"]._replace(
        nbr_flag=a["arrays"].nbr_flag[:-1].contiguous())), "length"),
    (lambda a: dict(a, arrays=a["arrays"]._replace(
        nbr_cnt=a["arrays"].nbr_cnt[:-1].contiguous())), "length"),
    (lambda a: dict(a, v=a["v"][:-1].contiguous()), "must be"),
], ids=["block", "n", "dtype", "no-flags", "flag-length", "count-length",
        "length"])
def test_wrapper_rejects_bad_inputs(mutate, match):
    g = GRAPHS["rmat5"](device="cpu")
    u, v = _dyads(g, 8, 0)
    a = mutate(dict(u=u, v=v, n=g.n, arrays=_arrays(g), block=8))
    with pytest.raises(ValueError, match=match):
        census_csr(a["u"], a["v"], a["n"], a["arrays"], k=g.max_deg,
                   block=a["block"])


def test_degree_past_packed_counts_takes_wide_layout():
    """Past degree 2**16 - 1 the plan builds the wide range counts, and the
    tiles backend gives the exact census.  The graph is a star whose hub
    has 66,000 out-arcs, more than a 16-bit field holds, 2,000 in-arcs and
    2,000 mutual arcs, plus 10 isolated vertices: triad {hub, i, j} has
    code dir(hub, i) + 4 dir(hub, j), and {hub, i, isolated} is a 012
    triad, or a 102 one when i is mutual."""
    n_cls = {1: 66_000, 2: 2_000, 3: 2_000}
    k = sum(n_cls.values())
    n = k + 1 + 10
    leaves = np.arange(1, k + 1)
    kind = np.repeat([1, 2, 3], list(n_cls.values()))
    src = np.concatenate([np.zeros(int((kind != 2).sum()), np.int64),
                          leaves[kind != 1]])
    dst = np.concatenate([leaves[kind != 2],
                          np.zeros(int((kind != 1).sum()), np.int64)])
    g = from_edges(n, src, dst, device="cpu")
    assert g.max_deg == k > tops.MAX_PACKED_DEGREE
    plan = compile(g, ("triad_census",),
                   EngineConfig(backend="tiles", device="cpu"))
    assert plan.padded_arrays(g, with_flags=True).nbr_cnt.shape[0] == 2
    want = np.zeros(16, np.int64)
    for a in (1, 2, 3):
        for b in (1, 2, 3):
            pairs = (n_cls[a] * (n_cls[a] - 1) // 2 if a == b
                     else n_cls[a] * n_cls[b] if a < b else 0)
            want[ttable.TRIAD_TABLE_64[a + 4 * b]] += pairs
    want[1] += 10 * (n_cls[1] + n_cls[2])
    want[2] += 10 * n_cls[3]
    want[0] = n * (n - 1) * (n - 2) // 6 - want.sum()
    np.testing.assert_array_equal(plan.run(g)["triad_census"].counts, want)


def test_wide_counts_on_hub_rows_equal_tile_plain_version():
    """A hub of degree 70,000 (67,200 out-arcs) joined to a random
    digraph: the plain version on the wide counts equals the six-tile
    plain version, row for row, on hub dyads and others."""
    g = _hub_graph("cpu", degree=70_000, n=80_000, p_kind=(0.96, 0.02, 0.02))
    a = _arrays(g, with_in_csr=True)
    assert a.nbr_cnt.shape[0] == 2
    u, v = _hub_dyads(g, 16, "cpu")
    got = census_csr(u, v, g.n, a, k=g.max_deg, block=8)
    want = census_tiles_ref(*_tiles(a, u, v, g.max_deg), u, v, g.n, block=8)
    assert torch.equal(got, want)


def test_cuda_kernel_table_equals_triad_table():
    src = (Path(tops.__file__).parent / "csrc" / "census_csr.cu").read_text()
    body = re.search(r"c_triad_table\[64\]\s*=\s*\{([^}]*)\}", src).group(1)
    values = [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]
    np.testing.assert_array_equal(values, ttable.TRIAD_TABLE_64)


def _hub_graph(device, degree=30_000, n=40_000, seed=0,
               p_kind=(1 / 3, 1 / 3, 1 / 3)):
    """One hub (vertex 0) joined to ``degree`` vertices, out, in or mutual
    with probabilities ``p_kind``, plus a sparse random digraph among the
    rest, so hub dyads have non-empty intersections."""
    rng = np.random.default_rng(seed)
    leaves = rng.choice(np.arange(1, n), size=degree, replace=False)
    kind = rng.choice(3, size=degree, p=p_kind)
    src = [np.zeros(int((kind != 1).sum()), np.int64), leaves[kind != 0]]
    dst = [leaves[kind != 1], np.zeros(int((kind != 0).sum()), np.int64)]
    m = 4 * n
    src.append(rng.integers(1, n, m))
    dst.append(rng.integers(1, n, m))
    return from_edges(n, np.concatenate(src), np.concatenate(dst),
                      device=device)


def _hub_dyads(g, count, device):
    """The first ``count`` canonical dyads of the hub (vertex 0) and the
    first ``count`` of the rest."""
    u, v = tcensus.canonical_dyads(g)
    pick = np.concatenate([np.flatnonzero(u == 0)[:count],
                           np.flatnonzero(u != 0)[:count]])
    return (torch.as_tensor(u[pick], device=device),
            torch.as_tensor(v[pick], device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 128, 512, 8192])
@pytest.mark.parametrize("block", [8, 32])
def test_cuda_kernel_equals_plain_version(cuda_device, block, k):
    """Both mappings (warp per dyad up to k = 512, CTA above), with bounds
    below the rows too: the bound only picks the mapping."""
    for name in ("rmat7", "er60"):
        g = GRAPHS[name](device=cuda_device)
        a = _arrays(g, cuda_device)
        u, v = _dyads(g, block, 5, cuda_device)
        for arrays in (a, _wide(a)):
            before = census_csr.launches
            got = census_csr(u, v, g.n, arrays, k=k, block=block)
            torch.cuda.synchronize()
            assert census_csr.launches == before + 1
            assert torch.equal(got, census_csr_ref(u, v, g.n, a, block=block))


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [30_000, 70_000])
@pytest.mark.parametrize("block", [8, 32])
def test_cuda_kernel_hub_rows(cuda_device, block, degree):
    """Hub rows of 30,000 and 70,000 entries (the latter past the packed
    counts, 96 % of its arcs out of the hub, so in the wide layout), on
    256 hub dyads and 256 others, through both mappings."""
    g = _hub_graph(cuda_device, degree=degree, n=degree + 10_000,
                   p_kind=(0.96, 0.02, 0.02))
    a = _arrays(g, cuda_device)
    assert a.nbr_cnt.dim() == (2 if degree > tops.MAX_PACKED_DEGREE else 1)
    u, v = _hub_dyads(g, 256, cuda_device)
    want = census_csr_ref(u, v, g.n, a, block=block)
    for k in (512, g.max_deg):
        assert torch.equal(census_csr(u, v, g.n, a, k=k, block=block), want)


@pytest.mark.cuda
@pytest.mark.parametrize("extras", [False, True], ids=["tile-case", "extras"])
def test_cuda_kernel_large_n_case(cuda_device, extras):
    g, a, u, v = _large_n_inputs(extras, cuda_device)
    got = census_csr(u, v, g.n, a, k=g.max_deg, block=32)
    assert torch.equal(got, census_csr_ref(u, v, g.n, a, block=32))
    if not extras:
        assert int(got.long().sum(0)[1]) == 134217760


@pytest.mark.cuda
def test_cuda_main_path_equals_search(cuda_device):
    g = GRAPHS["rmat7"](device=cuda_device)
    raws = {}
    for backend in ("tiles", "search"):
        plan = compile(g, ("triad_census",),
                       EngineConfig(backend=backend, device=cuda_device))
        before = (census_csr.launches, census_tiles.launches)
        raws[backend] = plan.run_raw(g)
        if backend == "tiles":
            assert census_csr.launches - before[0] == plan.stats["chunks"]
            assert census_tiles.launches == before[1]
    np.testing.assert_array_equal(raws["tiles"], raws["search"])


@pytest.mark.cuda
def test_cuda_main_path_launches_once_per_bucket(cuda_device):
    """Past 8,192 dyads the default census plan launches ``census_csr``
    once per non-empty degree bucket (the top one through the CTA
    mapping), one launch per task, cold and warm; bins equal search's."""
    g = tgen.rmat(12, edge_factor=8, seed=0, device=cuda_device)
    assert g.n_dyads > 8192 and g.max_deg > 512
    plan = compile(g, ("triad_census",),
                   EngineConfig(backend="tiles", device=cuda_device))
    _, chunk, ks = backends.tiles_geometry(plan)
    assert chunk is None
    for runs in (1, 2):
        before, chunks = census_csr.launches, plan.stats["chunks"]
        raw = plan.run_raw(g)
        launches = census_csr.launches - before
        assert launches == plan.stats["chunks"] - chunks <= len(ks)
        assert plan.stats["bucket_passes"] == runs
    search = compile(g, ("triad_census",),
                     EngineConfig(backend="search", device=cuda_device))
    np.testing.assert_array_equal(raw, search.run_raw(g))
