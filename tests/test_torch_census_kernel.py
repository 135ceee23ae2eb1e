"""The census tile kernel's plain torch version against the JAX oracle and
the Pallas kernel (interpret mode), integer-exact; the CUDA kernel against
the plain version where a card is present.

The JAX package is imported inside the tests that compare with it, so the
CUDA cases also run on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_census_kernel.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import census as tcensus
from repro_torch.core import generators as tgen
from repro_torch.engine import EngineConfig, compile
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import census_tiles_ref
from repro_torch.kernels.triad_census import SENTINEL, census_tiles


def _jax():
    """(jax.numpy, the JAX tile oracle, the Pallas tile kernel)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ref import census_tiles_ref as oracle
    from repro.kernels.triad_census import census_tiles_pallas
    return jnp, oracle, census_tiles_pallas


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census kernel has no CPU mode")
    return torch.device("cuda")


def _gathered(g, block, n_pad, K=None, device="cpu"):
    """Canonical dyads of ``g`` with ``n_pad`` SENTINEL dyads appended (a
    multiple of ``block`` in all) and their six gathered tiles."""
    plan = compile(g, ("triad_census",),
                   EngineConfig(backend="tiles", device=device))
    arrays = plan.padded_arrays(g, with_in_csr=True)
    u, v = tcensus.canonical_dyads(g)
    D = len(u) + n_pad
    D += (-D) % block
    valid = np.arange(D) < len(u)
    uu = np.zeros(D, np.int32)
    vv = np.ones(D, np.int32)
    uu[: len(u)], vv[: len(u)] = u, v
    t = dict(u=torch.as_tensor(uu, device=device),
             v=torch.as_tensor(vv, device=device))
    tiles = tops.gather_tiles_device(arrays, t["u"], t["v"],
                                     torch.as_tensor(valid, device=device),
                                     K=K or g.max_deg)
    keep = torch.as_tensor(valid, device=device)
    u_k = torch.where(keep, t["u"], SENTINEL)
    v_k = torch.where(keep, t["v"], SENTINEL)
    return u_k, v_k, [tiles[k] for k in tops.TILE_NAMES], len(u)


@pytest.mark.parametrize("make,block,n_pad", [
    (lambda: tgen.erdos_renyi(60, 240, seed=3, device="cpu"), 16, 0),
    (lambda: tgen.rmat(6, edge_factor=4, seed=0, device="cpu"), 8, 11),
], ids=["er60-block16", "rmat6-block8-padded"])
def test_plain_version_equals_oracle_and_pallas(make, block, n_pad):
    """Tolerance 0: per-block partials equal the Pallas kernel's (interpret
    mode, reduce=False), and their sum equals the JAX oracle on the real
    dyads — padded dyads add nothing."""
    jnp, jax_census_tiles_ref, census_tiles_pallas = _jax()
    g = make()
    u, v, tiles, d_real = _gathered(g, block, n_pad)
    got = census_tiles(u, v, g.n, *tiles, block=block)
    assert got.dtype == torch.int32 and got.shape == (u.shape[0] // block, 16)
    j = [jnp.asarray(t.numpy()) for t in tiles]
    want = census_tiles_pallas(jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
                               g.n, *j, block=block, reduce=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = jax_census_tiles_ref(*(t[:d_real] for t in j),
                                  jnp.asarray(u[:d_real].numpy()),
                                  jnp.asarray(v[:d_real].numpy()), g.n)
    np.testing.assert_array_equal(got.numpy().sum(0), np.asarray(oracle))
    np.testing.assert_array_equal(
        census_tiles_ref(*tiles, u, v, g.n).numpy(), np.asarray(oracle))


def _large_n_case():
    """32 asymmetric dyads (2i -> 2i+1), n = 2**22 + 3; 16 of them (a
    seeded permutation) carry one extra neighbour in N(u) with no arc to
    u or v.  Exact bin 012 = 32 * (n - 2) = 134217760."""
    n, D, K = 2**22 + 3, 32, 4
    u = np.arange(D, dtype=np.int32) * 2
    v = u + 1
    extra = np.random.default_rng(0).permutation([True] * 16 + [False] * 16)

    def tile(rows):
        t = np.full((D, K), SENTINEL, np.int32)
        for i, r in enumerate(rows):
            t[i, :len(r)] = sorted(r)
        return t

    nbr_u = [[v[i]] + ([n - 1 - i] if extra[i] else []) for i in range(D)]
    tiles = [tile([[v[i]] for i in range(D)]), tile([[]] * D),
             tile([[]] * D), tile([[u[i]] for i in range(D)]),
             tile(nbr_u), tile([[u[i]] for i in range(D)])]
    return u, v, n, tiles


def test_large_n_case_is_exact():
    """At block * n > 2**24 the port stays exact and equals the JAX
    integer oracle.  It is deliberately not compared with
    census_tiles_pallas: that kernel maps 64 -> 16 bins with a float32
    matmul and sums the dyadic term in float32, so past 2**24 its bin 012
    rounds (134217776 here on the CPU in interpret mode) — a fault of the
    reference kernel, not a tolerance to grant the port."""
    jnp, jax_census_tiles_ref, _ = _jax()
    u, v, n, tiles = _large_n_case()
    t = [torch.as_tensor(x) for x in tiles]
    got = census_tiles(torch.as_tensor(u), torch.as_tensor(v), n, *t,
                       block=32)
    want = jax_census_tiles_ref(*(jnp.asarray(x) for x in tiles),
                                jnp.asarray(u), jnp.asarray(v), n)
    np.testing.assert_array_equal(got.numpy().sum(0), np.asarray(want))
    assert int(got[0, 1]) == 32 * (n - 2) == 134217760


def test_cpu_path_launches_no_kernel():
    g = tgen.rmat(5, edge_factor=4, seed=1, device="cpu")
    u, v, tiles, _ = _gathered(g, 8, 0)
    before = census_tiles.launches
    census_tiles(u, v, g.n, *tiles, block=8)
    assert census_tiles.launches == before


@pytest.mark.parametrize("mutate,match", [
    (lambda a: dict(a, block=7), "multiple of block"),
    (lambda a: dict(a, n=2**27), "below 2\\*\\*30"),
    (lambda a: dict(a, u=a["u"].long()), "int32"),
    (lambda a: dict(a, tiles=[a["tiles"][0].t().contiguous().t()]
                    + a["tiles"][1:]), "int32"),
    (lambda a: dict(a, tiles=[a["tiles"][0][:, :-1].contiguous()]
                    + a["tiles"][1:]), "one \\(D, K\\) shape"),
    (lambda a: dict(a, v=a["v"][:-1].contiguous()), "must be"),
], ids=["block", "n", "dtype", "strided", "shape", "length"])
def test_wrapper_rejects_bad_inputs(mutate, match):
    g = tgen.rmat(5, edge_factor=4, seed=1, device="cpu")
    u, v, tiles, _ = _gathered(g, 8, 0)
    a = mutate(dict(u=u, v=v, n=g.n, tiles=tiles, block=8))
    with pytest.raises(ValueError, match=match):
        census_tiles(a["u"], a["v"], a["n"], *a["tiles"], block=a["block"])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 256, 1024])
def test_cuda_kernel_equals_plain_version(cuda_device, K):
    g = tgen.rmat(7, edge_factor=4, seed=2, device=cuda_device)
    u, v, tiles, _ = _gathered(g, 32, 5, K=K, device=cuda_device)
    before = census_tiles.launches
    got = census_tiles(u, v, g.n, *tiles, block=32)
    torch.cuda.synchronize()
    assert census_tiles.launches == before + 1
    want = census_tiles_ref(*tiles, u, v, g.n, block=32)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_kernel_large_n_case(cuda_device):
    u, v, n, tiles = _large_n_case()
    t = [torch.as_tensor(x, device=cuda_device) for x in tiles]
    got = census_tiles(torch.as_tensor(u, device=cuda_device),
                       torch.as_tensor(v, device=cuda_device), n, *t,
                       block=32)
    assert int(got[0, 1]) == 134217760
