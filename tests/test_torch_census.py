"""The port's census device programs against their JAX counterparts, on
identical CSRs: dyad enumeration, the degree-bucket sort (order included),
the host bucket schedule, the transpose CSR, the tile gather, the search
backend's batch program, and the brute-force oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import census as jcensus
from repro.core import generators as jgen
from repro.engine import EngineConfig as JConfig
from repro.engine import compile as jcompile
from repro.kernels import ops as jops
from repro_torch.core import census as tcensus
from repro_torch.core.graph import graph_from_reference_arrays
from repro_torch.engine import EngineConfig, compile
from repro_torch.kernels import ops as tops

GRAPHS = {
    "rmat6": lambda: jgen.rmat(6, edge_factor=4, seed=0),
    "rmat7": lambda: jgen.rmat(7, edge_factor=4, seed=1),
    "er60": lambda: jgen.erdos_renyi(60, 240, seed=3),
}


def _pair(name):
    jg = GRAPHS[name]()
    tg = graph_from_reference_arrays(
        jg.n, type(jg.arrays)(*(np.asarray(a) for a in jg.arrays[:5])),
        device="cpu")
    return jg, tg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _padded(jg, tg):
    """Both packages' bucket-padded arrays with the transpose CSR."""
    ja = jcompile(jg, ("triad_census",), JConfig(backend="pallas")
                  ).padded_arrays(jg, with_in_csr=True)
    plan = compile(tg, ("triad_census",),
                   EngineConfig(backend="tiles", device="cpu"))
    return ja, plan.padded_arrays(tg, with_in_csr=True), plan


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_padded_arrays_and_transpose_csr_equal(name):
    jg, tg = _pair(name)
    ja, ta, _ = _padded(jg, tg)
    for f in ja._fields:
        np.testing.assert_array_equal(_np(getattr(ta, f)),
                                      _np(getattr(ja, f)), err_msg=f)
    for a, b in zip(tops.build_in_csr(tg), jops.build_in_csr(jg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dyad_enumeration_and_bucket_sort_equal(name):
    """Device enumeration, the (bucket, need) sort order, the bucket
    counts and the host schedule all equal the JAX programs."""
    jg, tg = _pair(name)
    ja, ta, plan = _padded(jg, tg)
    ju, jv = jcensus.enumerate_dyads_device(
        ja.nbr_ptr, ja.nbr_idx, jnp.int32(jg.m_nbr), out_size=plan.dyad_pad)
    tu, tv = tcensus.enumerate_dyads_device(
        ta.nbr_ptr, ta.nbr_idx, tg.m_nbr, out_size=plan.dyad_pad)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for a, b in zip(tcensus.canonical_dyads(tg), jcensus.canonical_dyads(jg)):
        np.testing.assert_array_equal(a, b)
    for ks in ((4, 8, 16), (8, 32, 128), (32, 128, 512)):
        want = jcensus.sort_dyads_by_bucket(
            ja.nbr_deg, ja.out_ptr, ju, jv, jnp.int32(jg.n_dyads), ks=ks)
        got = tcensus.sort_dyads_by_bucket(ta.nbr_deg, ta.out_ptr, tu, tv,
                                           tg.n_dyads, ks=ks)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tcensus.host_bucket_schedule(tg, ks),
                        jcensus.host_bucket_schedule(jg, ks)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tile_gather_equals_reference(name):
    """Device gather == JAX device gather == host build_tiles, including
    blanked invalid rows; every row sorted with a SENTINEL tail."""
    jg, tg = _pair(name)
    ja, ta, _ = _padded(jg, tg)
    u, v = tcensus.canonical_dyads(tg)
    valid = np.arange(len(u)) % 7 != 3
    K = tg.max_deg
    want = jops.gather_tiles_device(ja, jnp.asarray(u), jnp.asarray(v),
                                    jnp.asarray(valid), K=K)
    got = tops.gather_tiles_device(ta, torch.as_tensor(u),
                                   torch.as_tensor(v),
                                   torch.as_tensor(valid), K=K)
    host = tops.build_tiles(tg, u.astype(np.int64), v.astype(np.int64), K)
    jhost = jops.build_tiles(jg, u.astype(np.int64), v.astype(np.int64), K)
    for k in tops.TILE_NAMES:
        t = got[k].numpy()
        np.testing.assert_array_equal(t, np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(host[k], jhost[k], err_msg=k)
        np.testing.assert_array_equal(t[valid], host[k][valid], err_msg=k)
        assert (np.diff(t.astype(np.int64), axis=1) >= 0).all()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_batch_program_partials_equal_reference(name):
    """The search backend's ragged batch program gives the JAX dense batch
    program's (16,) partials batch by batch, padded lanes included."""
    jg, tg = _pair(name)
    plan = compile(tg, ("triad_census",),
                   EngineConfig(backend="search", device="cpu"))
    meta = plan.meta
    jfn = jax.jit(jcensus.make_census_batch_fn(meta.k, meta.member_iters))
    tfn = tcensus.make_census_batch_fn(meta.member_iters)
    u, v = tcensus.canonical_dyads(tg)
    deg = tg.host.nbr_deg.astype(np.int64)
    B = 32
    for s in range(0, len(u), B):
        uu, vv, valid = tcensus.pad_dyads(u[s:s + B], v[s:s + B], B)
        want = jfn(jg.arrays, jnp.int32(jg.n), jnp.asarray(uu),
                   jnp.asarray(vv), jnp.asarray(valid))
        n_cand = int((deg[uu] + deg[vv])[valid].sum())
        got = tfn(tg.arrays, tg.n, torch.as_tensor(uu), torch.as_tensor(vv),
                  torch.as_tensor(valid), n_cand)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_dyads_equal():
    u = np.array([0, 2, 5], np.int32)
    v = np.array([1, 4, 9], np.int32)
    for a, b in zip(tcensus.pad_dyads(u, v, 4), jcensus.pad_dyads(u, v, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_brute_force_equals_reference(name):
    jg, tg = _pair(name)
    np.testing.assert_array_equal(tcensus.brute_force_census(tg).counts,
                                  jcensus.brute_force_census(jg).counts)
