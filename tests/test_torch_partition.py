"""The port's graph partitions against the JAX package's: the host layout
(cuts, owned dyads, halos and their owners, local CSRs) array for array,
mmap graphs, the arc flags of a shard-local CSR, and every partitioned
run — P in {1, 2, 4, 8}, both schedules, both backends, both residency
modes, all four ops — bit-equal to the JAX partitioned run on ``"xla"``
and on ``"pallas"`` (interpret mode), to the port's unpartitioned run and
to the brute-force census, in one device→host copy.  Then pool staging,
spill, deltas, faults, reordering, config validation and the stats
surfaces.  Tolerance 0.  Graphs are built in both packages from the same
seeded arc arrays.

The JAX package is imported inside the tests that compare with it, so
the CUDA case runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_partition.py``.
"""
import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.census import canonical_dyads
from repro_torch.core.delta import GraphDelta
from repro_torch.core.graph import (arcs_host, arcs_host_iter, from_edges,
                                    from_edges_mmap)
from repro_torch.core.partition import (build_local_arrays, halo_by_owner,
                                        halo_vertices, local_ptrs, owned_idx,
                                        partition_cuts, partition_graph,
                                        shard_dyads)
from repro_torch.engine import (ChunkRetryError, EngineConfig, FaultPlan,
                                GraphOp,
                                clear_plan_cache, compile, plan_cache_stats,
                                register_op, unregister_op)
from repro_torch.engine import partition as tpart
from repro_torch.kernels.ops import build_arc_flags_device
from repro_torch.serve import CensusService, ServiceConfig

ALL_OPS = ("triad_census", "dyad_census", "degree_stats", "triadic_profile")
SMALL = dict(batch=64, chunk_dyads=64)
PARTS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _arcs(seed, n=48, m=300):
    rng = np.random.default_rng(seed)
    return n, rng.integers(0, n, m), rng.integers(0, n, m)


def _star(n=33):
    return n, np.zeros(n - 1, dtype=np.int64), np.arange(1, n)


def _rmat(seed=3):
    g = tgen.rmat(7, edge_factor=4, seed=seed, device="cpu")
    return (g.n, *arcs_host(g))


GRAPHS = {"random": lambda: _arcs(5), "rmat": _rmat, "star": _star}


def port_graph(n, src, dst):
    return from_edges(n, src, dst, device="cpu")


def jax_graph(n, src, dst):
    pytest.importorskip("jax")
    from repro.core.graph import from_edges as jfrom_edges

    return jfrom_edges(n, src, dst)


def cfg(backend, **kw):
    return EngineConfig(backend=backend, device="cpu", **kw)


def base_raw(g, ops=ALL_OPS):
    return compile(g, ops, cfg("search")).run_raw(g)


# ----------------------------------------------------------------------------
# host layout: cuts, owned dyads, halos, local CSRs — against the JAX package
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_host_layout_matches_jax(name):
    from repro.core import partition as jpart

    arcs = GRAPHS[name]()
    g, jg = port_graph(*arcs), jax_graph(*arcs)
    for parts in PARTS:
        cuts = partition_cuts(g, parts)
        np.testing.assert_array_equal(cuts, jpart.partition_cuts(jg, parts))
        part, jp = partition_graph(g, parts), jpart.partition_graph(jg, parts)
        assert part.parts == jp.parts and part.dyad_counts == jp.dyad_counts
        for s, js in zip(part.shards, jp.shards):
            assert (s.index, s.lo, s.hi, s.n_dyads, s.m_out, s.m_nbr) == (
                js.index, js.lo, js.hi, js.n_dyads, js.m_out, js.m_nbr)
            np.testing.assert_array_equal(s.halo, js.halo)
            u, v = shard_dyads(g, s.lo, s.hi)
            ju, jv = jpart.shard_dyads(jg, s.lo, s.hi)
            np.testing.assert_array_equal(u, ju)
            np.testing.assert_array_equal(v, jv)
            np.testing.assert_array_equal(
                halo_vertices(g, s.lo, s.hi, np.unique(v)),
                jpart.halo_vertices(jg, s.lo, s.hi, np.unique(jv)))
            groups = halo_by_owner(cuts, s.halo)
            jgroups = jpart.halo_by_owner(cuts, js.halo)
            assert [o for o, _ in groups] == [o for o, _ in jgroups]
            for (_, a), (_, b) in zip(groups, jgroups):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(local_ptrs(g, s.lo, s.hi, s.halo),
                            jpart.local_ptrs(jg, s.lo, s.hi, js.halo)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(owned_idx(g, s.lo, s.hi),
                            jpart.owned_idx(jg, s.lo, s.hi)):
                np.testing.assert_array_equal(a, b)
            local = build_local_arrays(g, s.lo, s.hi, s.halo)
            jlocal = jpart.build_local_arrays(jg, s.lo, s.hi, js.halo)
            for f in ("out_ptr", "out_idx", "nbr_ptr", "nbr_idx", "nbr_deg"):
                np.testing.assert_array_equal(getattr(local, f),
                                              np.asarray(getattr(jlocal, f)))


def test_shard_dyads_concat_is_the_canonical_stream():
    g = port_graph(*_arcs(4))
    cuts = partition_cuts(g, 4)
    us, vs = zip(*(shard_dyads(g, int(a), int(b))
                   for a, b in zip(cuts[:-1], cuts[1:])))
    cu, cv = canonical_dyads(g)
    np.testing.assert_array_equal(np.concatenate(us), cu)
    np.testing.assert_array_equal(np.concatenate(vs), cv)


def test_star_graph_hub_row_is_every_remote_shards_halo():
    # every dyad involves the hub, so every shard that does not own
    # vertex 0 keeps its row as halo
    g = port_graph(*_star())
    part = partition_graph(g, 4)
    for s in part.shards:
        if s.n_dyads and not s.lo <= 0 < s.hi:
            assert 0 in s.halo, s
    for backend in ("tiles", "search"):
        plan = compile(g, ALL_OPS, cfg(backend, partitions=4))
        np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))


# ----------------------------------------------------------------------------
# mmap graphs
# ----------------------------------------------------------------------------

def test_mmap_graph_matches_from_edges(tmp_path):
    n, src, dst = _arcs(11, n=64, m=500)
    g = port_graph(n, src, dst)
    gm = from_edges_mmap(n, src, dst, dir=str(tmp_path))
    assert (gm.n, gm.m, gm.m_nbr, gm.max_deg, gm.max_out_deg) == (
        g.n, g.m, g.m_nbr, g.max_deg, g.max_out_deg)
    assert isinstance(gm.arrays.nbr_idx, np.memmap)
    assert gm.host is gm.arrays and gm.device == torch.device("cpu")
    for a, b in zip(g.host, gm.host):
        np.testing.assert_array_equal(a, b)
    # from_edges_mmap over a graph's own arc list gives the graph back
    g2 = from_edges_mmap(n, *arcs_host(g), dir=str(tmp_path / "again"))
    for a, b in zip(g.host, g2.host):
        np.testing.assert_array_equal(a, b)
    src1, dst1 = arcs_host(g)
    for kw in (dict(block=13), dict(cuts=partition_cuts(gm, 4))):
        pairs = list(arcs_host_iter(gm, **kw))
        np.testing.assert_array_equal(
            np.concatenate([s for s, _ in pairs]), src1)
        np.testing.assert_array_equal(
            np.concatenate([d for _, d in pairs]), dst1)
    # the JAX package's mmap graph holds the same arrays
    pytest.importorskip("jax")
    from repro.core.graph import from_edges_mmap as jmmap

    jg = jmmap(n, src, dst, dir=str(tmp_path / "jax"))
    for a, b in zip(gm.arrays, jg.arrays[:5]):
        np.testing.assert_array_equal(a, np.asarray(b))
    # and runs like the tensor graph, unpartitioned and partitioned
    want = base_raw(g)
    for c in (cfg("tiles"), cfg("tiles", partitions=4),
              cfg("search", partitions=4, partition_mode="serial")):
        np.testing.assert_array_equal(compile(gm, ALL_OPS, c).run_raw(gm),
                                      want)


# ----------------------------------------------------------------------------
# the arc flags of a shard-local CSR
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("wide", [False, True])
def test_shard_flags_equal_global_on_owned_and_partner_rows(wide):
    # a local CSR's flag of an arc between kept vertices is exact: w -> x
    # is looked up in the local out-keys, and the halo holds N(range ∪
    # partners) in full; arcs from a halo row to a vertex outside the
    # kept set may be wrong, but no owned dyad's census reads them
    g = port_graph(*_arcs(13, n=64, m=400))
    plan = compile(g, ("triad_census",), cfg("tiles", partitions=4))
    full = plan.padded_arrays(g)
    gflag, gcnt = build_arc_flags_device(full.out_ptr, full.out_idx,
                                         full.nbr_ptr, full.nbr_idx,
                                         wide=wide)
    gptr = g.host.nbr_ptr
    part = partition_graph(g, 4)
    geom = tpart._Geometry(plan, g, part)
    geom.wide = wide
    checked = 0
    for s in part.shards:
        local = tpart._shard_arrays(plan, g, s, geom)
        assert (local.nbr_cnt.dim() == 2) == wide
        lptr = local.nbr_ptr.numpy()
        u, v = shard_dyads(g, s.lo, s.hi)
        for x in np.union1d(np.arange(s.lo, s.hi), v):
            a, b = int(gptr[x]), int(gptr[x + 1])
            la, lb = int(lptr[x]), int(lptr[x + 1])
            assert lb - la == b - a
            np.testing.assert_array_equal(local.nbr_idx[la:lb],
                                          full.nbr_idx[a:b])
            np.testing.assert_array_equal(local.nbr_flag[la:lb],
                                          gflag[a:b])
            np.testing.assert_array_equal(local.nbr_cnt[..., la:lb],
                                          gcnt[..., a:b])
            checked += b - a
    assert checked >= g.m_nbr  # every row is some shard's owned row


# ----------------------------------------------------------------------------
# bit identity: partitions x schedule x backend x mode, one copy per run
# ----------------------------------------------------------------------------

BIT_ARCS = dict(seed=7, n=40, m=240)


@functools.lru_cache(maxsize=None)
def jax_partitioned_raw(backend, schedule, parts):
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    jg = jax_graph(*_arcs(**BIT_ARCS))
    raw = jcompile(jg, ALL_OPS, JConfig(backend=backend, schedule=schedule,
                                        partitions=parts, **SMALL)).run_raw(jg)
    jclear()
    return np.asarray(raw)


@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("schedule", ["static", "dynamic"])
def test_partitioned_bit_identity_every_op(backend, schedule):
    g = port_graph(*_arcs(**BIT_ARCS))
    want = brute_force_census(g).counts
    base = compile(g, ALL_OPS, cfg(backend)).run_raw(g)
    slots = dict(n_executor_devices=2) if schedule == "dynamic" else {}
    for parts in PARTS:
        modes = ("pool", "serial") if parts > 1 else (None,)
        for mode in modes:
            plan = compile(g, ALL_OPS, cfg(
                backend, schedule=schedule, partitions=parts,
                partition_mode=mode, **slots, **SMALL))
            s0 = plan.stats["host_syncs"]
            raw = plan.run_raw(g)
            assert plan.stats["host_syncs"] - s0 == 1, (parts, mode)
            np.testing.assert_array_equal(raw, base)
            for jbackend in ("xla", "pallas"):
                np.testing.assert_array_equal(
                    raw, jax_partitioned_raw(jbackend, schedule, parts))
            np.testing.assert_array_equal(
                plan.layout.finalize(raw, g)["triad_census"].counts, want)
            if parts > 1:
                ps = plan.stats["partition"]
                assert ps["partitions"] == parts and ps["mode"] == mode
                assert sum(ps["shard_dyads"]) == g.n_dyads
                assert len(ps["halo_sizes"]) == parts
                assert ps["h2d_puts"] == sum(1 for d in ps["shard_dyads"]
                                             if d)
                assert ps["d2d_puts"] == 0  # one device


def test_partitioned_empty_and_tiny_graphs():
    empty = port_graph(5, np.array([], int), np.array([], int))
    single = port_graph(4, np.array([0]), np.array([1]))
    for g in (empty, single):
        for backend in ("tiles", "search"):
            plan = compile(g, ALL_OPS, cfg(backend, partitions=8))
            np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))


def test_run_batch_partitioned_runs_memberwise():
    gs = [port_graph(*_arcs(s, n=32, m=160)) for s in range(3)]
    plan = compile(gs[0], ALL_OPS, cfg("tiles", partitions=2))
    s0 = plan.stats["host_syncs"]
    outs = plan.run_batch(gs)
    assert plan.stats["host_syncs"] - s0 == len(gs)  # one copy a member
    for g, out in zip(gs, outs):
        want = compile(g, ALL_OPS, cfg("search")).run(g)
        np.testing.assert_array_equal(out["triad_census"].counts,
                                      want["triad_census"].counts)
        np.testing.assert_equal(out["degree_stats"], want["degree_stats"])


# ----------------------------------------------------------------------------
# staging: pool assembly, one staging per shard, spill
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("cross_device", [False, True])
def test_pool_staging_assembles_exact_local_arrays(monkeypatch, cross_device):
    # the pool's device-assembled context (ptr staging, owned blocks, halo
    # blocks gathered from their owners) equals the host-built serial one;
    # with every slot taken for another device, each resident owner's
    # block takes the cross-device branch and counts one d2d_put
    if cross_device:
        monkeypatch.setattr(tpart, "same_device", lambda a, b: False)
    g = port_graph(*_arcs(45, n=64, m=400))
    for backend in ("tiles", "search"):
        plan = compile(g, ("triad_census",), cfg(backend, partitions=4))
        part = tpart.plan_partition(plan, g)
        geom = tpart._Geometry(plan, g, part)
        pstats = {"d2d_puts": 0}
        work = {}
        for shard in part.shards:
            if shard.n_dyads:
                u, v = shard_dyads(g, shard.lo, shard.hi)
                work[shard.index] = tpart._stage_pool_shard(
                    plan, g, shard, geom, u, v, plan.device)
        tpart._exchange_halos(plan, g, part, work, pstats)
        groups = sum(1 for s in work for o, _ in halo_by_owner(
            part.cuts, part.shards[s].halo) if o in work)
        assert pstats["d2d_puts"] == (groups if cross_device else 0)
        for s, w in work.items():
            arrays, su, sv = tpart._finish_pool_context(plan, w, geom)
            want = tpart._shard_arrays(plan, g, part.shards[s], geom)
            for f in ("out_ptr", "out_idx", "nbr_ptr", "nbr_idx", "nbr_deg",
                      "nbr_flag", "nbr_cnt"):
                a, b = getattr(arrays, f), getattr(want, f)
                if b is None:
                    assert a is None, (backend, f)
                else:
                    assert torch.equal(a, b), (backend, s, f)
            u, v = shard_dyads(g, part.shards[s].lo, part.shards[s].hi)
            np.testing.assert_array_equal(su.numpy(), u)
            np.testing.assert_array_equal(sv.numpy(), v)
        plan = compile(g, ("triad_census",), cfg(backend, partitions=4,
                                                 partition_mode="pool"))
        np.testing.assert_array_equal(plan.run_raw(g),
                                      base_raw(g, ("triad_census",)))
        assert plan.stats["partition"]["d2d_puts"] == (
            groups if cross_device else 0)


@pytest.mark.parametrize("mode", ["serial", "pool"])
def test_partition_staging_once_per_shard(mode):
    g = port_graph(*_arcs(39))
    for schedule, slots in (("static", None), ("dynamic", 3)):
        plan = compile(g, ("triad_census",), cfg(
            "tiles", partitions=4, chunk_dyads=16, batch=16,
            partition_mode=mode, schedule=schedule, n_executor_devices=slots))
        plan.run(g)
        ps = plan.stats["partition"]
        nonempty = [s for s, d in enumerate(ps["shard_dyads"]) if d]
        assert ps["h2d_puts"] == len(nonempty), (mode, schedule)
        assert set(ps["shard_times"]) == set(nonempty)
        for t in ps["shard_times"].values():
            assert t["end"] >= t["start"] and t["tasks"] >= 1
        assert 0.0 <= ps["shard_overlap"] <= 1.0
        if mode == "serial":
            assert ps["shard_overlap"] == 0.0
        assert (sum(plan.stats["device_chunks"].values())
                == plan.stats["chunks"])
        assert 0 < ps["max_shard_bytes"] <= tpart.full_context_bytes(plan, g)


def test_spill_completes_under_a_capped_staging_budget(tmp_path):
    # the per-shard staging peak stays under a cap that the whole stream
    # exceeds, and the scratch directory is removed after the run
    g = tgen.rmat(9, edge_factor=8, seed=2, device="cpu")
    gm = from_edges_mmap(g.n, *arcs_host(g), dir=str(tmp_path / "graph"))
    want = base_raw(g, ("triad_census",))
    scratch = tmp_path / "spill"
    for backend in ("tiles", "search"):
        plan = compile(gm, ("triad_census",), cfg(
            backend, partitions=8, spill=str(scratch), batch=32,
            chunk_dyads=32))
        assert plan.partition_mode == "serial"
        np.testing.assert_array_equal(plan.run_raw(gm), want)
        ps = plan.stats["partition"]
        assert ps["spill"] is True
        cap = ps["stream_bytes"] // 2
        assert ps["max_stage_bytes"] <= cap < ps["stream_bytes"], ps
        assert not os.listdir(scratch)
        spilled_pool = compile(gm, ("triad_census",), cfg(
            backend, partitions=8, spill=True, partition_mode="pool"))
        np.testing.assert_array_equal(spilled_pool.run_raw(gm), want)


# ----------------------------------------------------------------------------
# composition: deltas, faults, reordering
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["pool", "serial"])
def test_partition_delta_touches_only_owner_shards(mode):
    g = port_graph(*_arcs(13, n=64, m=380))
    plan = compile(g, ALL_OPS, cfg("tiles", partitions=8, partition_mode=mode,
                                   delta_threshold=1.0))
    raw = plan.run_raw(g)
    s0 = plan.stats["host_syncs"]
    res = plan.apply_delta(g, GraphDelta(edges_added=np.array([[1, 2]])),
                           raw)
    assert res.mode == "delta"
    assert plan.stats["host_syncs"] - s0 == 1
    touched = plan.stats["partition"]["delta_shards"]
    assert 1 <= touched < plan.partitions
    np.testing.assert_array_equal(res.raw, base_raw(res.graph))


@pytest.mark.parametrize("backend", ["tiles", "search"])
@pytest.mark.parametrize("mode", ["pool", "serial"])
def test_partition_delta_stream_matches_full(backend, mode):
    g = port_graph(*_arcs(17, n=40, m=220))
    plan = compile(g, ALL_OPS, cfg(backend, partitions=4, partition_mode=mode,
                                   delta_threshold=1.0))
    raw = plan.run_raw(g)
    rng = np.random.default_rng(5)
    for step in range(3):
        delta = GraphDelta(edges_added=rng.integers(0, g.n, (3, 2)),
                           edges_removed=rng.integers(0, g.n, (2, 2)))
        res = plan.apply_delta(g, delta, raw)
        g, raw = res.graph, res.raw
        np.testing.assert_array_equal(raw, base_raw(g))
    # the JAX package's partitioned delta stream lands on the same bins
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import compile as jcompile

    jg = jax_graph(*_arcs(17, n=40, m=220))
    jplan = jcompile(jg, ALL_OPS, JConfig(backend="xla", partitions=4,
                                          delta_threshold=1.0))
    jraw = jplan.run_raw(jg)
    rng = np.random.default_rng(5)
    for _ in range(3):
        delta = GraphDelta(edges_added=rng.integers(0, jg.n, (3, 2)),
                           edges_removed=rng.integers(0, jg.n, (2, 2)))
        from repro.core.delta import GraphDelta as JDelta

        jres = jplan.apply_delta(jg, JDelta(
            edges_added=delta.edges_added,
            edges_removed=delta.edges_removed), jraw)
        jg, jraw = jres.graph, jres.raw
    np.testing.assert_array_equal(raw, np.asarray(jraw))


@pytest.mark.parametrize("schedule", ["static", "dynamic"])
def test_partition_fault_recovery_bit_identical(schedule):
    g = port_graph(*_arcs(19))
    fp = FaultPlan(seed=7, chunk_failure_rate=0.3, fail_attempts=1)
    for mode in ("pool", "serial"):
        plan = compile(g, ALL_OPS, cfg(
            "tiles", partitions=4, partition_mode=mode, schedule=schedule,
            n_executor_devices=2 if schedule == "dynamic" else None,
            batch=32, chunk_dyads=32, fault_plan=fp))
        s0 = plan.stats["host_syncs"]
        np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))
        assert plan.stats["host_syncs"] - s0 == 1
        assert plan.stats["faults"]["retries"] > 0, (schedule, mode)


def test_partition_lost_pool_slot_rehomes_its_shards():
    g = port_graph(*_arcs(21, n=64, m=400))
    plan = compile(g, ALL_OPS, cfg(
        "tiles", partitions=8, schedule="dynamic", n_executor_devices=3,
        batch=16, chunk_dyads=16, fault_plan=FaultPlan(device_loss=(1,))))
    assert plan.partition_mode == "pool"
    np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))
    fs, ps = plan.stats["faults"], plan.stats["partition"]
    assert fs["device_losses"] == 1 and fs["quarantines"] == 1, fs
    assert ps["rehomes"] >= 1
    assert plan.stats["host_syncs"] == 1
    assert 1 not in plan.stats["device_chunks"]
    assert sum(plan.stats["device_chunks"].values()) == plan.stats["chunks"]
    # every slot lost: the whole run moves to the primary slot, in order
    plan = compile(g, ALL_OPS, cfg(
        "tiles", partitions=8, schedule="dynamic", n_executor_devices=2,
        batch=16, chunk_dyads=16, fault_plan=FaultPlan(device_loss=(0, 1))))
    np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))
    assert plan.stats["faults"]["schedule_fallbacks"] == 1


def test_partition_runtime_fault_demotes_whole_partitioned_run():
    g = port_graph(*_arcs(21))
    fp = FaultPlan(seed=3, runtime_failure=("tiles",))
    with pytest.raises(ChunkRetryError) as info:  # off by default: raises
        compile(g, ALL_OPS, cfg("tiles", partitions=4,
                                fault_plan=fp)).run_raw(g)
    assert "injected tiles runtime failure" in str(info.value.__cause__)
    plan = compile(g, ALL_OPS, cfg("tiles", partitions=4, fault_plan=fp,
                                   backend_fallback=True))
    np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))
    assert plan.backend == "search"
    assert plan.degradation[0]["rung"] == "tiles->search"
    assert plan.stats["partition"]["mode"] == "pool"


def test_partition_composes_with_reorder():
    g = port_graph(*_arcs(23))
    for reorder in ("degree", "bfs", "rcm"):
        plan = compile(g, ALL_OPS, cfg("tiles", partitions=4,
                                       reorder=reorder))
        np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))
        np.testing.assert_array_equal(plan.run_raw(g), base_raw(g))
        assert plan.stats["reorders"] == 1
        assert len(plan._partition_memo) == 1  # cuts over relabeled ids


# ----------------------------------------------------------------------------
# config validation, the locality guard, stats surfaces
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs, match", [
    (dict(partitions=0), "partitions must be an int >= 1"),
    (dict(partitions=2.5), "partitions must be an int >= 1"),
    (dict(partitions=True), "partitions must be an int >= 1"),
    (dict(spill=3), "spill must be None, a bool"),
    (dict(partition_mode="pool"), "requires partitions > 1"),
    (dict(partitions=1, partition_mode="serial"), "requires partitions > 1"),
    (dict(partitions=2, partition_mode="parallel"),
     "partition_mode must be one of"),
])
def test_partition_config_validation_messages(kwargs, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kwargs)
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig

    with pytest.raises(ValueError, match=match):
        JConfig(**kwargs)


@pytest.mark.parametrize("backend", ("tiles", "search"))
def test_partition_mesh_mode_is_refused_off_the_distributed_backend(backend):
    g = port_graph(*_arcs(33, n=16, m=40))
    with pytest.raises(ValueError, match="mesh.*requires the distributed"):
        compile(g, ("triad_census",), cfg(backend, partitions=2,
                                          partition_mode="mesh"))


def test_partition_mode_cache_key_normalization():
    g = port_graph(*_arcs(35, n=16, m=40))
    default = compile(g, ("triad_census",), cfg("tiles", partitions=2))
    explicit = compile(g, ("triad_census",), cfg("tiles", partitions=2,
                                                 partition_mode="pool"))
    assert default is explicit and default.partition_mode == "pool"
    serial = compile(g, ("triad_census",), cfg("tiles", partitions=2,
                                               partition_mode="serial"))
    assert serial is not default and serial.partition_mode == "serial"
    spilled = compile(g, ("triad_census",), cfg("tiles", partitions=2,
                                                spill=True))
    assert spilled.partition_mode == "serial"
    assert plan_cache_stats()["entries"][-1]["partition_mode"] == "serial"
    # inert spellings share one plan
    assert compile(g, ("triad_census",), cfg("tiles")) is compile(
        g, ("triad_census",), cfg("tiles", partitions=1, spill=False))
    # the JAX package normalizes the same way
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    jg = jax_graph(*_arcs(35, n=16, m=40))
    jd = jcompile(jg, ("triad_census",), JConfig(backend="xla", partitions=2))
    assert jd.partition_mode == default.partition_mode
    assert jd is jcompile(jg, ("triad_census",), JConfig(
        backend="xla", partitions=2, partition_mode="pool"))
    jclear()


def test_partition_rejects_nonlocal_ops():
    class NonLocal(GraphOp):
        name = "nonlocal_probe_torch"
        bins = 1
        kernel_key = "triad_census"
        delta_local = False

        def finalize(self, raw, g):
            return int(raw.sum())

    register_op(NonLocal(), overwrite=True)
    try:
        g = port_graph(*_arcs(29, n=16, m=40))
        with pytest.raises(ValueError, match="delta_local"):
            compile(g, ("nonlocal_probe_torch",), cfg("tiles", partitions=2))
        compile(g, ("nonlocal_probe_torch",), cfg("tiles", partitions=1))
    finally:
        unregister_op("nonlocal_probe_torch")


def test_partition_metadata_in_plan_cache_stats():
    g = port_graph(*_arcs(31))
    plan = compile(g, ("triad_census",), cfg("tiles", partitions=4))
    plan.run(g)
    plan.run(g)  # warm: the layout memo hits
    entry = plan_cache_stats()["entries"][-1]
    assert entry["partitions"] == 4 and entry["partition_memo"] == 1
    ps = entry["partition"]
    assert ps["mode"] == entry["partition_mode"] == "pool"
    assert sum(ps["shard_dyads"]) == g.n_dyads
    assert len(ps["halo_sizes"]) == 4
    for key in ("cuts", "spill", "h2d_puts", "d2d_puts", "max_shard_bytes",
                "max_stage_bytes", "stream_bytes", "shard_overlap",
                "shard_times"):
        assert key in ps, key
    compile(g, ("dyad_census",), cfg("tiles")).run(g)
    entry0 = plan_cache_stats()["entries"][-1]
    assert entry0["partitions"] == 1 and entry0["partition_mode"] is None
    assert "partition" not in entry0
    # the JAX package records the same keys
    pytest.importorskip("jax")
    from repro.engine import EngineConfig as JConfig
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    jg = jax_graph(*_arcs(31))
    jplan = jcompile(jg, ("triad_census",), JConfig(backend="xla",
                                                    partitions=4))
    jplan.run(jg)
    assert set(ps) == set(jplan.stats["partition"])
    assert ps["cuts"] == jplan.stats["partition"]["cuts"]
    assert ps["halo_sizes"] == jplan.stats["partition"]["halo_sizes"]
    jclear()


def test_partition_metadata_in_service_stats():
    svc = CensusService(ServiceConfig(
        max_batch=2, max_wait_requests=100,
        census=EngineConfig(backend="tiles", device="cpu", partitions=2)))
    fleet = [tgen.rmat(5, edge_factor=4, seed=s, device="cpu")
             for s in range(2)]
    for g in fleet:
        svc.submit(g)
    done = svc.flush()
    assert all(c.error is None for c in done)
    for c, g in zip(sorted(done, key=lambda c: c.request_id), fleet):
        np.testing.assert_array_equal(c.result.counts,
                                      brute_force_census(g).counts)
    bucket = next(iter(svc.stats()["buckets"].values()))
    assert bucket["partitions"] == 2
    assert sum(bucket["partition"]["shard_dyads"]) > 0


# ----------------------------------------------------------------------------
# on the card: Slashdot-sized partitioned runs against the unpartitioned one
# ----------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pool", "serial"])
def test_cuda_partitioned_slashdot_matches_unpartitioned(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census kernel has no CPU mode")
    from repro_torch.kernels.triad_census import census_csr

    g = tgen.paper_profile("slashdot", scale_down=1.0, seed=0, device="cuda")
    want = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device="cuda")).run_raw(g)
    plan = compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device="cuda", partitions=8, partition_mode=mode))
    census_csr.launches = 0
    np.testing.assert_array_equal(plan.run_raw(g), want)
    ps = plan.stats["partition"]
    assert census_csr.launches == plan.stats["chunks"] == sum(
        t["tasks"] for t in ps["shard_times"].values()) > 0
    assert ps["h2d_puts"] == sum(1 for d in ps["shard_dyads"] if d)
    assert ps["d2d_puts"] == 0 and plan.stats["host_syncs"] == 1
