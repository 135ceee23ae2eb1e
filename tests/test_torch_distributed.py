"""The port's distributed backend against the JAX package's: ranks are
``gloo`` processes on the CPU (``torch.multiprocessing.spawn``, a
``file://`` store), W in {1, 2, 4} on 1-D meshes and a (2, 2) mesh, one
spawn per world size running every case and writing each rank's results
for the tests below to read.

Held with tolerance 0: ``run_raw`` with the four built-in ops against the
JAX ``"distributed"`` backend (its one-device mesh, in process), JAX
``"xla"`` and the brute-force census; the packing's load summary against
JAX ``balance.pack_tasks``; the ``"mesh"`` and ``"serial"`` partitioned
runs against JAX's partitioned distributed runs and the unpartitioned
bins; deltas against the full recompute and JAX ``apply_delta``; a
``CensusService(mesh=...)`` fleet against single runs.  Counted: one merge
(one all-reduce per mesh dimension) and one host copy per run, batch and
delta on every rank; the once contributions folded once; an injected
chunk fault on one rank retried to exact bins; a rank-local unrecoverable
failure raising on every rank within the group timeout.  Then the config
rules, the legacy ``core`` names and two CUDA cases (skipped without a
card): W = 1 under ``nccl``, W = 2 under ``gloo`` sharing one card.

The JAX package is imported only inside the tests that compare with it,
so the CUDA cases run on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_distributed.py``.
"""
import datetime
import os
import pickle
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import balance, brute_force_census
from repro_torch.core import generators as tgen
from repro_torch.core.delta import GraphDelta
from repro_torch.core.distributed import (LocalMesh, RemoteRankError,
                                          make_distributed_census_fn,
                                          merge_over_mesh)
from repro_torch.core.graph import arcs_host
from repro_torch.engine import (ChunkRetryError, EngineConfig, FaultPlan,
                                clear_plan_cache, compile, plan_cache_stats)
from repro_torch.engine.backends import rank_share
from repro_torch.serve import CensusService, ServiceConfig

ALL_OPS = ("triad_census", "dyad_census", "degree_stats", "triadic_profile")
SMALL = dict(batch=32, chunk_dyads=64, buckets=(4, 16, 64))
SEEDS = (0, 1, 2)  # R-MAT scale 6: one metadata bucket
PARTS = (2, 4, 8)
MODES = ("mesh", "serial")
STRATEGIES = ("greedy_sequential", "sorted_snake", "greedy_lpt")
MESHES = ("w1", "w2", "w4", "m2x2")
TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _graph(seed):
    return tgen.rmat(6, edge_factor=4, seed=seed, device="cpu")


def _delta(g):
    rng = np.random.default_rng(11)
    src, dst = arcs_host(g)
    drop = rng.choice(len(src), 6, replace=False)
    return GraphDelta(edges_added=rng.integers(0, g.n, size=(6, 2)),
                      edges_removed=np.stack([src[drop], dst[drop]], 1))


def _cfg(**kw):
    return EngineConfig(**{**dict(backend="distributed", device="cpu",
                                  **SMALL), **kw})


def _counted(plan, fn):
    """``fn()`` with the merges and host copies it cost on this rank."""
    c0, s0 = merge_over_mesh.collectives, plan.stats["host_syncs"]
    out = fn()
    return out, dict(collectives=merge_over_mesh.collectives - c0,
                     syncs=plan.stats["host_syncs"] - s0)


# ----------------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------------

def _mesh_cases(mesh) -> dict:
    out = {}
    graphs = {s: _graph(s) for s in SEEDS}
    for s, g in graphs.items():
        plan = compile(g, ALL_OPS, _cfg(), mesh=mesh)
        chunks = plan.stats["chunks"]
        out[("raw", s)], out[("raw_cost", s)] = _counted(
            plan, lambda: plan.run_raw(g))
        out[("tasks", s)] = len(rank_share(plan, g)[2])
        out[("chunks", s)] = plan.stats["chunks"] - chunks
        once = compile(g, ("degree_stats",), _cfg(), mesh=mesh)
        out[("once", s)] = once.run_raw(g)
    g = graphs[0]
    plan = compile(g, ALL_OPS, _cfg(), mesh=mesh)
    batch, out["batch_cost"] = _counted(
        plan, lambda: plan.run_batch(list(graphs.values())))
    out["batch"] = [r["triad_census"].counts for r in batch]
    for strategy in STRATEGIES:
        sp = compile(g, ("triad_census",), _cfg(strategy=strategy),
                     mesh=mesh)
        out[("strategy_raw", strategy)] = sp.run_raw(g)
        ts = sp.last_task_stats
        out[("task_stats", strategy)] = dict(
            weights=ts.weights, shape=ts.shape, strategy=ts.strategy,
            imbalance=ts.imbalance)
    for P in PARTS:
        for mode in MODES:
            pp = compile(g, ALL_OPS, _cfg(partitions=P, partition_mode=mode),
                         mesh=mesh)
            out[("part", P, mode)], out[("part_cost", P, mode)] = _counted(
                pp, lambda: pp.run_raw(g))
            out[("part_times", P, mode)] = {
                k: t["device"] for k, t in
                pp.stats["partition"]["shard_times"].items()}
    delta = _delta(g)
    for label, kw in (("plain", {}),
                      ("mesh", dict(partitions=4, partition_mode="mesh")),
                      ("serial", dict(partitions=4,
                                      partition_mode="serial"))):
        dp = compile(g, ALL_OPS, _cfg(delta_threshold=1.0, **kw), mesh=mesh)
        raw = dp.run_raw(g)
        res, out[("delta_cost", label)] = _counted(
            dp, lambda: dp.apply_delta(g, delta, raw))
        out[("delta", label)] = dict(mode=res.mode, raw=res.raw,
                                     full=dp.run_raw(res.graph))
    return out


def _w2_cases(mesh, rank) -> dict:
    out = {}
    graphs = [_graph(s) for s in SEEDS]
    svc = CensusService(ServiceConfig(max_batch=2, max_wait_requests=100,
                                      census=_cfg()), mesh=mesh)
    plan = compile(graphs[0], ("triad_census",), _cfg(), mesh=mesh)
    fleet, cost = _counted(plan, lambda: svc.run_fleet(graphs))
    out["fleet"] = [r.counts for r in fleet]
    out["fleet_cost"] = cost
    out["single"] = [plan.run(g)["triad_census"].counts for g in graphs]
    out["fleet_batches"] = svc.stats()["batches"]
    g = graphs[0]
    faulty = FaultPlan(seed=3, chunk_failure_rate=1.0, fail_attempts=1)
    plan = compile(g, ALL_OPS, _cfg(
        max_attempts=3, fault_plan=faulty if rank == 1 else FaultPlan()),
        mesh=mesh)
    out["retry_raw"] = plan.run_raw(g)
    out["retry_faults"] = dict(plan.stats["faults"])
    out["retry_tasks"] = len(rank_share(plan, g)[2])
    fatal = FaultPlan(seed=3, chunk_failure_rate=1.0, fail_attempts=9)
    plan = compile(g, ALL_OPS, _cfg(
        max_attempts=2, fault_plan=fatal if rank == 1 else FaultPlan()),
        mesh=mesh)
    t0 = time.perf_counter()
    try:
        plan.run_raw(g)
        out["fatal"] = None
    except Exception as e:  # what each rank raised, and how fast
        out["fatal"] = type(e).__name__
    out["fatal_s"] = time.perf_counter() - t0
    # the group outlives the failure: a clean run on every rank after it
    out["after_fatal"] = compile(g, ALL_OPS, _cfg(), mesh=mesh).run_raw(g)
    # the legacy builder: this rank's row of a W = 2 packing, merged
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fn = make_distributed_census_fn(g, mesh, batch=32)
    t = balance.pack_tasks(g, 2, pad_multiple=32)
    c0 = merge_over_mesh.collectives
    out["legacy"] = fn(g.arrays, g.n, t.u, t.v, t.valid)
    out["legacy_collectives"] = merge_over_mesh.collectives - c0
    out["legacy_row"] = int(t.valid[rank].sum())
    return out


def _rank_main(rank, world, init_file, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        meshes = {f"w{world}": init_device_mesh("cpu", (world,))}
        if world == 4:
            meshes["m2x2"] = init_device_mesh("cpu", (2, 2))
        out = {label: _mesh_cases(mesh) for label, mesh in meshes.items()}
        if world == 2:
            out["w2"].update(_w2_cases(meshes["w2"], rank))
        # the default mesh of a distributed plan in a process group
        plan = compile(_graph(0), ("triad_census",), _cfg())
        out["default_mesh"] = (tuple(plan.mesh.shape),
                               plan.mesh.get_group(0) is dist.group.WORLD)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp, *args) -> list:
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    mp.spawn(fn, args=(world, os.path.join(tmp, "pg"), tmp, *args),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{mesh label: [rank 0's results, rank 1's, ...]}`` plus each
    world's default-mesh record, from one spawn per world size."""
    out = {}
    for world in (1, 2, 4):
        res = _spawn(_rank_main, world,
                     str(tmp_path_factory.mktemp(f"w{world}")))
        for label in {k for r in res for k in r if k != "default_mesh"}:
            out[label] = [r[label] for r in res]
        out[("default_mesh", world)] = [r["default_mesh"] for r in res]
    return out


def _world(label):
    return {"w1": 1, "w2": 2, "w4": 4, "m2x2": 4}[label]


def _mesh_dims(label):
    return 2 if label == "m2x2" else 1


# ----------------------------------------------------------------------------
# references: the JAX package in process, the port on one device
# ----------------------------------------------------------------------------

def _jax_graph(g):
    pytest.importorskip("jax")
    from repro.core.graph import from_edges as jfrom_edges

    return jfrom_edges(g.n, *arcs_host(g))


def _jcfg(**kw):
    from repro.engine import EngineConfig as JConfig

    return JConfig(**{**SMALL, **kw})


@pytest.fixture(scope="module")
def jax_refs():
    pytest.importorskip("jax")
    from repro.engine import clear_plan_cache as jclear
    from repro.engine import compile as jcompile

    jclear()
    refs = {}
    for s in SEEDS:
        jg = _jax_graph(_graph(s))
        for backend in ("distributed", "xla"):
            refs[(backend, s)] = np.asarray(jcompile(
                jg, ALL_OPS, _jcfg(backend=backend)).run_raw(jg))
    g = _graph(0)
    jg = _jax_graph(g)
    for P in PARTS:
        for mode in MODES:
            refs[("part", P, mode)] = np.asarray(jcompile(
                jg, ALL_OPS, _jcfg(backend="distributed", partitions=P,
                                   partition_mode=mode)).run_raw(jg))
    from repro.core.delta import GraphDelta as JDelta

    d = _delta(g)
    jd = JDelta(edges_added=d.edges_added, edges_removed=d.edges_removed)
    jplan = jcompile(jg, ALL_OPS, _jcfg(backend="distributed",
                                        delta_threshold=1.0))
    refs["delta"] = np.asarray(jplan.apply_delta(
        jg, jd, jplan.run_raw(jg)).raw)
    jclear()
    return refs


def _tiles_raw(g, ops=ALL_OPS):
    return compile(g, ops, EngineConfig(backend="tiles", device="cpu",
                                        **SMALL)).run_raw(g)


# ----------------------------------------------------------------------------
# runs, packing, partitions, deltas, the service
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("label", MESHES)
def test_run_raw_matches_jax_and_brute_force(ranks, jax_refs, label, seed):
    g = _graph(seed)
    want = jax_refs[("distributed", seed)]
    assert np.array_equal(want, jax_refs[("xla", seed)])
    for r, res in enumerate(ranks[label]):
        assert np.array_equal(res[("raw", seed)], want), (label, r)
    census = compile(g, ALL_OPS, _cfg()).layout.finalize(
        ranks[label][0][("raw", seed)], g)["triad_census"].counts
    assert np.array_equal(census, brute_force_census(g).counts)
    # the ranks' task rows partition the dyads, each chunk one dispatch
    tasks = [res[("tasks", seed)] for res in ranks[label]]
    assert [res[("chunks", seed)] for res in ranks[label]] == tasks


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("label", ("w2", "w4"))
def test_task_stats_match_jax_pack_tasks(ranks, label, strategy):
    pytest.importorskip("jax")
    from repro.core import balance as jbalance

    g = _graph(0)
    W = _world(label)
    want = jbalance.pack_tasks(_jax_graph(g), W, strategy=strategy,
                               weight_model="canonical_uniform",
                               pad_multiple=SMALL["batch"])
    for res in ranks[label]:
        ts = res[("task_stats", strategy)]
        assert ts["strategy"] == strategy
        assert ts["shape"] == tuple(want.u.shape)
        assert np.array_equal(ts["weights"], np.asarray(want.weights))
        assert ts["imbalance"] == pytest.approx(want.imbalance, abs=0)
        assert np.array_equal(res[("strategy_raw", strategy)],
                              _tiles_raw(g, ("triad_census",)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("label", ("w2", "w4"))
def test_partitioned_runs_match_jax_and_unpartitioned(ranks, jax_refs,
                                                      label, P, mode):
    want = jax_refs[("part", P, mode)]
    assert np.array_equal(want, jax_refs[("distributed", 0)])
    W = _world(label)
    seen = {}
    for r, res in enumerate(ranks[label]):
        assert np.array_equal(res[("part", P, mode)], want), (r, P, mode)
        assert res[("part_cost", P, mode)] == dict(collectives=1, syncs=1)
        assert set(res[("part_times", P, mode)].values()) <= {r}
        seen.update(res[("part_times", P, mode)])
    if mode == "mesh":
        # every non-empty shard ran on exactly one rank, dealt r::W
        shards = sorted(seen)
        assert sum(len(res[("part_times", P, mode)])
                   for res in ranks[label]) == len(shards)
        for i, s in enumerate(shards):
            assert seen[s] == i % W


@pytest.mark.parametrize("kind", ("plain", "mesh", "serial"))
@pytest.mark.parametrize("label", ("w2", "m2x2"))
def test_delta_matches_full_recompute_and_jax(ranks, jax_refs, label, kind):
    for res in ranks[label]:
        d = res[("delta", kind)]
        assert d["mode"] == "delta"
        assert np.array_equal(d["raw"], d["full"])
        assert np.array_equal(d["raw"], jax_refs["delta"])


def test_service_fleet_on_a_mesh_equals_single_runs(ranks):
    want = [brute_force_census(_graph(s)).counts for s in SEEDS]
    for res in ranks["w2"]:
        for got in (res["fleet"], res["single"]):
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert all(np.array_equal(a, b)
                   for a, b in zip(res["fleet"], res["single"]))
        # a full batch of 2 and the flushed batch of 1: one merge and
        # one copy each
        assert res["fleet_batches"] == 2
        assert res["fleet_cost"] == dict(collectives=2, syncs=2)


# ----------------------------------------------------------------------------
# the merge: one per run, batch and delta; once contributions; failures
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("label", MESHES)
def test_one_merge_and_one_copy_per_run_batch_and_delta(ranks, label):
    one = dict(collectives=_mesh_dims(label), syncs=1)
    for res in ranks[label]:
        for s in SEEDS:
            assert res[("raw_cost", s)] == one
        assert res["batch_cost"] == one
        for kind in ("plain", "mesh", "serial"):
            assert res[("delta_cost", kind)] == one
        want = [brute_force_census(_graph(s)).counts for s in SEEDS]
        assert all(np.array_equal(a, b) for a, b in zip(res["batch"], want))


@pytest.mark.parametrize("label", MESHES)
def test_once_contributions_are_counted_once(ranks, label):
    for s in SEEDS:
        want = _tiles_raw(_graph(s), ("degree_stats",))
        for res in ranks[label]:
            assert np.array_equal(res[("once", s)], want)


def test_default_mesh_is_the_world_or_one_local_rank(ranks):
    for world in (1, 2, 4):
        assert ranks[("default_mesh", world)] == [((world,), True)] * world
    plan = compile(_graph(0), ("triad_census",), _cfg())
    assert plan.mesh == LocalMesh("cpu")
    assert plan_cache_stats()["entries"][-1]["mesh"] == (1,)


def test_chunk_fault_on_one_rank_is_retried_to_exact_bins(ranks):
    want = ranks["w2"][0][("raw", 0)]
    r0, r1 = ranks["w2"]
    for res in (r0, r1):
        assert np.array_equal(res["retry_raw"], want)
    assert r0["retry_faults"]["retries"] == 0
    assert r1["retry_faults"]["retries"] == r1["retry_tasks"] > 0
    assert r1["retry_faults"]["chunk_failures"] == r1["retry_tasks"]


def test_rank_local_failure_raises_on_every_rank_in_time(ranks):
    r0, r1 = ranks["w2"]
    assert r1["fatal"] == ChunkRetryError.__name__
    assert r0["fatal"] == RemoteRankError.__name__
    assert max(r0["fatal_s"], r1["fatal_s"]) < TIMEOUT_S / 4
    for res in (r0, r1):
        assert np.array_equal(res["after_fatal"], r0[("raw", 0)])


# ----------------------------------------------------------------------------
# config rules and the legacy core names
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ("tiles", "search"))
def test_mesh_mode_is_refused_off_the_distributed_backend(backend):
    with pytest.raises(ValueError, match="mesh.*requires the distributed"):
        compile(_graph(0), ("triad_census",),
                EngineConfig(backend=backend, device="cpu", partitions=2,
                             partition_mode="mesh"))


def test_pool_mode_is_refused_on_the_distributed_backend():
    with pytest.raises(ValueError, match="pool.*not available"):
        compile(_graph(0), ("triad_census",),
                _cfg(partitions=2, partition_mode="pool"))


def test_distributed_config_resolution():
    cfg = _cfg(partitions=2, schedule="dynamic", n_executor_devices=4)
    assert cfg.resolve_partition_mode() == "mesh"
    assert cfg.resolve_executor_devices() == 1
    assert _cfg(partitions=2, spill=True).resolve_partition_mode() == "serial"
    plan = compile(_graph(0), ("triad_census",), cfg)
    assert plan.partition_mode == "mesh" and plan.executor.n_devices == 1
    assert compile(_graph(0), ("triad_census",),
                   _cfg(partitions=2, partition_mode="mesh",
                        schedule="dynamic", n_executor_devices=1)) is plan
    with pytest.raises(ValueError, match="strategy must be one of"):
        _cfg(strategy="round_robin")
    with pytest.raises(ValueError, match="needs a mesh"):
        from repro_torch.engine.plan import GraphMeta, Plan
        Plan(GraphMeta.from_graph(_graph(0)), (), _cfg(), "distributed",
             torch.device("cpu"))


def test_mesh_is_part_of_the_cache_key():
    g = _graph(0)
    a = compile(g, ("triad_census",), _cfg(), mesh=LocalMesh("cpu"))
    assert compile(g, ("triad_census",), _cfg()) is a
    b = compile(g, ("triad_census",), _cfg(), mesh=LocalMesh("cuda"))
    assert b is not a and b.mesh == LocalMesh("cuda")
    # other backends ignore the mesh
    t = compile(g, ("triad_census",), EngineConfig(backend="tiles",
                                                   device="cpu"))
    assert compile(g, ("triad_census",), EngineConfig(
        backend="tiles", device="cpu"), mesh=LocalMesh("cpu")) is t
    assert t.mesh is None


def test_distributed_compile_failure_has_no_rung():
    from repro_torch.engine import InjectedFault

    with pytest.raises(InjectedFault, match="distributed compile failure"):
        compile(_graph(0), ("triad_census",), _cfg(
            backend_fallback=True,
            fault_plan=FaultPlan(compile_failure=("distributed",))))


def test_core_all_equals_the_jax_package_less_stack_graph_arrays():
    pytest.importorskip("jax")
    import repro.core as jcore

    import repro_torch.core as tcore

    assert sorted(tcore.__all__) == sorted(
        set(jcore.__all__) - {"stack_graph_arrays"})
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None


def _legacy_counts(name, g):
    import repro_torch.core as tcore
    from repro_torch.core.census import canonical_dyads, pad_dyads

    with pytest.warns(DeprecationWarning):
        if name == "triad_census":
            return tcore.triad_census(g, batch=32).counts
        if name == "distributed_triad_census":
            res, ts = tcore.distributed_triad_census(g, batch=32)
            assert ts.shape[0] == 1
            return res.counts
        if name == "make_census_fn":
            fn = tcore.make_census_fn(g, batch=32)
            u, v, valid = pad_dyads(*canonical_dyads(g), 32)
            parts = fn(g.arrays, g.n, u, v, valid)
        else:
            fn = tcore.make_distributed_census_fn(g, LocalMesh("cpu"),
                                                  batch=32)
            t = balance.pack_tasks(g, 1, pad_multiple=32)
            parts = fn(g.arrays, g.n, t.u, t.v, t.valid)
    return np.asarray(parts).reshape(-1, 16).sum(0)


@pytest.mark.parametrize("name", ("triad_census", "make_census_fn",
                                  "distributed_triad_census",
                                  "make_distributed_census_fn"))
def test_legacy_core_shims_match_jax(name):
    pytest.importorskip("jax")
    import repro.core as jcore
    from repro.core import balance as jbalance
    from repro.core.census import canonical_dyads as jcanon
    from repro.core.census import pad_dyads as jpad

    g = _graph(1)
    jg = _jax_graph(g)
    got = _legacy_counts(name, g)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if name == "triad_census":
            want = jcore.triad_census(jg, batch=32).counts
        elif name == "distributed_triad_census":
            want = jcore.distributed_triad_census(
                jg, _jax_default_mesh(), batch=32)[0].counts
        elif name == "make_census_fn":
            u, v, valid = jpad(*jcanon(jg), 32)
            want = np.asarray(jcore.make_census_fn(jg, batch=32)(
                jg.arrays, jg.n, u, v, valid), np.int64).sum(0)
        else:
            t = jbalance.pack_tasks(jg, 1, pad_multiple=32)
            want = np.asarray(jcore.make_distributed_census_fn(
                jg, _jax_default_mesh(), batch=32)(
                    jg.arrays, jg.n, t.u, t.v, t.valid), np.int64)
    assert np.array_equal(np.asarray(got, np.int64),
                          np.asarray(want, np.int64))


def test_legacy_distributed_builder_merges_over_two_ranks(ranks):
    pytest.importorskip("jax")
    import repro.core as jcore
    from repro.core import balance as jbalance

    jg = _jax_graph(_graph(0))
    t = jbalance.pack_tasks(jg, 1, pad_multiple=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(jcore.make_distributed_census_fn(
            jg, _jax_default_mesh(), batch=32)(
                jg.arrays, jg.n, t.u, t.v, t.valid), np.int64)
    for r, res in enumerate(ranks["w2"]):
        assert np.array_equal(res["legacy"], want), r
        assert res["legacy_collectives"] == 1
        assert res["legacy_row"] > 0


def _jax_default_mesh():
    import jax

    return jax.make_mesh((1,), ("data",))


# ----------------------------------------------------------------------------
# on the card (skipped without one)
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cuda_rank_main(rank, world, init_file, out_dir, backend):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.triad_census import census_csr

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", (world,))
        g = tgen.rmat(10, edge_factor=8, seed=0, device="cuda")
        tiles = compile(g, ALL_OPS, EngineConfig(backend="tiles")).run_raw(g)
        plan = compile(g, ALL_OPS, EngineConfig(backend="distributed"),
                       mesh=mesh)
        plan.run_raw(g)
        census_csr.launches = 0
        raw, cost = _counted(plan, lambda: plan.run_raw(g))
        out = dict(equal=bool(np.array_equal(raw, tiles)), cost=cost,
                   launches=census_csr.launches,
                   tasks=len(rank_share(plan, g)[2]))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", (("nccl", 1), ("gloo", 2)))
def test_cuda_ranks_run_census_csr(cuda, tmp_path, backend, world):
    res = _spawn(_cuda_rank_main, world, str(tmp_path), backend)
    for r in res:
        assert r["equal"]
        assert r["cost"] == dict(collectives=1, syncs=1)
        assert r["launches"] == r["tasks"] > 0
