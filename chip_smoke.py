#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never ``jax`` or
``repro``.  Every phase prints one JSON line; any mismatch raises, so the
script exits non-zero and prints no result.  Phases:

1. build   — compile ``census_tiles.cu`` with nvcc (sm_90a) from the
             checkout and load it; print the card and the ptxas report.
2. kernel  — on the Slashdot-sized R-MAT stand-in (the paper's Table 4.1
             network at its published size), replay every chunk the main
             path dispatches: the CUDA kernel against its plain torch
             version on the same tiles, bit-equal, each timed with CUDA
             events beside its memory bound; then the large-n tile case
             whose exact bin 012 is 134217760.
3. small   — ``compile(...).run(g)`` on R-MAT graphs of 64-256 vertices,
             both backends and several bucket sets, against the port's
             brute-force census.
4. full    — the main path, ``compile(g, ("triad_census",),
             EngineConfig(backend="tiles")).run_raw(g)``, cold then warm,
             bit-identical to ``backend="search"`` on the card, one
             device->host copy per run, one kernel launch per chunk;
             then one more warm run under torch.profiler: device time by
             kernel and the device's idle share.
5. the kernels line, then the result line.

Exits non-zero without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak memory rate
BIN012_LARGE_N = 134217760  # exact bin 012 of the large-n tile case


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def event_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def large_n_case(torch, device):
    """32 asymmetric dyads (2i -> 2i+1) in a graph of n = 2**22 + 3
    vertices; 16 of them, picked by a seeded permutation, have one extra
    neighbour in N(u) with no arc to u or v.  Every dyad then adds n - 2
    triads to bin 012 (the extra neighbour moves one from the dyadic term
    to a connected code of type 012), so bin 012 is 32 * (n - 2)."""
    import numpy as np

    from repro_torch.kernels.triad_census import SENTINEL

    n, D, K = 2**22 + 3, 32, 4
    u = np.arange(D, dtype=np.int32) * 2
    v = u + 1
    extra = np.random.default_rng(0).permutation([True] * 16 + [False] * 16)

    def tile(rows):
        t = np.full((D, K), SENTINEL, np.int32)
        for i, r in enumerate(rows):
            t[i, :len(r)] = sorted(r)
        return torch.as_tensor(t, device=device)

    nbr_u = [[v[i]] + ([n - 1 - i] if extra[i] else []) for i in range(D)]
    tiles = [tile([[v[i]] for i in range(D)]), tile([[]] * D),
             tile([[]] * D), tile([[u[i]] for i in range(D)]),
             tile(nbr_u), tile([[u[i]] for i in range(D)])]
    return (torch.as_tensor(u, device=device),
            torch.as_tensor(v, device=device), n, tiles)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    return run(torch.device("cuda"))


def run(dev) -> int:
    import numpy as np
    import torch

    from repro_torch.core import brute_force_census, generators
    from repro_torch.engine import EngineConfig, clear_plan_cache, compile
    from repro_torch.engine.backends import chunk_tile_inputs, tiles_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import census_tiles_ref
    from repro_torch.kernels.triad_census import SENTINEL, census_tiles

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build("census_tiles")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit("build", seconds=build_s, library=os.path.relpath(lib_path, ROOT),
         ptxas=ptxas, card=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. kernel against its plain version, every chunk of the main path ------
    t0 = time.perf_counter()
    g = generators.paper_profile("slashdot", scale_down=1.0, seed=0,
                                 device=dev)
    gen_s = time.perf_counter() - t0
    emit("graph", name="slashdot", n=g.n, arcs=g.m, dyads=g.n_dyads,
         max_deg=g.max_deg, seconds=gen_s)
    cfg = EngineConfig(backend="tiles", device=dev)
    plan = compile(g, ("triad_census",), cfg)
    st = tiles_stream(plan, g)
    per_bucket: dict = {}
    max_err = 0
    for task in st.tasks:
        u, v, tiles = chunk_tile_inputs(st.arrays, st.su, st.sv, task,
                                        st.chunk)
        got = census_tiles(u, v, g.n, *tiles, block=st.block)
        want = census_tiles_ref(*tiles, u, v, g.n, block=st.block)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"kernel != plain at K={task.key}, dyad "
                        f"{task.start}: max abs err {err}")
        max_err = max(max_err, err)
        k_ms = event_ms(torch, lambda: census_tiles(
            u, v, g.n, *tiles, block=st.block), reps=3)
        p_ms = event_ms(torch, lambda: census_tiles_ref(
            *tiles, u, v, g.n, block=st.block), reps=1)
        prefix = int(sum(int((t != SENTINEL).sum()) for t in tiles))
        nbytes = 4 * prefix + 8 * st.chunk + 64 * (st.chunk // st.block)
        b = per_bucket.setdefault(task.key, dict(
            K=task.key, chunks=0, dyads=0, kernel_ms=0.0, plain_ms=0.0,
            bytes=0))
        b["chunks"] += 1
        b["dyads"] += min(task.end, task.start + st.chunk) - task.start
        b["kernel_ms"] += k_ms
        b["plain_ms"] += p_ms
        b["bytes"] += nbytes
        del u, v, tiles, got, want
    for b in per_bucket.values():
        b["bound_ms"] = b["bytes"] / HBM_BYTES_PER_S * 1e3
        emit("kernel_bucket", **b)

    u, v, n_big, tiles = large_n_case(torch, dev)
    got = census_tiles(u, v, n_big, *tiles, block=32)
    want = census_tiles_ref(*tiles, u, v, n_big, block=32)
    check(torch.equal(got, want), "large-n case: kernel != plain version")
    bin012 = int(got.long().sum(0)[1])
    check(bin012 == BIN012_LARGE_N,
          f"large-n case: bin 012 = {bin012}, want {BIN012_LARGE_N}")
    emit("kernel_large_n", n=n_big, bin012=bin012, equal=True)

    # 3. small graphs against the brute-force census --------------------------
    n_small = 0
    for scale in (6, 7, 8):
        for seed in (0, 1):
            gs = generators.rmat(scale, edge_factor=4, seed=seed, device=dev)
            want = brute_force_census(gs).counts
            for backend in ("tiles", "search"):
                for buckets in ((32, 128, 512), (8, 32, 128)):
                    res = compile(gs, ("triad_census",), EngineConfig(
                        backend=backend, buckets=buckets, device=dev)).run(gs)
                    got = res["triad_census"].counts
                    check(np.array_equal(got, want),
                          f"rmat({scale}, seed={seed}) {backend} {buckets}: "
                          f"{got.tolist()} != {want.tolist()}")
                    n_small += 1
    emit("small_graphs", runs=n_small, equal=True)

    # 4. the main path at full width ------------------------------------------
    clear_plan_cache()
    torch.cuda.synchronize()
    census_tiles.launches = 0
    t0 = time.perf_counter()
    plan = compile(g, ("triad_census",), cfg)
    raw_cold = plan.run_raw(g)
    cold_s = time.perf_counter() - t0
    cold_launches = census_tiles.launches
    check(cold_launches == plan.stats["chunks"] > 0,
          f"cold run: {cold_launches} launches for "
          f"{plan.stats['chunks']} chunks")
    check(plan.stats["host_syncs"] == 1, f"cold run: {plan.stats}")

    torch.cuda.reset_peak_memory_stats()
    chunks0 = plan.stats["chunks"]
    census_tiles.launches = 0
    t0 = time.perf_counter()
    raw_warm = plan.run_raw(g)
    warm_s = time.perf_counter() - t0
    launches = census_tiles.launches
    chunks = plan.stats["chunks"] - chunks0
    peak = torch.cuda.max_memory_allocated()
    check(launches == chunks == len(st.tasks) > 0,
          f"warm run: {launches} launches, {chunks} chunks, "
          f"{len(st.tasks)} tasks")
    check(plan.stats["host_syncs"] == 2, f"warm run: {plan.stats}")

    splan = compile(g, ("triad_census",),
                    EngineConfig(backend="search", device=dev))
    t0 = time.perf_counter()
    raw_search = splan.run_raw(g)
    search_s = time.perf_counter() - t0
    check(splan.stats["host_syncs"] == 1, f"search run: {splan.stats}")
    check(np.array_equal(raw_cold, raw_warm), "cold != warm")
    check(np.array_equal(raw_warm, raw_search),
          f"tiles {raw_warm.tolist()} != search {raw_search.tolist()}")
    result = plan.layout.finalize(raw_warm, g)["triad_census"]
    check(result.total == g.n * (g.n - 1) * (g.n - 2) // 6
          and (result.counts >= 0).all(), "census does not sum to C(n, 3)")
    emit("full", graph="slashdot", backend="tiles", cold_s=cold_s,
         warm_s=warm_s, warm_dyads_per_s=g.n_dyads / warm_s,
         launches=launches, chunks=chunks, host_syncs_per_run=1,
         tile_bytes_per_run=sum(24 * st.chunk * t.key for t in st.tasks),
         max_memory_allocated=peak, search_s=search_s,
         bit_identical_to_search=True, counts=result.counts.tolist())

    # where the warm run's device time goes (kernels by name, idle share)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        raw_prof = plan.run_raw(g)
        prof_s = time.perf_counter() - t0
    check(np.array_equal(raw_prof, raw_warm), "profiled run != warm run")
    on_card = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy_ms = sum(ms for ms, _, _ in on_card)
    emit("profile", wall_ms=prof_s * 1e3, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / (prof_s * 1e3),
         top=[dict(ms=ms, count=c, kernel=k[:100])
              for ms, c, k in on_card[:12]])

    # 5. kernels line, result line --------------------------------------------
    print(json.dumps({"kernels": [dict(
        name="census_tiles", route="cuda",
        source="src/repro_torch/kernels/csrc/census_tiles.cu",
        replaces="src/repro/kernels/triad_census.py:36",
        launches=launches, max_abs_err=max_err,
        ms=sum(b["kernel_ms"] for b in per_bucket.values()),
        plain_ms=sum(b["plain_ms"] for b in per_bucket.values()),
        bound_ms=sum(b["bound_ms"] for b in per_bucket.values()),
        bound_by="bytes", library_ms=None)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
