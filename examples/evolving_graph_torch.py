"""Evolving-graph serving through the PyTorch port: mutate a live graph,
keep the census current (the twin of ``examples/evolving_graph.py``).

Subscribe a graph once, stream arc mutations at it, and every ``poll``
returns the exact census of the current snapshot.  Each small mutation
pays two subset passes over the dyads whose neighbourhoods the edit
touched (one device-to-host copy), not a full recompute:

    PYTHONPATH=src python examples/evolving_graph_torch.py [--backend tiles]

``--backend`` takes the port's names or JAX's (``xla`` -> ``search``,
``pallas`` -> ``tiles``); ``--device`` defaults to ``cuda``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import GraphDelta, brute_force_census, generators
from repro_torch.engine import EngineConfig, compile
from repro_torch.serve import CensusService, ServiceConfig

BACKENDS = {"xla": "search", "pallas": "tiles"}


def random_delta(g, rng, k=4):
    """k random arc insertions + k deletions of existing arcs."""
    out_ptr = np.asarray(g.host.out_ptr)[: g.n + 1]
    dst = np.asarray(g.host.out_idx)[: g.m].astype(np.int64)
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(out_ptr))
    sel = rng.choice(g.m, size=min(k, g.m), replace=False)
    return GraphDelta(edges_added=rng.integers(0, g.n, size=(k, 2)),
                      edges_removed=np.stack([src[sel], dst[sel]], 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "pallas", "search", "tiles",
                             "distributed", "auto"])
    ap.add_argument("--scale", type=int, default=10,
                    help="R-MAT scale (2**scale vertices)")
    ap.add_argument("--mutations", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = generators.rmat(args.scale, edge_factor=8, seed=0, device=dev)
    cfg = EngineConfig(backend=BACKENDS.get(args.backend, args.backend),
                       device=dev)
    print(f"graph: n={g.n} arcs={g.m} dyads={g.n_dyads}")

    # plan-level API: apply_delta folds an exact integer correction
    plan = compile(g, ("triad_census",), cfg)
    raw = plan.run_raw(g)
    rng = np.random.default_rng(0)
    d = random_delta(g, rng)
    res = plan.apply_delta(g, d, raw)
    g2 = res.graph
    t0 = time.perf_counter()
    plan.apply_delta(g, d, raw)
    dt_delta = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = plan.run_raw(g2)
    dt_full = time.perf_counter() - t0
    assert np.array_equal(res.raw, full)  # bit-identical, always
    print(f"\n{d.size}-arc delta touches "
          f"{res.affected_fraction:.2%} of all dyads: "
          f"apply_delta {dt_delta * 1e3:.1f} ms vs full recompute "
          f"{dt_full * 1e3:.1f} ms "
          f"({dt_full / max(dt_delta, 1e-9):.1f}x), mode={res.mode}")

    # service-level API: a subscribed session owns graph + plan + raw bins
    svc = CensusService(ServiceConfig(census=cfg))
    sid = svc.subscribe(g)
    t0 = time.perf_counter()
    for _ in range(args.mutations):
        ack = svc.mutate(sid, random_delta(svc._sessions[sid].graph, rng))
    dt = time.perf_counter() - t0
    print(f"\nsession {sid}: {args.mutations} mutations in "
          f"{dt * 1e3:.1f} ms "
          f"({args.mutations / max(dt, 1e-9):.1f} mutations/sec), "
          f"last ack mode={ack['mode']} n_arcs={ack['m']}")
    census = svc.poll(sid)
    live = svc._sessions[sid].graph
    print(f"current census: {census.counts.tolist()} "
          f"(total={int(census.counts.sum()):,})")
    stats = svc.stats()["sessions"][sid]
    print(f"session stats: {stats}")
    final = svc.unsubscribe(sid)
    assert np.array_equal(final.counts, census.counts)

    if g.n <= 256:  # oracle check, small graphs only
        g_small = generators.rmat(6, edge_factor=4, seed=1, device=dev)
        s2 = svc.subscribe(g_small)
        svc.mutate(s2, random_delta(g_small, rng))
        small = svc._sessions[s2].graph
        assert np.array_equal(svc.poll(s2).counts,
                              brute_force_census(small).counts)
        svc.unsubscribe(s2)
    print("\npoll == exact census of the live snapshot, every time")
    return {"graph": live, "census": census}


if __name__ == "__main__":
    main()
