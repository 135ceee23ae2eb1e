"""Fused multi-analytic pass through the PyTorch port: one traversal,
four results (the twin of ``examples/multi_analytic.py``).

The whole triadic-analysis family (triad census, MAN dyad census, degree
statistics, transitivity profile) from ONE pass over the dyad stream,
with one device-to-host copy, what a census-only run costs:

    PYTHONPATH=src python examples/multi_analytic_torch.py [--backend tiles]

``--backend`` takes the port's names (``search``, ``tiles``) or JAX's
(``xla`` -> ``search``, ``pallas`` -> ``tiles``); ``--device`` defaults to
``cuda``.
"""
import argparse
import time

import torch

from repro_torch.core import generators
from repro_torch.core.triad_table import TRIAD_NAMES
from repro_torch.engine import EngineConfig, compile, list_ops

OPS = ["triad_census", "dyad_census", "degree_stats", "triadic_profile"]
#: JAX's backend names -> the port's
BACKENDS = {"xla": "search", "pallas": "tiles"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "pallas", "search", "tiles",
                             "distributed", "auto"])
    ap.add_argument("--scale", type=int, default=10,
                    help="R-MAT scale (2**scale vertices)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = generators.rmat(args.scale, edge_factor=8, seed=0, device=dev)
    print(f"graph: n={g.n} arcs={g.m} dyads={g.n_dyads}; "
          f"registered ops: {list_ops()}")

    # the two-line multi-op call
    cfg = EngineConfig(backend=BACKENDS.get(args.backend, args.backend),
                       device=dev)
    plan = compile(g, OPS, cfg)

    t0 = time.perf_counter()
    res = plan.run(g)
    dt = time.perf_counter() - t0
    print(f"\nfused {len(OPS)}-op pass: {dt * 1e3:.1f} ms, "
          f"host_syncs={plan.stats['host_syncs']} "
          f"(a census-only run costs the same)")

    census = res["triad_census"]
    top = sorted(zip(TRIAD_NAMES, census.counts), key=lambda x: -x[1])[:5]
    print("\ntriad_census (top types):",
          ", ".join(f"{nm}={int(c):,}" for nm, c in top if c))
    dy = res["dyad_census"]
    print(f"dyad_census: mutual={dy.mutual:,} asymmetric={dy.asymmetric:,} "
          f"null={dy.null:,}")
    ds = res["degree_stats"]
    print(f"degree_stats: max_out={ds.max_out} max_in={ds.max_in} "
          f"mean={ds.mean_out:.2f}; out-degree log2 histogram="
          f"{ds.out_hist.tolist()}")
    tp = res["triadic_profile"]
    print(f"triadic_profile: triangles={tp.triangles:,} "
          f"open_triples={tp.open_triples:,} "
          f"transitivity={tp.transitivity:.4f}")

    # the fused pass vs four separate passes over the same stream
    solo_plans = [compile(g, [name], cfg) for name in OPS]
    for p in solo_plans:
        p.run(g)  # build outside the timed region
    t0 = time.perf_counter()
    for p in solo_plans:
        p.run(g)
    separate = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.run(g)
    fused = time.perf_counter() - t0
    print(f"\nwarm fused pass {fused * 1e3:.1f} ms vs separate passes "
          f"{separate * 1e3:.1f} ms -> {separate / max(fused, 1e-9):.2f}x")
    return {"graph": g, "results": res}


if __name__ == "__main__":
    main()
