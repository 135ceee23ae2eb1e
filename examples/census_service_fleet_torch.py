"""Fleet serving through the PyTorch port: many small-graph censuses per
second, batched (the twin of ``examples/census_service_fleet.py``).

A stream of per-community subgraphs (R-MAT / Erdos-Renyi stand-ins)
submitted one at a time; the service groups them by plan-cache bucket
and runs each group as one batch.  Completions arrive out of submission
order; compare the per-bucket occupancy and host-sync counts with what B
single ``plan.run`` calls would have cost.

    PYTHONPATH=src python examples/census_service_fleet_torch.py --fleet 24

``--backend`` takes the port's names or JAX's (``xla`` -> ``search``,
``pallas`` -> ``tiles``); ``--device`` defaults to ``cuda``.
"""
import argparse
import time

import torch

from repro_torch.core import generators
from repro_torch.engine import CensusConfig, plan_cache_stats
from repro_torch.serve import CensusService, ServiceConfig

BACKENDS = {"xla": "search", "pallas": "tiles"}


def build_fleet(n: int, device):
    """A mixed fleet: two small-graph populations, several meta buckets."""
    fleet = []
    for i in range(n):
        if i % 3 == 2:
            fleet.append(generators.erdos_renyi(48, 96, seed=i,
                                                device=device))
        else:
            fleet.append(generators.rmat(5, edge_factor=2, seed=i,
                                         device=device))
    return fleet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait", type=int, default=12,
                    help="force-flush a partial bucket after this many "
                         "other-bucket submissions (bounded staleness)")
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "pallas", "search", "tiles"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = ServiceConfig(max_batch=args.max_batch,
                        max_wait_requests=args.max_wait,
                        census=CensusConfig(
                            backend=BACKENDS.get(args.backend, args.backend),
                            batch=64, chunk_dyads=64, device=dev))
    svc = CensusService(cfg)
    fleet = build_fleet(args.fleet, dev)

    print(f"submitting {len(fleet)} requests "
          f"(max_batch={args.max_batch}, max_wait={args.max_wait}; every "
          f"4th asks for a fused census+degree_stats pass) ...")

    def describe(c):
        if isinstance(c.result, dict):  # multi-op request
            ds = c.result["degree_stats"]
            return (f"total={c.result['triad_census'].total:,} "
                    f"max_out={ds.max_out}")
        return f"total={c.result.total:,}"

    done = {}
    t0 = time.perf_counter()
    for i, g in enumerate(fleet):
        # a mixed-analytic stream: groups batch by (bucket, ops) key
        ops = ("triad_census", "degree_stats") if i % 4 == 3 else None
        svc.submit(g, ops)
        for c in svc.poll():  # completions surface in batch flush order
            done[c.request_id] = c
            print(f"  completed request {c.request_id:>3} "
                  f"(bucket n<={c.meta.n_bucket}, k={c.meta.k}, "
                  f"ops={'+'.join(c.ops)}): {describe(c)}")
    for c in svc.flush():  # drain the partial groups
        done[c.request_id] = c
        print(f"  completed request {c.request_id:>3} (drain): "
              f"{describe(c)}")
    dt = time.perf_counter() - t0

    st = svc.stats()
    print(f"\n{st['requests']} requests in {dt:.2f}s "
          f"({st['requests'] / dt:.0f} req/s incl. build) — "
          f"{st['batches']} batches, mean width {st['mean_batch']:.1f}")
    for meta, b in st["buckets"].items():
        print(f"  bucket(n<={meta.n_bucket}, k={meta.k}): "
              f"{b['requests']} reqs in {b['batches']} batches, "
              f"occupancy {b['occupancy']:.2f}, "
              f"host_syncs {b['host_syncs']} "
              f"(sequential would have paid {b['requests']})")
    cache = plan_cache_stats()
    print(f"plan cache: {cache['size']} plans, hits={cache['hits']} "
          f"misses={cache['misses']}")
    return {"fleet": fleet, "completions": done, "stats": st}


if __name__ == "__main__":
    main()
