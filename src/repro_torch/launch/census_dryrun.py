"""Dry run of the paper's own workload: the distributed triad census of a
Table 4.1 dataset at its published size on the production mesh's ranks.

    PYTHONPATH=src python -m repro_torch.launch.census_dryrun \\
        --dataset patents [--multi-pod] [--scale-down 1] [--strategy ...]

Counterpart of :mod:`repro.launch.census_dryrun`.  It builds the plan's
inputs (the full-size graph profile, Patents as a memory-mapped graph,
and :func:`~repro_torch.core.balance.pack_tasks` for the mesh's
rank count) and runs no census.  Per rank it reports the dyads, the
chunks of its row, the bytes the census kernel must read for them (the
CSR rows the dyads touch, their range counts, u, v and the partials it
writes) and the kernel's bound on the card by the formula of
``PERF.md``: those bytes at 3.35 TB/s against Σ min(deg u, deg v) ·
⌈log2(max + 1)⌉ compares at 132 SMs × 64 int32 lanes × 1,980 MHz
(:mod:`repro_torch.launch.roofline`).  ``imbalance`` and
``lane_utilization`` are JAX's.  The fields JAX takes from XLA's
``memory_analysis`` (argument, temp and peak bytes) have no counterpart:
these counts take their place.  One JSON record lands in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..core import balance, generators
from ..core.census import canonical_dyads
from ..core.graph import from_edges_mmap
from ..engine.config import EngineConfig
from ..engine.plan import GraphMeta
from . import roofline
from .mesh import make_production_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="patents")
    ap.add_argument("--scale-down", type=float, default=1.0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="sorted_snake")
    ap.add_argument("--weights", default="canonical_uniform")
    ap.add_argument("--K", type=int, default=0, help="tile width override")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default="experiments/census_torch")
    ap.add_argument("--tag", default="")
    return ap.parse_args(argv)


def build_graph(dataset: str, scale_down: float):
    """The dataset's R-MAT profile on the host: Patents as a memory-mapped
    graph (files in a temporary directory, returned for removal), the
    others in memory."""
    if dataset == "patents":
        n, src, dst, directed = generators.paper_profile_arcs(dataset,
                                                              scale_down)
        tmp = tempfile.mkdtemp(prefix="census-dryrun-")
        return from_edges_mmap(n, src, dst, directed=directed, dir=tmp), tmp
    return generators.paper_profile(dataset, scale_down=scale_down,
                                    device="cpu"), None


def chunk_l(cfg: EngineConfig, meta: GraphMeta, n_ranks: int) -> int:
    """Per-rank streaming chunk length (JAX's ``backends.chunk_l``): the
    plan's chunk, capped by the dyad-count bucket, split over the ranks
    and rounded up to whole batches."""
    batch = cfg.batch
    dyad_cap = -(-max(1, meta.m_nbr_bucket // 2) // batch) * batch
    chunk = min(cfg.resolve_chunk(), dyad_cap)
    per = max(1, chunk // n_ranks)
    return max(batch, -(-per // batch) * batch)


def rank_work(deg: np.ndarray, u: np.ndarray, v: np.ndarray,
              valid: np.ndarray, block: int) -> dict:
    """One rank's census-kernel work for its row of tasks: the bytes read
    once (each distinct CSR row its dyads touch, a 4-byte index and a
    1-byte flag an entry and two 4-byte ptr entries; two 4-byte range
    counts at each end of a dyad; u and v; 64 bytes of partials a block
    written) and the compares."""
    uu, vv = u[valid].astype(np.int64), v[valid].astype(np.int64)
    rows = np.unique(np.concatenate([uu, vv]))
    du, dv = deg[uu], deg[vv]
    small, large = np.minimum(du, dv), np.maximum(du, dv)
    L = len(u)
    nbytes = {"csr_rows": int((5 * deg[rows] + 8).sum()),
              "range_counts": 16 * int(valid.sum()),
              "u": 4 * L, "v": 4 * L, "partials": 64 * (L // block)}
    compares = float((small * np.ceil(np.log2(large + 1.0))).sum())
    return {"dyads": int(valid.sum()), "bytes": nbytes,
            "compares": compares}


def run(dataset: str, *, scale_down: float = 1.0, multi_pod: bool = False,
        strategy: str = "sorted_snake", weights: str = "canonical_uniform",
        K: int = 0, batch: int = 256) -> dict:
    """The dry run's record (see the module docstring), no file
    written."""
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_ranks = math.prod(mesh.values())
    g, tmp = build_graph(dataset, scale_down)
    try:
        t_graph = time.time() - t0
        cfg = EngineConfig(backend="distributed", batch=batch, k=K or None,
                           strategy=strategy, weight_model=weights)
        meta = GraphMeta.from_graph(g, k=cfg.k)
        u, v = canonical_dyads(g)
        tasks = balance.pack_tasks(g, n_ranks, weight_model=weights,
                                   strategy=strategy, pad_multiple=batch)
        cl = chunk_l(cfg, meta, n_ranks)
        deg = np.asarray(g.host.nbr_deg).astype(np.int64)
        useful = float((deg[u] + deg[v]).sum())
        L = tasks.u.shape[1]
        padded = float(tasks.u.shape[0] * (-(-L // cl) * cl) * 2 * meta.k)
        block = cfg.resolve_block()
        ranks = [rank_work(deg, tasks.u[r], tasks.v[r], tasks.valid[r],
                           block) for r in range(n_ranks)]
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    rank_bytes = [sum(r["bytes"].values()) for r in ranks]
    worst = int(np.argmax([max(b / roofline.HBM_BW,
                               r["compares"] / roofline.INT32_OPS)
                           for b, r in zip(rank_bytes, ranks)]))
    bytes_s = rank_bytes[worst] / roofline.HBM_BW
    ops_s = ranks[worst]["compares"] / roofline.INT32_OPS
    return {
        "dataset": dataset, "mesh": mesh, "strategy": strategy,
        "weights": weights, "K": meta.k, "chunk_l": cl,
        "n_dyads": int(len(u)), "max_deg": int(g.max_deg),
        "imbalance": tasks.imbalance,
        "lane_utilization": useful / padded if padded else 0.0,
        "status": "ok",
        "ranks": {
            "n": n_ranks, "row_len": L, "chunks": -(-L // cl),
            "dyads": [r["dyads"] for r in ranks],
            "bytes": rank_bytes,
            "bytes_max": {k: max(r["bytes"][k] for r in ranks)
                          for k in ranks[0]["bytes"]},
            "compares": [r["compares"] for r in ranks],
        },
        "census_csr_bound": {
            "rank": worst, "bytes_s": bytes_s, "operations_s": ops_s,
            "bound_s": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"},
        "roofline": roofline.roofline_terms(0.0, rank_bytes[worst], 0.0),
        "graph_s": t_graph,
        "total_s": time.time() - t0,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    rec = run(args.dataset, scale_down=args.scale_down,
              multi_pod=args.multi_pod, strategy=args.strategy,
              weights=args.weights, K=args.K, batch=args.batch)
    rec["tag"] = args.tag
    os.makedirs(args.out, exist_ok=True)
    name = (f"census_{args.dataset}_{args.strategy}_K{rec['K']}"
            f"{'_multipod' if args.multi_pod else ''}"
            f"{('_' + args.tag) if args.tag else ''}")
    with open(os.path.join(args.out, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(json.dumps({k: rec[k] for k in
                      ("imbalance", "lane_utilization", "census_csr_bound")},
                     indent=1))
    print(f"done in {rec['total_s']:.1f}s", file=sys.stderr)
    return rec


if __name__ == "__main__":
    main()
