"""Social-network-analysis scenario through the PyTorch port (the paper's
use case, end to end; the twin of ``examples/triad_census_sna.py``).

Builds a network shaped like a Table 4.1 dataset, runs the census on the
distributed backend over the process group's ranks (one rank without a
group) with the paper's task-queue balancing, and derives the SNA
statistics the census exists for (transitivity, reciprocity).

    PYTHONPATH=src python examples/triad_census_sna_torch.py --dataset slashdot
    # several ranks:
    torchrun --nproc-per-node 2 examples/triad_census_sna_torch.py

``--device`` defaults to ``cuda``.
"""
import argparse

import torch
import torch.distributed as dist

from repro_torch.core import generators
from repro_torch.core.triad_table import TRIAD_NAMES
from repro_torch.engine import CensusConfig, compile_census


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="slashdot",
                    choices=sorted(generators.PAPER_DATASETS))
    ap.add_argument("--scale-down", type=float, default=256.0,
                    help="1.0 = full paper-sized graph")
    ap.add_argument("--strategy", default="sorted_snake")
    ap.add_argument("--weights", default="canonical_uniform")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = generators.paper_profile(args.dataset, scale_down=args.scale_down,
                                 device=dev)
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    print(f"dataset={args.dataset} (R-MAT stand-in) n={g.n} m={g.m} "
          f"ranks={ranks}")

    cfg = CensusConfig(backend="distributed", strategy=args.strategy,
                       weight_model=args.weights, device=dev)
    plan = compile_census(g, cfg)
    res = plan.run(g)
    print(f"load imbalance ({args.strategy}/{args.weights}): "
          f"{plan.last_task_stats.imbalance:.4f}")
    print("\ntriad census:")
    for name, c in zip(TRIAD_NAMES, res.counts):
        print(f"  {name:5s} {c:>16,}")

    c = res.counts.astype(float)
    # SNA statistics from the census (Wasserman-Faust style)
    # transitivity: fraction of potentially-transitive triads that are
    triads_2path = c[[4, 5, 6, 8, 9, 11, 12, 13, 14, 15]].sum()  # >=2 paths
    closed = c[[8, 11, 12, 13, 14, 15]].sum()
    mutual = 2 * c[2] + 2 * c[6] + 2 * c[7] + 4 * c[10] + 2 * c[11] + \
        2 * c[12] + 2 * c[13] + 4 * c[14] + 6 * c[15]
    print(f"\nclosed/connected ratio: {closed / max(triads_2path, 1):.4f}")
    print(f"reciprocity-weighted triads: {mutual:,.0f}")
    return {"graph": g, "census": res}


if __name__ == "__main__":
    main()
