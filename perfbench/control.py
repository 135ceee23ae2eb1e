"""The control of the comparison that decides ``correct``: the reference
put in the program's place and accumulated in a lower precision than the
exact int64 counts the configuration states, judged by the same
comparison.  Every reading has to exceed the limit.

    python3 perfbench/control.py --config amazon --seeds 11 12 13

Prints one JSON line per seed and precision: the number compared
(``bins_off``), its limit, the exact reference's seconds, and the
stand-in graph's statistics (arcs, dyads, mutual dyads, the out- and
in-degree maxima, triangles: triads whose three dyads are connected).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRECISIONS = ("int32", "float32")


#: the triad types whose three dyads are connected
TRIANGLES = ("030T", "030C", "120D", "120U", "120C", "210", "300")


def graph_stats(n: int, src, dst, bins: list) -> dict:
    """The stand-in's statistics that its configuration compares with
    the published network's."""
    import torch

    from perfbench import reference
    from perfbench.triads import NAMES

    key, state = reference.dyads(n, src, dst)
    return {"arcs": src.numel(), "dyads": key.numel(),
            "mutual_dyads": int((state == 3).sum()),
            "max_out": int(torch.bincount(src, minlength=n).max()),
            "max_in": int(torch.bincount(dst, minlength=n).max()),
            "triangles": sum(bins[NAMES.index(t)] for t in TRIANGLES)}


def readings(cfg: dict, seed: int, device, precisions=PRECISIONS) -> list:
    """``[{"seed", "acc", "bins_off", "limit", "reference_s", "graph"}]``
    for one graph of the configuration."""
    import torch

    from perfbench import answers, graphs

    census = answers.op("triad_census")
    n, src, dst = graphs.arcs(cfg["graph"], seed, device)
    t0 = time.perf_counter()
    exact = census.reference_values(n, src, dst)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    stats = graph_stats(n, src, dst, exact)
    out = []
    for acc in precisions:
        ctrl = census.reference_values(n, src, dst, acc=getattr(torch, acc))
        out.append({"seed": seed, "acc": acc,
                    "bins_off": answers.differing(ctrl, exact),
                    "limit": census.LIMIT, "reference_s": ref_s,
                    "graph": stats})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{args.config}.json").read_text())
    for seed in args.seeds:
        for r in readings(cfg, seed, "cuda"):
            print(json.dumps({"config": args.config, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
