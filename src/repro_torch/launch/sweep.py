"""Drive the whole dry-run sweep: every (arch × shape × mesh shape) cell.

Counterpart of :mod:`repro.launch.sweep`.  JAX runs each cell in a
process of its own (its 512-device XLA flag must be set before JAX
starts); the port's cells allocate nothing and set no flag, so they run
in this one process, in seconds.  Results land as JSON in ``--out``;
cells already done are kept unless ``--force``.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .dryrun import run_cell

ARCHS = [
    "zamba2-1.2b", "h2o-danube-3-4b", "qwen1.5-4b", "qwen3-4b",
    "deepseek-coder-33b", "pixtral-12b", "deepseek-v2-236b",
    "granite-moe-3b-a800m", "rwkv6-3b", "musicgen-large",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def main(argv=None) -> dict:
    """Runs the cells; returns ``{"ok", "skip", "fail": counts, "s"}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--meshes", default="single,multi")
    args = ap.parse_args(argv)

    cells = [(a, s, m) for a in args.archs.split(",")
             for s in args.shapes.split(",")
             for m in args.meshes.split(",")]
    t0 = time.time()
    counts = {"ok": 0, "skip": 0, "fail": 0}
    for i, (arch, shape, mesh) in enumerate(cells):
        mesh_name = "pod2x16x16" if mesh == "multi" else "pod16x16"
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                st = json.load(f).get("status")
            if st in ("ok", "skip"):
                print(f"[cached {st}] {arch} {shape} {mesh_name}", flush=True)
                counts[st] += 1
                continue
        st = run_cell(arch, shape, mesh == "multi", args.out)["status"]
        counts[st] += 1
        print(f"[{st:7s}] ({i + 1}/{len(cells)}) {arch} {shape} {mesh_name} "
              f"t={time.time() - t0:.1f}s", flush=True)
    counts["s"] = time.time() - t0
    print(f"done: ok={counts['ok']} skip={counts['skip']} "
          f"fail={counts['fail']} in {counts['s']:.1f}s", flush=True)
    return counts


if __name__ == "__main__":
    main()
