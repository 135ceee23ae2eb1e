"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 perfbench/run.py --workload amazon.census --seed 7 \\
        --seconds 20 --trace 0

Run from the root of a checkout on a machine with an NVIDIA GPU.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and ``checks`` last: each number compared beside its
limit); the checks are also the last lines of standard error.  Without
a card, or with fewer cards than the cell asks for, it prints no result
and exits with 2.
"""
import time

T_START = time.time()  # set-up runs from here to the first timed graph

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> "list[str]":
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None, *, device=None, shrink=None) -> int:
    """Run a cell; returns the exit code.  ``device`` and ``shrink`` are
    for the CPU tests alone: a device other than the card, and a function
    that cuts a configuration's graph to a test size."""
    args = parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs only on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} cards, this "
                  f"machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    from perfbench import harness

    out = harness.run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device=device,
                           shrink=shrink, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
