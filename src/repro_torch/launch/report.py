"""Render the dry-run and roofline tables from the sweep's JSON records
(counterpart of :mod:`repro.launch.report`, reading the port's records:
each rank's state bytes from the rule table and the card's roofline
terms, where JAX's hold XLA's memory analysis and HLO counts).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os

from .sweep import ARCHS as ARCH_ORDER
from .sweep import SHAPES as SHAPE_ORDER


def load(out_dir: str) -> dict:
    recs = {}
    for f in os.listdir(out_dir):
        if f.endswith(".json"):
            with open(os.path.join(out_dir, f)) as fh:
                r = json.load(fh)
            recs[(r.get("arch"), r.get("shape"), r.get("mesh"),
                  r.get("tag", ""))] = r
    return recs


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def fmt_b(x):
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.1f}{unit}"
    return f"{x:.0f}B"


def dryrun_table(recs, mesh="pod16x16"):
    lines = ["| arch | shape | status | params/rank | grads + moments/rank "
             "| cache/rank | state/rank | model flops/card "
             "| coll bytes/card |",
             "|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh, ""))
            if r is None:
                continue
            if r["status"] != "ok":
                reason = r.get("reason", r.get("error", ""))[:60]
                lines.append(f"| {a} | {s} | {r['status']} ({reason}) "
                             "| | | | | | |")
                continue
            mem, rf = r["memory"], r["roofline"]
            opt = sum(mem.get(g, 0) for g in ("grads", "m", "v"))
            lines.append(
                f"| {a} | {s} | ok | {fmt_b(mem['params'])} | {fmt_b(opt)} "
                f"| {fmt_b(mem.get('cache', 0))} "
                f"| {fmt_b(mem['rank_state_bytes'])} "
                f"| {rf['model_flops_per_chip']:.2e} "
                f"| {fmt_b(rf['collective_bytes_per_chip'])} |")
    return "\n".join(lines)


def roofline_table(recs, mesh="pod16x16"):
    lines = ["| arch | shape | compute | memory | collective | bottleneck | "
             "roofline frac |", "|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh, ""))
            if r is None or r["status"] != "ok":
                continue
            rf = r["roofline"]
            lines.append(
                f"| {a} | {s} | {fmt_s(rf['compute_s'])} "
                f"| {fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} "
                f"| {rf['bottleneck'].replace('_s', '')} "
                f"| {100 * rf['roofline_fraction']:.1f}% |")
    return "\n".join(lines)


def multipod_table(recs):
    lines = ["| arch | shape | 16x16 | 2x16x16 |", "|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r1 = recs.get((a, s, "pod16x16", ""))
            r2 = recs.get((a, s, "pod2x16x16", ""))
            if r1 is None and r2 is None:
                continue
            lines.append(f"| {a} | {s} | {(r1 or {}).get('status', '-')} "
                         f"| {(r2 or {}).get('status', '-')} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "multipod"])
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.section in ("all", "dryrun"):
        print("### Dry-run (single-pod 16x16, per rank)\n")
        print(dryrun_table(recs))
        print()
    if args.section in ("all", "multipod"):
        print("### Multi-pod pass/fail\n")
        print(multipod_table(recs))
        print()
    if args.section in ("all", "roofline"):
        print("### Roofline (single-pod, per H100)\n")
        print(roofline_table(recs))


if __name__ == "__main__":
    main()
