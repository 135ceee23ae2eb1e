"""One run of one cell: inputs from the seed, set-up, the measured
window, the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: ``configs/<file>`` (named in ``BENCHMARK.json``),
``traffic/<traffic>.json`` (its ``loop`` names a driver,
``loops/<loop>.py``), ``ops/<op>.py`` for each op an answer holds and
``metrics/<family>.py`` for a metric named ``<family>`` or
``<family>.<suffix>``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import answers, graphs, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_config(bench: dict, name: str) -> dict:
    """The configuration's file, as named in ``BENCHMARK.json``."""
    entry, = [c for c in bench["configs"] if c["name"] == name]
    return json.loads((ROOT / entry["file"]).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def loop(name: str):
    """The ``run`` of a traffic's driver, ``loops/<name>.py``."""
    return importlib.import_module(f"perfbench.loops.{name}").run


def reader(metric_name: str):
    """The ``read(record)`` of a metric's family module."""
    family = metric_name.split(".")[0]
    return importlib.import_module(f"perfbench.metrics.{family}").read


def cell_metrics(metrics: "list[dict]", cell: str) -> "list[dict]":
    """The metrics that a cell reports: those that list it, and those
    that list no cells."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Inputs:
    """The pool of graphs a run serves: arc lists made from the seed (kept
    on the host for the reference) and the program's graphs built from
    them."""

    n: int
    arcs: list       # [(src, dst)] int64 host tensors
    graphs: list     # the program's CSRGraph of each
    build_s: float   # host seconds in the program's graph builder


def make_inputs(graph_cfg: dict, seed: int, pool: int, device) -> Inputs:
    from repro_torch.core.graph import from_edges

    arcs, built, build_s = [], [], 0.0
    n = 0
    for i in range(pool):
        n, src, dst = graphs.arcs(graph_cfg, seed + i, device)
        src, dst = src.cpu(), dst.cpu()
        t0 = time.perf_counter()
        built.append(from_edges(n, src.numpy(), dst.numpy(),
                                directed=True, device=device))
        build_s += time.perf_counter() - t0
        arcs.append((src, dst))
    return Inputs(n, arcs, built, build_s)


def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float,
             trace: bool, device, shrink=None, t_start: float) -> dict:
    """Run ``cell`` once; returns the result line's object."""
    cfg = load_config(bench, cell["config"])
    if shrink is not None:
        cfg = shrink(cfg)
    traffic = load_traffic(cell["traffic"])
    dev = torch.device(device)
    inputs = make_inputs(cfg["graph"], seed, int(traffic.get("pool", 1)),
                         dev)
    rec = loop(traffic["loop"])(inputs, traffic, seed=seed,
                                seconds=seconds, trace=trace, device=dev,
                                t_start=t_start)
    rec["graph_build_s"] = inputs.build_s
    u = 1e3 * np.asarray(rec["unit_s"])
    # graphs done in each half of the window: a run's own drift, beside
    # the spread between runs
    half = rec["window_s"] / 2
    first = sum(t < half for t in rec["done_t"])
    rec["host"]["graphs_by_half"] = [first, len(rec["done_t"]) - first]
    print(f"window {rec['window_s']:.3f} s, {len(u)} units, unit ms "
          f"p10/p50/p90/max {np.percentile(u, 10):.2f}/"
          f"{np.percentile(u, 50):.2f}/{np.percentile(u, 90):.2f}/"
          f"{u.max():.2f}; set-up {rec['setup_s']:.2f} s, graph build "
          f"{inputs.build_s:.2f} s, first run {rec['plan_cold_s']:.2f} s",
          file=sys.stderr)
    print(f"host {json.dumps(rec['host'])}", file=sys.stderr)
    if dev.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(dev),
                    "count": 1}
    else:
        rec["memory_peak_bytes"] = 0
        dev_info = {"platform": dev.type, "kind": dev.type, "count": 1}
    dev_info["memory_peak_bytes"] = rec["memory_peak_bytes"]

    # the program's state goes before the reference runs on the card
    n, arcs = inputs.n, inputs.arcs
    del inputs
    from repro_torch.engine import clear_plan_cache

    clear_plan_cache()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = answers.check(rec["answers"], n, arcs, device=dev)
    if trace:
        rec["bound_s"] = [work.census_work(n, *(t.to(dev) for t in a))
                          ["bound_s"] for a in arcs]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench[kind], cell["name"]):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev_info}
    if trace and rec.get("trace"):
        t = rec["trace"]
        dev_info["busy_s"] = t["busy_s"]
        dev_info["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["host"] = rec["host"]
    out["checks"] = checks
    return out
