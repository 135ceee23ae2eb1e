"""Dry run of one (arch × shape × mesh shape) cell: each rank's bytes of
parameters, gradients, moments, batch and cache from the rule table, and
the roofline terms on the card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]

Counterpart of :mod:`repro.launch.dryrun`.  JAX lowers and compiles each
cell on 512 forced host devices and reads XLA's ``memory_analysis`` and
optimized HLO; the port has no XLA program to lower, so the cell is built
on the ``meta`` device (:func:`~repro_torch.launch.specs.build_cell`,
nothing allocated) and counted:

* ``memory``: per group (``params``, ``grads``, ``m``, ``v``, ``batch``,
  ``cache``) the largest rank's bytes, a dim split over an axis of size
  ``s`` holding ``ceil(dim / s)`` as a DTensor ``Shard`` splits it;
  ``rank_state_bytes`` their sum;
* ``roofline``: :func:`~repro_torch.launch.roofline.model_flops` per
  card against the card's bf16 peak, the rank's state bytes read once
  against HBM, and the FSDP traffic over NVLink (each parameter shard
  gathered over the fsdp axis once a forward, again in a remat
  recompute, and its gradient reduce-scattered; the tensor-parallel
  activation collectives are not counted).  A lower bound, not a
  prediction.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

from ..config import SHAPES
from ..sharding.rules import axis_sizes, shard_shape
from . import roofline
from .mesh import make_production_mesh
from .specs import SkipCell, build_cell, default_run


def rank_bytes(tensors: dict, specs: dict, sizes: dict) -> int:
    """The largest rank's bytes of ``tensors`` placed by ``specs``."""
    total = 0
    for k, t in tensors.items():
        total += math.prod(shard_shape(tuple(t.shape), sizes,
                                       specs[k])) * t.element_size()
    return total


def _fsdp_bytes(cell, group: str, sizes: dict) -> float:
    """Bytes a rank moves to gather (or reduce-scatter) the ``group``
    tree's shards over the fsdp axis once: ``(s - 1) / s`` of its
    model-axis shard."""
    ax = cell.run.fsdp_axis
    s = sizes.get(ax, 1) if ax else 1
    if s <= 1:
        return 0.0
    no_fsdp = {k: tuple(None if e == ax else e for e in spec)
               for k, spec in cell.specs[group].items()}
    return rank_bytes(cell.state[group], no_fsdp, sizes) * (s - 1) / s


def analyze(cell) -> "tuple[dict, dict]":
    """``(memory, roofline)`` of a cell (see the module docstring)."""
    sizes = axis_sizes(cell.meta["mesh"])
    memory = {g: rank_bytes(cell.state[g], cell.specs[g], sizes)
              for g in cell.state}
    memory["rank_state_bytes"] = sum(memory.values())
    n_chips = math.prod(sizes.values())
    mf = roofline.model_flops(cell.meta)
    coll = _fsdp_bytes(cell, "params", sizes)
    if cell.meta["kind"] == "train":
        coll *= 2.0 if cell.run.remat != "none" else 1.0
        coll += _fsdp_bytes(cell, "grads", sizes)
    out = {"model_flops_total": mf, "model_flops_per_chip": mf / n_chips,
           "collective_bytes_per_chip": coll, "n_chips": n_chips}
    out.update(roofline.roofline_terms(mf / n_chips,
                                       memory["rank_state_bytes"], coll))
    denom = out["step_s_lower_bound"]
    out["roofline_fraction"] = out["compute_s"] / denom if denom > 0 else 0.0
    return memory, out


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             run_overrides: "dict | None" = None, tag: str = "") -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{arch}__{shape}__{mesh_name}{('__' + tag) if tag else ''}"
    os.makedirs(out_dir, exist_ok=True)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        run = None
        if run_overrides:
            run = dataclasses.replace(default_run(arch, SHAPES[shape]),
                                      **run_overrides)
        cell = build_cell(arch, shape, mesh, run=run)
        rec["status"] = "ok"
        rec["meta"] = cell.meta
        rec["memory"], rec["roofline"] = analyze(cell)
    except SkipCell as e:
        rec["status"] = "skip"
        rec["reason"] = str(e)
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug to record
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.time() - t0
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"[{rec['status']:4s}] {name}  ({rec['total_s']:.3f}s)",
          file=sys.stderr)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig override, e.g. --set microbatch=16")
    args = ap.parse_args(argv)
    overrides = {}
    for s in args.set:
        k, v = s.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                   run_overrides=overrides or None, tag=args.tag)
    return 0 if rec["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
