"""Shared pieces of the benchmark's CPU tests: a tiny-graph rehearsal of
``perfbench/run.py`` on the CPU, through the test-only size override."""
from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(n: int):
    """A size override: the configuration's graph cut to ``n`` vertices,
    its arcs and blocks in proportion."""
    def shrink(cfg):
        cfg = json.loads(json.dumps(cfg))
        g = cfg["graph"]
        g.update(n=n, m=round(g["m"] * n / g["n"]),
                 blocks=max(1, round(g["blocks"] * n / g["n"])))
        return cfg
    return shrink


def rehearse(workload: str, *, seed: int = 3_000_000_019, seconds=0.5,
             trace: int = 0, n: int = 256):
    """Run a cell on the CPU at a tiny size; returns ``(exit code, last
    stdout line as an object or None, stderr)``.  The run's check for
    forbidden modules counts only those it loaded itself: other test files
    of the same process load JAX."""
    from unittest import mock

    from perfbench import run

    before = set(run.forbidden_modules())
    loaded = run.forbidden_modules
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            mock.patch.object(run, "forbidden_modules",
                              lambda: sorted(set(loaded()) - before)):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", shrink=tiny(n))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
