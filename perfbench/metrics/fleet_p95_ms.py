"""``fleet_p95_ms``: the 95th percentile of the latency, from ``submit``
until the completion surfaced, of every request completed in the window
(in a ``--trace 1`` run, of those completed before the profiler started
on the window's last seconds: it slows the host)."""
import numpy as np


def read(rec):
    if not rec.get("latency_s"):
        return None
    return 1e3 * float(np.percentile(rec["latency_s"], 95))
