"""``batch_wait_p95_ms``: the 95th percentile of the time from a request's
``submit`` to the start of the ``submit`` call that ran its batch, over
the requests completed in the window (in a ``--trace 1`` run, those
completed before the profiler started on the window's last seconds: it
slows the host)."""
import numpy as np


def read(rec):
    w = rec.get("batch_wait_s")
    if not w:
        return None
    return 1e3 * float(np.percentile(w, 95))
