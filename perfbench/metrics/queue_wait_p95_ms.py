"""``queue_wait_p95_ms``: the census service's own 95th percentile of the
time from a request's ``submit`` to the start of its group's flush, over
its last 4,096 requests (``CensusService.stats()["queue_wait_ms"]`` at
the window's end)."""


def read(rec):
    st = rec.get("service_stats") or {}
    q = st.get("queue_wait_ms")
    if not q or not q["n"]:
        return None
    return q["p95"]
