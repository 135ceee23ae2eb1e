"""``stale_flush_share``: the share of the census service's group flushes
that its ``max_wait_requests`` valve forced, in percent
(``CensusService.stats()["flushes"]`` at the window's end)."""


def read(rec):
    st = rec.get("service_stats") or {}
    flushes = st.get("flushes")
    if not flushes or not sum(flushes.values()):
        return None
    return 100.0 * flushes["stale"] / sum(flushes.values())
