"""``batch_occupancy``: graphs per batch the census service ran in the
window (``CensusService.stats()["mean_batch"]``)."""


def read(rec):
    st = rec.get("service_stats")
    if not st or not st["batches"]:
        return None
    return st["mean_batch"]
