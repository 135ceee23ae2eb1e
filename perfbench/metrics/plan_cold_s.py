"""``plan_cold_s``: host seconds of ``compile`` and the first run of the
first graph, waited for with ``synchronize``."""


def read(rec):
    return rec["plan_cold_s"]
