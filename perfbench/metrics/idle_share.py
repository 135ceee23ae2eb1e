"""``idle_share``: the share of the traced window in which no operation
ran on the device, in percent."""


def read(rec):
    t = rec.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
