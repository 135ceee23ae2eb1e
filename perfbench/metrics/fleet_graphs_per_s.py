"""``fleet_graphs_per_s``: graphs whose completion surfaced inside the
window, over the window."""


def read(rec):
    return rec["graphs"] / rec["window_s"]
