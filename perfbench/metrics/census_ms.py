"""``census_ms``: the whole window over the censuses completed in it."""


def read(rec):
    if not rec["graphs"]:
        return None
    return 1e3 * rec["window_s"] / rec["graphs"]
