"""``launches_per_graph``: ``census_csr`` launches in the window over the
graphs completed in it (the program's counter; the CPU path counts
none, and then there is nothing to read)."""


def read(rec):
    if not rec["launches"] or not rec["graphs"]:
        return None
    return rec["launches"] / rec["graphs"]
