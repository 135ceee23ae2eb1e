"""``graph_build_s``: host seconds in the program's graph builder
(``repro_torch.core.graph.from_edges``), summed over the run's graphs."""


def read(rec):
    return rec["graph_build_s"]
