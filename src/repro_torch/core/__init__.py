"""Core library of the port: graphs, generators, the census building
blocks, graph mutations and the brute-force oracle (torch + numpy, no
JAX)."""
from .census import (CensusResult, brute_force_census, canonical_dyads,
                     enumerate_dyads_device, host_bucket_schedule,
                     make_census_batch_fn, make_member_fn, pad_dyads,
                     sort_dyads_by_bucket)
from .delta import GraphDelta, affected_dyads, apply_delta_csr
from .graph import (CSRGraph, GraphArrays, arcs_host, dense_adjacency,
                    from_edges, graph_from_reference_arrays,
                    load_pajek_or_edgelist, next_pow2, resolve_device)
from .triad_table import TRIAD_NAMES, TRIAD_TABLE_64

__all__ = [
    "CSRGraph", "CensusResult", "GraphArrays", "GraphDelta", "TRIAD_NAMES",
    "TRIAD_TABLE_64", "affected_dyads", "apply_delta_csr", "arcs_host", "brute_force_census", "canonical_dyads",
    "dense_adjacency", "enumerate_dyads_device", "from_edges",
    "graph_from_reference_arrays", "host_bucket_schedule",
    "load_pajek_or_edgelist", "make_census_batch_fn", "make_member_fn",
    "next_pow2", "pad_dyads", "resolve_device", "sort_dyads_by_bucket",
]
