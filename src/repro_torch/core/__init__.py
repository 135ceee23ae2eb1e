"""Core library of the port: graphs (mmap-backed ones included),
generators, the census building blocks, load balancing, graph mutations,
locality reordering, graph partitioning and the brute-force oracle
(torch + numpy, no JAX)."""
from .balance import ShardedTasks, dyad_weights, exact_s_sizes, pack_tasks
from .census import (CensusResult, brute_force_census, canonical_dyads,
                     enumerate_dyads_device, host_bucket_schedule,
                     make_census_batch_fn, make_member_fn, pad_dyads,
                     sort_dyads_by_bucket)
from .delta import GraphDelta, affected_dyads, apply_delta_csr
from .graph import (CSRGraph, GraphArrays, arcs_host, arcs_host_iter,
                    dense_adjacency, from_edges, from_edges_mmap,
                    graph_from_reference_arrays, load_pajek_or_edgelist,
                    next_pow2, resolve_device)
from .partition import (GraphPartition, partition_cuts, partition_graph,
                        shard_dyads)
from .reorder import (REORDER_STRATEGIES, compute_permutation,
                      inverse_permutation, locality_score, permute_graph)
from .triad_table import TRIAD_NAMES, TRIAD_TABLE_64

__all__ = [
    "CSRGraph", "CensusResult", "GraphArrays", "GraphDelta", "GraphPartition",
    "REORDER_STRATEGIES", "ShardedTasks", "TRIAD_NAMES", "TRIAD_TABLE_64",
    "affected_dyads", "apply_delta_csr", "arcs_host", "arcs_host_iter",
    "brute_force_census", "canonical_dyads", "compute_permutation",
    "dense_adjacency", "dyad_weights", "enumerate_dyads_device",
    "exact_s_sizes", "from_edges", "from_edges_mmap",
    "graph_from_reference_arrays", "host_bucket_schedule",
    "inverse_permutation", "load_pajek_or_edgelist", "locality_score",
    "make_census_batch_fn", "make_member_fn", "next_pow2", "pack_tasks",
    "pad_dyads", "partition_cuts", "partition_graph", "permute_graph",
    "resolve_device", "shard_dyads", "sort_dyads_by_bucket",
]
