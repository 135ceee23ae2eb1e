"""Core library of the port: graphs (mmap-backed ones included),
generators, the census building blocks, load balancing, graph mutations,
locality reordering, graph partitioning, the distributed schedule and the
brute-force oracle (torch + numpy, no JAX).

The public census entry point is :mod:`repro_torch.engine`
(``compile_census(graph, CensusConfig(...)).run(graph)``); its names are
re-exported here lazily.  ``triad_census``, ``make_census_fn``,
``distributed_triad_census`` and ``make_distributed_census_fn`` remain as
deprecated shims, as in the JAX package.  ``__all__`` is the JAX
package's less ``stack_graph_arrays`` (``Plan.run_batch`` has no vmap);
the port's own building blocks are importable here too.
"""
from .balance import ShardedTasks, dyad_weights, exact_s_sizes, pack_tasks
from .census import (CensusResult, brute_force_census, canonical_dyads,
                     enumerate_dyads_device, host_bucket_schedule,
                     make_census_batch_fn, make_census_fn, make_member_fn,
                     pad_dyads, sort_dyads_by_bucket, triad_census)
from .delta import GraphDelta, affected_dyads, apply_delta_csr
from .distributed import distributed_triad_census, make_distributed_census_fn
from .graph import (CSRGraph, GraphArrays, arcs_host, arcs_host_iter,
                    dense_adjacency, from_edges, from_edges_mmap,
                    graph_from_reference_arrays, load_pajek_or_edgelist,
                    next_pow2, resolve_device)
from .partition import (GraphPartition, partition_cuts, partition_graph,
                        shard_dyads)
from .reorder import (REORDER_STRATEGIES, compute_permutation,
                      inverse_permutation, locality_score, permute_graph)
from .triad_table import TRIAD_NAMES, TRIAD_TABLE_64

_ENGINE_EXPORTS = ("CensusConfig", "CensusPlan", "GraphMeta",
                   "clear_plan_cache", "compile_census", "plan_cache_stats")

__all__ = [
    "CSRGraph", "CensusResult", "GraphArrays", "GraphDelta", "GraphPartition",
    "REORDER_STRATEGIES", "ShardedTasks", "TRIAD_NAMES", "TRIAD_TABLE_64",
    "affected_dyads", "apply_delta_csr", "arcs_host", "arcs_host_iter",
    "brute_force_census", "canonical_dyads", "compute_permutation",
    "distributed_triad_census", "dyad_weights", "exact_s_sizes",
    "from_edges", "from_edges_mmap", "inverse_permutation",
    "load_pajek_or_edgelist", "locality_score", "make_census_fn",
    "make_distributed_census_fn", "pack_tasks", "partition_cuts",
    "partition_graph", "permute_graph", "shard_dyads", "triad_census",
    *_ENGINE_EXPORTS,
]


def __getattr__(name):
    # lazy re-export: repro_torch.engine imports repro_torch.core
    # submodules, so an eager import here would be circular
    if name in _ENGINE_EXPORTS:
        from .. import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
