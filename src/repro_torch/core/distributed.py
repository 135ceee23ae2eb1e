"""The distributed census over ``torch.distributed``: one process per
rank, one merge per run.

Counterpart of :mod:`repro.core.distributed`, which maps the paper's
parallel schedule onto a ``shard_map`` mesh.  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of any number of
dimensions, and the model is SPMD: every rank makes the same calls in the
same order.

  * every rank takes one **static task row** from
    :func:`repro_torch.core.balance.pack_tasks` (the paper's task queue),
    row ``r`` for the rank whose flattened mesh coordinate is ``r``; the
    packing is deterministic, so the ranks agree without talking (a
    list of dyads or shards is dealt round-robin instead, :func:`deal`);
  * the graph is replicated on every rank (the paper's shared memory);
  * each rank adds its tasks' bins into a private int64 accumulator (the
    paper's decoupled per-thread census) and :func:`merge_over_mesh`
    performs the end-of-run merge: one ``all_reduce(SUM)`` per mesh
    dimension, the only communication of a run, then one copy to the
    host.  :func:`make_census_fn_for_mesh` is that schedule, defined
    once: the engine's distributed plans hold one.

A rank whose own work fails still joins the merge, with an error flag
that rides in the same all-reduce ahead of the bins, so a rank-local
failure raises on every rank at once (the failing rank re-raises its
error, the others :class:`RemoteRankError`) instead of leaving its peers
waiting in the collective.  A rank that dies outright, or an
asynchronous device fault that breaks the collective itself, surfaces as
the process group's own timeout (``init_process_group(timeout=...)``).

A process without a process group runs the same code on a one-rank
:class:`LocalMesh` (W = 1, no collective): the counterpart of the JAX
package's one-device default mesh.

``merge_over_mesh.collectives`` counts the all-reduces issued, in the
idiom of ``census_csr.launches``.  :func:`distributed_triad_census` and
:func:`make_distributed_census_fn` are the deprecated entry points of the
JAX package, kept as shims.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import warnings

import numpy as np
import torch

__all__ = ["LocalMesh", "RemoteRankError", "deal", "default_mesh",
           "distributed_triad_census", "make_census_fn_for_mesh",
           "make_distributed_census_fn", "merge_over_mesh", "mesh_rank",
           "mesh_size"]

_COUNT_LOCK = threading.Lock()


class RemoteRankError(RuntimeError):
    """Another rank of the mesh failed its share of the run: raised on
    every rank whose own share succeeded, by the merge that carried the
    failing rank's error flag."""


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The one-rank mesh of a process without a process group: shape
    ``(1,)``, this process at coordinate ``(0,)``, and no group, so the
    merge issues no collective."""

    device_type: str = "cuda"

    shape = (1,)
    ndim = 1

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_coordinate(self):
        return (0,)

    def get_group(self, mesh_dim=0):
        return None


#: device type -> (the default process group, its 1-D mesh)
_DEFAULT_MESHES: dict = {}


def default_mesh(device: torch.device):
    """The mesh a distributed plan takes when none is given: a 1-D
    ``DeviceMesh`` over the world when the default process group is
    initialized (built once per group and device type), else the
    one-rank :class:`LocalMesh` (its device type is the plan's)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return LocalMesh(device.type)
    world = dist.group.WORLD
    hit = _DEFAULT_MESHES.get(device.type)
    if hit is not None and hit[0] is world:
        return hit[1]
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device.type, (dist.get_world_size(),))
    _DEFAULT_MESHES[device.type] = (world, mesh)
    return mesh


def mesh_size(mesh) -> int:
    """The number of ranks of ``mesh``: W (1 for ``None``, no mesh)."""
    return 1 if mesh is None else int(math.prod(tuple(mesh.shape)))


def mesh_rank(mesh) -> int:
    """This rank's shard index: its flattened (row-major) coordinate in
    ``mesh`` (0 for ``None``, no mesh)."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not a rank of the mesh")
    return int(np.ravel_multi_index(tuple(int(c) for c in coord),
                                    tuple(mesh.shape)))


def deal(mesh, seq):
    """This rank's round-robin share of ``seq``: items ``r, r + W, ...``
    for rank ``r`` of W (the JAX package deals item ``i`` to rank ``i %
    W``); all of ``seq`` for ``None``, no mesh.  The one place the work
    of a pass is dealt to the ranks."""
    if mesh is None:
        return seq
    return seq[mesh_rank(mesh)::mesh_size(mesh)]


def merge_over_mesh(mesh, acc: torch.Tensor, fill=None, *,
                    stats=None) -> np.ndarray:
    """The run's merge: ``fill(acc)`` adds this rank's share into the int64
    accumulator ``acc``, then the bins of every rank are summed by one
    ``all_reduce(SUM)`` per mesh dimension, in dimension order, and copied
    to the host once (counted in ``stats["host_syncs"]`` when given).
    Returns the merged bins as int64 numpy of ``acc``'s shape.

    An exception raised by ``fill`` does not skip the merge: the rank
    joins it with an error flag that the same all-reduce carries ahead of
    the bins, and then re-raises; every other rank raises
    :class:`RemoteRankError`.  So the ranks leave the merge together."""
    import torch.distributed as dist

    error = None
    if fill is not None:
        try:
            fill(acc)
        except Exception as e:  # joins the merge, re-raised below
            error = e
    flag = torch.full((1,), int(error is not None), dtype=torch.int64,
                      device=acc.device)
    buf = torch.cat([flag, acc.reshape(-1).to(torch.int64)])
    for dim in range(mesh.ndim):
        group = mesh.get_group(dim)
        if group is None:
            continue
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        with _COUNT_LOCK:
            merge_over_mesh.collectives += 1
    host = buf.cpu().numpy()
    if stats is not None:
        stats["host_syncs"] += 1
    if error is not None:
        raise error
    failed = int(host[0])
    if failed:
        raise RemoteRankError(
            f"{failed} rank(s) of the {mesh_size(mesh)}-rank mesh failed "
            "their share of this run; this rank's share succeeded")
    return host[1:].reshape(tuple(acc.shape))


merge_over_mesh.collectives = 0


def make_census_fn_for_mesh(mesh, *, n_bins: int, device, stats=None):
    """The SPMD schedule, its one definition: every run, batch and delta
    of the engine's distributed backend, partitioned or not, and the
    legacy :func:`make_distributed_census_fn` go through it.  Returns
    ``census(fill, *shape)``: a fresh private int64 accumulator of shape
    ``(*shape, n_bins)`` on ``device``, ``fill(acc)`` sweeping this rank's
    share of the work into it — its task row through the chunk unit, on
    the engine's executor, so chunk retry and fault injection stay ahead
    of the merge — then :func:`merge_over_mesh` (``stats`` counts its
    host copy).  Returns the merged bins as int64 numpy."""

    def census(fill, *shape) -> np.ndarray:
        acc = torch.zeros(*shape, n_bins, dtype=torch.int64, device=device)
        return merge_over_mesh(mesh, acc, fill, stats=stats)

    return census


def make_distributed_census_fn(g, mesh, *, batch: int = 256,
                               K: "int | None" = None):
    """Deprecated: the distributed census of graphs shaped like ``g``;
    returns ``census(arrays, n, tasks_u, tasks_v, valid) -> (16,)``
    int64, where ``tasks_*`` are ``(W, L)`` task arrays
    (:func:`~repro_torch.core.balance.pack_tasks`) and this rank runs
    row :func:`mesh_rank` of them, without its padding slots, as a subset
    pass of a distributed census plan compiled for ``g`` and ``mesh``
    (``K``: its tile width) over ``arrays`` — the graph's tensors — and
    merges it over the mesh.  ``n`` is taken from ``g``.  Null triads
    (type 003) are not counted."""
    from ..engine import EngineConfig, compile
    from ..engine.backends import run_rank_row

    warnings.warn(
        "repro_torch.core.distributed.make_distributed_census_fn is "
        "deprecated; use repro_torch.engine.compile_census with "
        "CensusConfig(backend='distributed')",
        DeprecationWarning, stacklevel=2)
    plan = compile(g, ("triad_census",), EngineConfig(
        backend="distributed", batch=batch, k=K, device=str(g.device)),
        mesh=mesh)

    def census(arrays, n, tasks_u, tasks_v, valid) -> np.ndarray:
        r = mesh_rank(mesh)
        keep = np.asarray(valid)[r]
        u, v = (np.ascontiguousarray(np.asarray(t)[r][keep], dtype=np.int32)
                for t in (tasks_u, tasks_v))
        return run_rank_row(plan, g, arrays, u, v)

    return census


def distributed_triad_census(g, mesh=None, *,
                             weight_model: str = "canonical_uniform",
                             strategy: str = "sorted_snake",
                             batch: int = 256, K: "int | None" = None):
    """Partition, balance and run the census over every rank of ``mesh``
    (``None``: the plan's default mesh) on ``g``'s device.

    .. deprecated:: a shim over :mod:`repro_torch.engine`
       (``CensusConfig(backend="distributed")``).  Returns ``(CensusResult,
       task_stats)``, ``task_stats`` the per-rank load summary
       (:class:`~repro_torch.engine.backends.TaskStats`: ``.weights``,
       ``.imbalance``, not the task arrays)."""
    from ..engine import CensusConfig, compile_census

    warnings.warn(
        "repro_torch.core.distributed.distributed_triad_census is "
        "deprecated; use repro_torch.engine.compile_census with "
        "CensusConfig(backend='distributed')",
        DeprecationWarning, stacklevel=2)
    cfg = CensusConfig(backend="distributed", batch=batch, k=K,
                       strategy=strategy, weight_model=weight_model,
                       device=str(g.device))
    plan = compile_census(g, cfg, mesh=mesh)
    res = plan.run(g)
    return res, plan.last_task_stats
