"""Device meshes (counterpart of :mod:`repro.launch.mesh`).

:func:`make_mesh_for` builds a live ``DeviceMesh`` over the initialized
process group.  :func:`make_production_mesh` gives the production mesh's
*shape*, ``{"data": 16, "model": 16}`` (``{"pod": 2, "data": 16, "model":
16}`` across pods): a 256-rank process group is not something a dry run
can start, and the rule table and the dry runs read only axis names and
sizes (:func:`repro_torch.sharding.rules.make_rules`).

Every rank of a mesh must hash strings alike (the same ``PYTHONHASHSEED``,
e.g. ``PYTHONHASHSEED=0 torchrun ...``): DTensor enumerates an op's
sharding strategies in the order of a set of placements, whose hashes
follow the seed, and breaks ties between strategies of equal cost by
that order, so ranks that hash differently can choose different
strategies for one op and wait on different collectives for ever.
:func:`make_mesh_for` checks it (:func:`check_same_hash_seed`).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The production mesh's shape, ``{axis: size}`` in mesh order."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_mesh_for(n_devices: int, model_parallel: int = 16,
                  device_type: str = "cuda"):
    """A ``(data, model)`` DeviceMesh over the process group's
    ``n_devices`` ranks, TP degree ``model_parallel`` kept (the data axis
    absorbs the rest, at least 1)."""
    from torch.distributed.device_mesh import init_device_mesh

    check_same_hash_seed()
    data = max(1, n_devices // model_parallel)
    return init_device_mesh(device_type, (data, model_parallel),
                            mesh_dim_names=("data", "model"))


def same_on_every_rank(value) -> bool:
    """Whether every rank of the process group passed an equal ``value``
    (one all-gather of picklable objects: every rank must call)."""
    import torch.distributed as dist

    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, value)
    return all(v == seen[0] for v in seen)


def check_same_hash_seed():
    """Raise unless every rank of the process group hashes strings alike
    (see the module's note); a no-op without a group of more than one
    rank."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if not same_on_every_rank(hash("repro_torch.launch.mesh")):
        raise RuntimeError(
            "the ranks hash strings differently, so DTensor may choose "
            "different sharding strategies on different ranks and hang: "
            "start every rank with the same PYTHONHASHSEED (e.g. "
            "PYTHONHASHSEED=0 torchrun ...)")
