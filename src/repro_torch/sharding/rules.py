"""Logical-axis sharding rules for a ``torch.distributed`` device mesh.

Counterpart of :mod:`repro.sharding.rules`.  Mesh axes are ``("data",
"model")`` on one pod and ``("pod", "data", "model")`` across pods
(``pod`` is an outer data axis).  A *spec* is what JAX's
``PartitionSpec`` holds: a tuple with one entry per tensor dim, each a
mesh-axis name, a tuple of names (the dim split over all of them, the
first outermost) or ``None`` (replicated).  :func:`placements` turns a
spec into DTensor placements, one per mesh dim: ``Shard(d)`` where the
spec names that mesh dim at tensor dim ``d``, else ``Replicate()``.

The rule table only reads the mesh's axis names, so :func:`make_rules`
takes a :class:`~torch.distributed.device_mesh.DeviceMesh` or a mesh-shape
dict such as ``{"data": 16, "model": 16}``: the table and the dry runs
need no process group.

Projection weights keep their output features flattened (``H * hd``), as
in JAX.  A ``Shard`` of such a dim splits it at ``ceil(dim / s)``, so the
attention core's head split (:func:`repro_torch.models.attention.
head_shards`) checks that the heads divide the model axis: unlike JAX's
GSPMD, a ``local_map`` cannot pad a head.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch

MeshLike = Union["torch.distributed.device_mesh.DeviceMesh", Mapping[str, int]]


def axis_names(mesh: MeshLike) -> tuple:
    """The mesh's axis names, in order."""
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh: MeshLike) -> dict:
    """``{axis name: size}`` of a mesh or a mesh-shape dict."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh: MeshLike) -> tuple:
    """Mesh axes that jointly shard the batch (pod is an outer data
    axis)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> mesh axis, tuple of axes, or None
    (replicated)."""

    table: dict

    def spec(self, logical: tuple) -> tuple:
        return tuple(self.table.get(ax) for ax in logical)


def make_rules(mesh: MeshLike, *, fsdp_axis: Optional[str] = "data",
               expert_sharding: str = "expert",
               batch_shardable: bool = True, seq_shard_kv: bool = False,
               vocab_shardable: bool = True,
               act_shard_model: bool = False) -> Rules:
    """The rule table for this mesh, JAX's exactly.

    ``expert_sharding="expert"`` places experts on the model axis;
    ``"tensor"`` replicates the expert dim and splits each expert's ffn.
    ``seq_shard_kv`` shards decode caches' sequence over the batch axes;
    ``vocab_shardable=False`` replicates the embedding tables (the
    logits still shard by constraint); ``act_shard_model`` shards the
    residual stream's features over the model axis as well."""
    b_mesh = batch_axes(mesh)
    b_axes = b_mesh if batch_shardable else None
    table = {
        None: None,
        "batch": b_axes,
        "seq": None,
        "kv_seq": b_mesh if seq_shard_kv else None,
        "mla_seq": "model",  # compressed-KV decode: cache over seq
        "embed": fsdp_axis,  # weight in-features (FSDP / ZeRO-3 axis)
        "ff": "model",
        "heads_flat": "model",
        "kv_flat": "model",
        "vocab": "model" if vocab_shardable else None,
        "logit_vocab": "model",
        "lora": None,
        "state": None,
        "layers": None,
        "act_embed": "model" if act_shard_model else None,
        "experts": "model" if expert_sharding == "expert" else None,
        "expert_ff": None if expert_sharding == "expert" else "model",
        "expert_embed": fsdp_axis,
    }
    return Rules(table=table)


def logical_to_spec(rules: Rules, logical: tuple) -> tuple:
    return rules.spec(logical)


def spec_placements(names: tuple, spec: tuple) -> list:
    """DTensor placements over mesh axes ``names`` for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for ax in (entry,) if isinstance(entry, str) else entry or ():
            if ax in names:
                out[names.index(ax)] = Shard(dim)
    return out


def mesh_placements(mesh: MeshLike, spec: tuple) -> list:
    """:func:`spec_placements` on ``mesh``; on a live ``DeviceMesh`` a dim
    of one rank replicates (its one shard is the whole tensor, and
    DTensor's view rules take a dim of size 1 sharded over it for one to
    drop: B 1 on a data axis of 1 would not flatten into a matmul)."""
    out = spec_placements(axis_names(mesh), spec)
    if isinstance(mesh, Mapping):
        return out
    from torch.distributed.tensor import Replicate

    return [Replicate() if n == 1 else p for n, p in zip(mesh.shape, out)]


def placements(mesh: MeshLike, rules: Rules, logical: tuple) -> list:
    """DTensor placements (one per mesh dim) of a tensor whose dims have
    the ``logical`` axes: the counterpart of JAX's ``named_sharding``
    (:func:`mesh_placements`)."""
    return mesh_placements(mesh, rules.spec(logical))


def shard_shape(shape: tuple, sizes: Mapping[str, int], spec: tuple) -> tuple:
    """The largest rank's local shape of a ``shape`` tensor placed by
    ``spec`` on a mesh of ``sizes``: a dim split ``s`` ways holds
    ``ceil(dim / s)``, as a DTensor ``Shard`` splits it."""
    out = []
    for n, entry in zip(shape, spec):
        for ax in (entry,) if isinstance(entry, str) else entry or ():
            n = -(-n // sizes.get(ax, 1))
        out.append(n)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated_like(t: torch.Tensor, like) -> "torch.Tensor":
    """``t`` (the same on every rank) as a DTensor replicated over the
    DTensor ``like``'s mesh, so it can meet ``like`` in an op."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x, mesh, rules: Optional[Rules], logical: tuple):
    """``x`` redistributed to ``logical``'s placements: the counterpart of
    JAX's ``with_sharding_constraint`` by logical names.  A no-op on a
    plain tensor or without a mesh or rules.

    As in JAX, the constraint holds for the gradient too: a hook places
    the gradient arriving here as ``logical`` says, so a partial sum is
    reduced here.  Without it a partial gradient reaching the redistribute
    of a vocab-sharded embedding's output (a masked partial) cannot be
    converted."""
    if mesh is None or rules is None or not is_dtensor(x):
        return x
    want = placements(mesh, rules, logical)
    if list(x.placements) != want:
        x = x.redistribute(mesh, want)
    if x.requires_grad:
        x.register_hook(lambda g: g if list(g.placements) == want
                        else g.redistribute(mesh, want))
    return x


def distribute(x: torch.Tensor, mesh, rules: Rules, logical: tuple):
    """``x`` placed by ``logical`` on ``mesh``: a plain tensor (the same
    whole tensor on every rank, as a seeded batch is) becomes a DTensor
    by each rank keeping its own slice, no collective; a DTensor is
    redistributed (:func:`constrain`)."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(x):
        return constrain(x, mesh, rules, logical)
    return distribute_tensor(x, mesh, placements(mesh, rules, logical),
                             src_data_rank=None)


def gathered(w):
    """A DTensor weight with its shards over the batch axes (the FSDP
    axis) gathered, as FSDP holds a weight while a layer uses it; any
    other tensor as it is.  Fixing the weight's placement before the op
    leaves DTensor one way to run it (a tensor-parallel matmul over the
    model axis, the batch rows on the batch axes); its backward
    reduce-scatters the gradient back to the FSDP shards."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    want = [Replicate() if n in ("pod", "data") else p
            for n, p in zip(names, w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def local_box(shape: tuple, mesh, placements) -> list:
    """``[(offset, length)]`` per dim of the block of a ``shape`` tensor
    that this rank holds under ``placements`` on ``mesh``: each
    ``Shard(d)``, in mesh-dim order, splits what is left of dim ``d`` into
    chunks of ``ceil(n / s)``, as DTensor splits it (the last ranks may
    hold less, or nothing)."""
    from torch.distributed.tensor import Shard

    box = [(0, n) for n in shape]
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            off, n = box[p.dim]
            size = -(-n // mesh.shape[m])
            start = min(coord[m] * size, n)
            box[p.dim] = (off + start, min(size, n - start))
    return box


def local_part(x, mesh, placements):
    """This rank's block (:func:`local_box`) of the whole tensor or numpy
    array ``x``: a view, nothing read."""
    return x[tuple(slice(o, o + n) for o, n in
                   local_box(tuple(x.shape), mesh, placements))]


def from_whole(x, mesh, placements, device=None, dtype=None):
    """The whole tensor or numpy array ``x`` (the same on every rank; an
    array may map a file) as a DTensor on ``mesh`` placed by
    ``placements``: each rank copies only its own block to ``device``
    (default: the mesh's device type) in ``dtype`` (default: ``x``'s), no
    collective.  The result never
    shares ``x``'s storage."""
    part = local_part(x, mesh, placements)
    if not isinstance(part, torch.Tensor):
        import numpy as np

        part = torch.from_numpy(np.array(part))
    local = part.to(device=device or mesh.device_type, dtype=dtype,
                    copy=True, memory_format=torch.contiguous_format)
    return _placed_block(local, tuple(x.shape), mesh, placements)


def _placed_block(local, shape: tuple, mesh, placements):
    """The DTensor of global ``shape`` (contiguous) whose block on this
    rank is ``local``."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def model_shards(mesh, n: int, what: str) -> int:
    """The model axis's size, checked to split ``n`` (heads, say) evenly:
    a rank then holds whole ones.  JAX pads an uneven split (GSPMD); a
    ``local_map`` cannot, so this raises naming ``what``."""
    model = axis_sizes(mesh).get("model", 1)
    if n % model:
        raise ValueError(f"{what}: {n} do not split evenly over a model "
                         f"axis of {model}")
    return model


def _contiguous(grad: torch.Tensor) -> torch.Tensor:
    """A local gradient leaving ``local_map`` made contiguous: einsums
    return permuted gradients, and the DTensor ``view`` of a projection's
    backward cannot take one whose strides swap two dims of equal size."""
    return grad.contiguous()


def run_local(fn, shard, ins: tuple, outs, *args,
              split: tuple = ("batch", "model")):
    """``fn(*args)`` on each rank's own blocks: without a mesh (``shard``
    None) ``fn`` itself on the plain tensors; under ``shard=(mesh,
    rules)`` through ``local_map``, each tensor argument redistributed to
    the placements of its logical axes in ``ins`` (a replicated tensor to
    a ``Shard`` is a local slice, no collective) and each output a DTensor
    placed by its logical axes in ``outs`` (one tuple for one output, a
    list of them for a tuple of outputs; a tuple led by ``"partial"``:
    placed by the rest of it, but a partial sum over each axis of
    ``split`` that the rest leaves whole).

    ``split`` names what the work is divided over: ``"model"`` (each rank
    its own heads, experts or ffn slice) and ``"batch"`` (the batch axes,
    when the rules shard the batch: each rank its own rows).  An argument
    whole over such an axis is read by every rank for its own part, so
    its local gradient is a partial sum there (``Partial``), reduced when
    it leaves the map.  A local gradient leaving the map is made
    contiguous (:func:`_contiguous`).  The per-chunk loops of a scan then
    run on plain tensors: each DTensor op costs host dispatch time."""
    if shard is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, rules = shard
    axes = set()
    for what in split:
        entry = rules.table.get(what, what)
        axes.update((entry,) if isinstance(entry, str) else entry or ())
    divided = [n in axes and size > 1
               for n, size in zip(mesh.mesh_dim_names, mesh.shape)]

    def partial(pls):  # whole over a divided axis -> a partial sum there
        return [Partial() if cut and isinstance(p, Replicate) else p
                for cut, p in zip(divided, pls)]

    def place(logical):
        if logical is None:
            return None
        if logical[:1] == ("partial",):
            return partial(placements(mesh, rules, logical[1:]))
        return placements(mesh, rules, logical)

    def grad_place(logical):
        return None if logical is None else partial(place(logical))

    def local(*xs):
        for t in xs:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(_contiguous)
        return fn(*xs)

    out_pl = (tuple(place(o) for o in outs) if isinstance(outs, list)
              else place(outs))
    return local_map(local, out_placements=out_pl,
                     in_placements=tuple(place(i) for i in ins),
                     in_grad_placements=tuple(grad_place(i) for i in ins),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def full_placed(shape: tuple, fill, mesh, placements, *, dtype,
                device=None):
    """A ``shape`` tensor of ``fill`` as a DTensor on ``mesh`` placed by
    ``placements``: each rank makes only its own block (:func:`local_box`),
    no collective."""
    box = local_box(tuple(shape), mesh, placements)
    local = torch.full(tuple(n for _, n in box), fill, dtype=dtype,
                       device=device or mesh.device_type)
    return _placed_block(local, tuple(shape), mesh, placements)


def write_into(leaf, value, dim: int = 0, start: int = 0):
    """``leaf[..., start:start + n, ...] = value`` along ``dim`` (n =
    ``value.shape[dim]``), in place: the cache write.  On a DTensor
    ``leaf`` (a cache placed by its logical axes) ``value`` is placed as
    the leaf but whole along ``dim`` (a collective only where it differs:
    a partial sum reduced, heads gathered where the leaf replicates
    them), and each rank writes the part of ``[start, start + n)`` that
    falls in its own block of ``dim`` (:func:`local_box`): a write into a
    cache whose sequence is split over ranks lands in the rank, or the
    ranks, holding those slots.  DTensor has no sliced assignment on a
    sharded dim.  A write over the whole of ``dim`` (a recurrent state's
    batch) takes ``value`` as the leaf is placed, so each rank keeps its
    own rows and nothing is gathered over the axes that split them."""
    n = value.shape[dim]
    if not is_dtensor(leaf):
        leaf.narrow(dim, start, n).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = leaf.device_mesh
    whole_dim = start == 0 and n == leaf.shape[dim]
    want = (list(leaf.placements) if whole_dim else
            [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in leaf.placements])
    if not is_dtensor(value):
        value = replicated_like(value, leaf)
    if list(value.placements) != want:
        value = value.redistribute(mesh, want)
    if whole_dim:
        leaf.to_local().copy_(value.to_local())
        return
    off, size = local_box(tuple(leaf.shape), mesh, leaf.placements)[dim]
    lo, hi = max(start, off), min(start + n, off + size)
    if lo < hi:
        leaf.to_local().narrow(dim, lo - off, hi - lo).copy_(
            value.to_local().narrow(dim, lo - start, hi - lo))


def check_placed(model, mesh, rules):
    """Raise unless ``model``'s parameters were placed by ``mesh`` and
    ``rules`` (a step built for a mesh meets a model placed on it)."""
    if mesh is not None and (model.mesh is not mesh
                             or model.rules != rules):
        raise ValueError("the step was built for another mesh or rules "
                         "than the model's parameters are placed by")


def placed_as(x, like):
    """The DTensor ``x`` redistributed to the DTensor ``like``'s
    placements (a gradient placed as its parameter: a ``Partial`` sum
    becomes a reduce-scatter or an all-reduce); ``x`` itself otherwise."""
    if not is_dtensor(x) or list(x.placements) == list(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)
