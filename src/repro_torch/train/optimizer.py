"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule,
and the int8 gradient round trip.

Counterpart of :mod:`repro.train.optimizer`, with the same arithmetic in
f32: the schedule and the bias corrections as f32 scalars (numpy, as
JAX's f32 arrays), the moments f32 tensors.  Unlike JAX's pure update,
:func:`adamw_update` writes the new values into the parameters and the
moments in place (and scales the gradients in place when it clips), so a
step holds no second copy of the model.  Trees are dicts keyed by the
module's parameter names; the decay mask reads each name's JAX key
(:func:`repro_torch.models.convert.jax_key_of`), since the JAX names
(``mu_``, ``/u``, ``/D``, ``A_log``, ``dt_bias``) are what it matches.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..config.base import RunConfig
from ..models.convert import jax_key_of
from ..sharding.rules import is_dtensor, local_box, placed_as

#: temporaries of one foreach group of the update, in elements (1 GiB f32)
_GROUP_ELEMS = 2**28


class OptState(NamedTuple):
    step: int  # updates taken
    m: dict  # name -> f32 first moment
    v: dict  # name -> f32 second moment


def adamw_init(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero f32 moments of each parameter's shape, on its device (a
    DTensor parameter's moments are DTensors placed as it is)."""
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                for k, p in params.items()}

    return OptState(step=0, m=zeros(), v=zeros())


def cosine_schedule(step, base_lr, warmup=100, total=10_000, min_frac=0.1):
    """JAX's schedule in f32: linear warmup to ``base_lr``, then a cosine
    down to ``min_frac * base_lr`` at ``total``.  Returns an f32 scalar."""
    f32 = np.float32
    step, base_lr = f32(step), f32(base_lr)
    warm = base_lr * step / f32(warmup)
    prog = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0), f32(1))
    cos = f32(min_frac) + f32(1 - min_frac) * f32(0.5) * (
        f32(1) + np.cos(f32(np.pi) * prog))
    return warm if step < warmup else base_lr * cos


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor on
    the leaves' device).  DTensor leaves give the norm of the whole
    tensors, the same on every rank (:func:`_sharded_norm`)."""
    leaves = list(tree.values())
    if leaves and is_dtensor(leaves[0]):
        return _sharded_norm(leaves)
    norms = torch._foreach_norm([g.float() for g in leaves])
    return torch.linalg.vector_norm(torch.stack(norms))


def _sharded_norm(leaves) -> torch.Tensor:
    """The global norm of DTensor leaves placed on one mesh (``Shard`` or
    ``Replicate`` on each dim): each rank sums the squares of its shards,
    each divided by its copies (the product of the mesh dims it is
    replicated over), and one all-reduce per mesh dim adds them up."""
    import torch.distributed as dist

    mesh = leaves[0].device_mesh
    sq = []
    for g in leaves:
        copies = 1
        for size, pl in zip(mesh.shape, g.placements):
            if pl.is_partial():
                raise ValueError("a partial gradient: place it first")
            copies *= size if pl.is_replicate() else 1
        sq.append(g.to_local().float().square().sum() / copies)
    total = torch.stack(sq).sum()
    for dim in range(mesh.ndim):
        if mesh.shape[dim] > 1:
            dist.all_reduce(total, group=mesh.get_group(dim))
    return total.sqrt()


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Scale ``grads`` in place by ``min(1, max_norm / norm)``; returns
    ``(grads, norm)``.  The scale stays on the device (no sync)."""
    norm = global_norm(grads)
    scale = (max_norm / norm.clamp(min=1e-9)).clamp(max=1.0)
    torch._foreach_mul_(list(_local(grads).values()), scale)
    return grads, norm


_NO_DECAY_SUBSTRINGS = ("ln", "norm", "bias", "b_", "/b", "mu_", "A_log",
                        "dt_bias", "/u", "/D")


def _decay_mask(path: str) -> bool:
    """Whether the JAX key ``path`` takes weight decay (JAX's rule)."""
    return not any(s in path for s in _NO_DECAY_SUBSTRINGS)


def _groups(names, params):
    """``names`` split into runs of at most ``_GROUP_ELEMS`` elements (a
    larger tensor alone), bounding the update's temporaries."""
    group, size = [], 0
    for k in names:
        n = params[k].numel()
        if group and size + n > _GROUP_ELEMS:
            yield group
            group, size = [], 0
        group.append(k)
        size += n
    if group:
        yield group


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt: OptState,
                 run: RunConfig, *, total_steps: int = 10_000,
                 warmup: int = 100):
    """One AdamW step, as JAX's: clip the gradients by global norm
    (``run.grad_clip``), then for each parameter

        m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
        upd = (m / bc1) / (sqrt(v / bc2) + 1e-8) [+ wd * p where decayed]
        p = p - lr * upd

    with ``lr`` from :func:`cosine_schedule` at the new step.  ``params``
    are updated in place, and so are ``opt``'s moments and the gradients
    (clipped).  Returns ``(opt, {"grad_norm": 0-d tensor, "lr": float})``.

    DTensor parameters (and moments placed as them): each gradient is
    first placed as its parameter (:func:`~repro_torch.sharding.rules.
    placed_as`), the clip norm is the global one, and the update runs on
    each rank's local shards.
    """
    if any(is_dtensor(p) for p in params.values()):
        grads = {k: placed_as(grads[k], params[k]) for k in params}
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    params, grads = _local(params), _local(grads)
    m_all, v_all = _local(opt.m), _local(opt.v)
    step = opt.step + 1
    lr = cosine_schedule(step, run.learning_rate, total=total_steps,
                         warmup=warmup)
    f32 = np.float32
    b1, b2 = run.adam_b1, run.adam_b2
    bc1 = float(f32(1) - f32(b1) ** f32(step))
    bc2 = float(f32(1) - f32(b2) ** f32(step))
    for names in _groups(list(params), params):
        p = [params[k] for k in names]
        p32 = [t if t.dtype == torch.float32 else t.float() for t in p]
        g = [grads[k].float() for k in names]
        m = [m_all[k] for k in names]
        v = [v_all[k] for k in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        decayed = [i for i, k in enumerate(names)
                   if _decay_mask(jax_key_of(k))]
        if decayed and run.weight_decay:
            torch._foreach_add_([upd[i] for i in decayed],
                                [p32[i] for i in decayed],
                                alpha=run.weight_decay)
        torch._foreach_add_(p32, upd, alpha=-float(lr))
        for t, t32 in zip(p, p32):
            if t is not t32:
                t.copy_(t32)
    return OptState(step=step, m=opt.m, v=opt.v), {"grad_norm": gnorm,
                                                   "lr": float(lr)}


def _local(tree: Mapping[str, torch.Tensor]) -> dict:
    """Each DTensor leaf's local shard (an alias: in-place ops write
    through), other leaves as they are."""
    return {k: t.to_local() if is_dtensor(t) else t for k, t in tree.items()}


def compress_grads_int8(grads: Mapping[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Mapping[str, torch.Tensor]] = None,
                        *, slots: Optional[Mapping[str, tuple]] = None
                        ) -> dict:
    """Per-tensor int8 quantization round trip with stochastic rounding,
    as JAX's: ``scale = max(|g|) / 127`` (at least 1e-12 / 127), ``q =
    clip(round(g / scale + noise), -127, 127)`` as int8, back to
    ``q * scale`` in f32.

    ``noise`` (uniform on [-0.5, 0.5)), unless given, is a hash of a seed
    (one draw from ``generator``), the JAX key and each element's flat
    index in the key's JAX layout (:func:`_noise`): a function of where
    the element sits in the key, not of how the key is split, so every
    split (a stack's slices, a rank's block) gets the same numbers and
    each rank makes only its own block's.  JAX draws its noise with
    ``jax.random``, whose bits torch cannot reproduce, so a parity check
    hands both the same noise, each key's whole array by JAX key.

    ``slots`` (name -> ``(key, index or None, transposed)``, as
    :func:`repro_torch.models.convert.jax_slot` gives for the module's
    parameter names) makes each JAX key one tensor, as JAX's round trip
    sees it: one scale over every slice of a ``layers/`` stack, and each
    element's noise at its place in the whole key.  Without it each
    entry is its own key.

    A DTensor gradient (``Shard`` or ``Replicate`` placements) takes the
    round trip on its local block, with the whole key's ``max(|g|)`` (an
    all-reduce) and its block's noise: the result is the unsharded round
    trip's, placed as ``g``."""
    slots = slots or {k: (k, None, False) for k in grads}
    members: dict = {}
    for name in grads:
        members.setdefault(slots[name][0], []).append(name)
    seed = None
    if noise is None:
        seed = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                             device=generator.device if generator
                             is not None else "cpu")
    out = {}
    for key in sorted(members):
        names = members[key]
        amax = None
        for name in names:
            g = grads[name]
            loc = g.to_local() if is_dtensor(g) else g
            m = (loc.detach().float().abs().max() if loc.numel()
                 else loc.new_zeros((), dtype=torch.float32))
            if is_dtensor(g):
                m = _mesh_max(m, g.device_mesh)
            amax = m if amax is None else torch.maximum(amax, m)
        scale = amax.clamp(min=1e-12) / 127.0
        for name in names:
            g = grads[name].float()
            _, idx, transposed = slots[name]
            sharded = is_dtensor(g)
            loc = g.to_local() if sharded else g
            box = (local_box(tuple(g.shape), g.device_mesh, g.placements)
                   if sharded else [(0, n) for n in g.shape])
            if noise is not None:
                n = noise[key].to(loc.device, torch.float32)
                n = n[idx] if idx is not None else n
                n = n.T if transposed else n
                n = n[tuple(slice(o, o + k) for o, k in box)]
            else:
                n = _noise(seed.to(loc.device), key, tuple(g.shape), idx,
                           transposed, box)
            q = _round_trip(loc, scale.to(loc.device), n)
            if sharded:
                from torch.distributed.tensor import DTensor

                q = DTensor.from_local(q, g.device_mesh, g.placements,
                                       shape=g.shape, stride=g.stride())
            out[name] = q
    return out


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), in halves so
    no product passes 2**48."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (an invertible mix of [0, 2**32))."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _noise(seed: torch.Tensor, key: str, shape: tuple, idx, transposed,
           box) -> torch.Tensor:
    """Uniform f32 noise on [-0.5, 0.5) with 24 random bits, on
    ``seed``'s device, for the block ``box`` (``[(offset, length)]`` per
    dim) of a ``shape`` gradient that is slice ``idx`` (None: the whole)
    of JAX key ``key``, transposed from the JAX layout or not: a hash of
    the two ``seed`` words, the key's CRC-32 and each element's flat index
    in the key's JAX layout."""
    import zlib

    jshape = tuple(reversed(shape)) if transposed else tuple(shape)
    if idx is not None:
        jshape = (0, *jshape)  # the stack's length never enters a stride
    strides = [int(np.prod(jshape[d + 1:])) for d in range(len(jshape))]
    lead = 1 if idx is not None else 0
    flat = torch.full((), (idx or 0) * (strides[0] if lead else 0),
                      dtype=torch.int64, device=seed.device)
    nd = len(box)
    for d, (off, n) in enumerate(box):
        jd = lead + (nd - 1 - d if transposed else d)
        view = [1] * nd
        view[d] = n
        flat = flat + (torch.arange(off, off + n, dtype=torch.int64,
                                    device=seed.device)
                       * strides[jd]).view(view)
    h = _mix32(_mix32(seed[0] ^ zlib.crc32(key.encode())) ^ seed[1])
    h = _mix32(_mix32((flat >> 32) ^ h) ^ (flat & _M32))
    return (h >> 8).float() * 2.0**-24 - 0.5


def _round_trip(g, scale, noise):
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale


def _mesh_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The max of the 0-d ``x`` over every rank of ``mesh``."""
    import torch.distributed as dist

    x = x.clone()
    for dim in range(mesh.ndim):
        if mesh.shape[dim] > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(dim))
    return x
