"""Expert-parallel MoE over ``torch.distributed``: explicit all-to-alls.

Counterpart of :mod:`repro.models.moe_expert_parallel` (a ``shard_map``
with ``all_to_all`` there).  SPMD: every rank of the mesh makes the same
calls.  The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with a
``"model"`` dimension (and any others, such as ``"data"``); experts are
split over ``"model"``, ranks of one model group hold the same tokens
(their data shard), and a layer runs:

  1. each model rank takes its ``1/ep`` slice of the local tokens and
     routes only those (routing, sort and scatter are not repeated across
     the model group);
  2. one ``all_to_all_single`` moves the capacity slots from token layout
     to expert layout;
  3. the rank's ``E / ep`` experts run on the slots every rank sent them;
  4. the inverse ``all_to_all_single`` brings the outputs back, the rank
     combines its tokens, and one ``all_gather`` over ``"model"`` restores
     the replicated activation layout.

Cross-rank traffic is two all-to-alls of the capacity buffer and one
all-gather of the output: no all-reduce, no replicated capacity buffer.
:data:`COLLECTIVES` counts each collective issued, in the idiom of
``merge_over_mesh.collectives``.  As in the JAX package, shared experts
and the load-balancing loss are not part of this layer, and the capacity
is each rank's own (``n / ep`` tokens), so it equals :func:`moe_apply`'s
flat dispatch when nothing is dropped (and exactly, drops included, on a
one-rank mesh).
"""
from __future__ import annotations

import collections
import threading

import torch

from ..config.base import ModelConfig
from .moe import (capacity, combine, dispatch, expert_ffn,
                  positions_in_expert, route)

#: collective name -> calls issued by expert-parallel layers
COLLECTIVES: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _COUNT_LOCK:
        COLLECTIVES[name] += 1


def make_expert_parallel_moe(cfg: ModelConfig, mesh):
    """``apply(p, prefix, x) -> y`` for the mesh's ``"model"`` dimension.

    ``p`` is a flat dict with JAX keys: ``prefix + "router"`` (d, E) and
    the expert stacks ``w_gate``, ``w_up`` (E, d, f), ``w_down`` (E, f,
    d), either all E experts (the rank uses its slice, a view) or only
    the rank's ``E / ep``.  ``x`` (B_loc, T, d) is the rank's data shard,
    the same on every rank of its model group; ``y`` has its shape and
    is the same on every rank of the group.  Requires ``n_experts % ep ==
    0`` and ``(B_loc * T) % ep == 0``."""
    import torch.distributed as dist

    mo = cfg.moe
    ep = mesh["model"].size()
    if mo.n_experts % ep:
        raise ValueError(f"{mo.n_experts} experts do not split over {ep} "
                         "model ranks")
    e_loc = mo.n_experts // ep
    group = mesh.get_group("model")
    me = mesh.get_local_rank("model")

    def local_experts(w: torch.Tensor) -> torch.Tensor:
        if w.shape[0] == mo.n_experts:
            return w[me * e_loc:(me + 1) * e_loc]
        if w.shape[0] != e_loc:
            raise ValueError(f"expert stack of {w.shape[0]} experts: want "
                             f"{mo.n_experts} or this rank's {e_loc}")
        return w

    def apply(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
        Bl, T, d = x.shape
        n_all = Bl * T
        if n_all % ep:
            raise ValueError(f"{n_all} local tokens do not split over {ep} "
                             "model ranks")
        n = n_all // ep
        xf = x.reshape(n_all, d)[me * n:(me + 1) * n]
        _, gate, ids = route(xf, p[prefix + "router"], mo.top_k)
        cap = capacity(n, cfg)
        pos = positions_in_expert(ids.reshape(-1)).reshape(1, n, mo.top_k)
        ids, gate = ids[None], gate[None]
        keep = pos < cap
        buf = dispatch(xf[None], ids, pos, keep, mo.n_experts, cap)

        # dispatch: [dest rank, its expert, slot] -> [src rank, ...]
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf, group=group)
        _count("all_to_all")
        slots = recv.view(ep, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, ep * cap, d)
        out = expert_ffn(slots, local_experts(p[prefix + "w_gate"]),
                         local_experts(p[prefix + "w_up"]),
                         local_experts(p[prefix + "w_down"]))
        # combine: the inverse exchange back to the token owners
        send = out.view(e_loc, ep, cap, d).transpose(0, 1).contiguous()
        back = torch.empty_like(send)
        dist.all_to_all_single(back, send, group=group)
        _count("all_to_all")
        y = combine(back.view(mo.n_experts * cap, d), ids, pos, keep, gate,
                    mo.n_experts, cap)[0]
        y_all = torch.empty((n_all, d), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(y_all, y, group=group)
        _count("all_gather")
        return y_all.reshape(Bl, T, d)

    return apply
