"""Mixture-of-Experts with static-capacity balanced dispatch.

Counterpart of :mod:`repro.models.moe`, with the same arithmetic: a router
picks ``top_k`` experts a token (softmax in f32, gates renormalised), each
(token, slot) pair gets a slot in its expert's capacity queue by a stable
sort of the expert ids (:func:`positions_in_expert`), pairs past the
capacity are dropped, the kept tokens are scattered into one ``(G, E, C,
d)`` buffer (:func:`dispatch`), every expert's SwiGLU runs as a batched
product over it, and the outputs are gathered back and summed with the
gates (:func:`combine`).  Shared experts run on every token; the Switch
load-balancing loss is returned beside the output.

The expert stacks stay in the JAX package's layout, ``w_gate``/``w_up``
``(E, d, f)`` and ``w_down`` ``(E, f, d)``, as parameters (no
``nn.Linear``), and the router is ``(d, E)``.  The scatter, the expert
products and the gather are torch ops: the JAX package has no Pallas
kernel here.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.base import ModelConfig
from ..sharding.rules import axis_sizes, local_box, placements, run_local
from .layers import MLP, mlp_defs
from .params import ParamDef, prefixed


def moe_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    mo = cfg.moe
    d = cfg.d_model
    defs = {
        "router": ParamDef((d, mo.n_experts), ("embed", None)),
        "w_gate": ParamDef((mo.n_experts, d, mo.d_ff_expert),
                           ("experts", "expert_embed", "expert_ff")),
        "w_up": ParamDef((mo.n_experts, d, mo.d_ff_expert),
                         ("experts", "expert_embed", "expert_ff")),
        "w_down": ParamDef((mo.n_experts, mo.d_ff_expert, d),
                           ("experts", "expert_ff", "expert_embed")),
    }
    if mo.n_shared_experts:
        defs.update(prefixed(mlp_defs(d, mo.d_ff_shared * mo.n_shared_experts),
                             "shared/"))
    return defs


def positions_in_expert(expert_ids: torch.Tensor) -> torch.Tensor:
    """Slot of each (token, slot) pair in its expert's capacity queue.

    ``expert_ids`` (..., n) int: pairs in token-major order along the last
    dim (a leading dim is a group, sorted on its own).  A stable sort by
    expert keeps the token order inside an expert, so the pairs dropped at
    capacity are the same as in the JAX package; a running maximum of the
    segment starts gives each pair its offset in its expert's run.
    """
    n = expert_ids.shape[-1]
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    sorted_e = torch.gather(expert_ids, -1, order)
    idx = torch.arange(n, device=expert_ids.device).expand_as(order)
    seg_start = torch.ones_like(sorted_e, dtype=torch.bool)
    seg_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_base = torch.cummax(torch.where(seg_start, idx, 0), dim=-1).values
    return torch.empty_like(order).scatter_(-1, order, idx - seg_base)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens (the JAX rule)."""
    mo = cfg.moe
    return max(1, int(math.ceil(n_tokens * mo.top_k / mo.n_experts
                                * mo.capacity_factor)))


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router of ``x`` (..., d): ``(probs (..., E) f32, gates (..., k) f32
    renormalised to sum 1, expert ids (..., k))``."""
    probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    gate, ids = torch.topk(probs, top_k, dim=-1)
    return probs, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9), ids


def aux_parts(cfg: ModelConfig, probs: torch.Tensor, ids: torch.Tensor,
              n_tok: int, shards: int = 1):
    """The Switch loss's two per-expert means over all ``n_tok`` routed
    tokens, from the ``probs`` and ``ids`` of some of them: ``(sum of
    probs / n_tok, their top-k counts / (n_tok * top_k))``, both (E,) f32
    and each divided by ``shards``, so that the parts of every token's
    shard (and of each of ``shards`` ranks routing the same tokens) sum
    to the global means (:func:`switch_aux`)."""
    mo = cfg.moe
    flat = ids.reshape(-1)
    rows = probs.reshape(-1, mo.n_experts)
    me = (rows.mean(0) if shards == 1 and rows.shape[0] == n_tok
          else rows.sum(0) / n_tok / shards)
    ce = torch.zeros(mo.n_experts, dtype=torch.float32, device=probs.device)
    ce.index_add_(0, flat, torch.full(flat.shape,
                                      1.0 / (n_tok * mo.top_k * shards),
                                      device=probs.device))
    return me, ce


def switch_aux(cfg: ModelConfig, me: torch.Tensor,
               ce: torch.Tensor) -> torch.Tensor:
    """The Switch-style load-balancing loss over all tokens (f32 scalar)
    from :func:`aux_parts`' global means."""
    mo = cfg.moe
    return mo.n_experts * torch.sum(me * ce) * mo.router_aux_weight


def dispatch(xg: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, n_experts: int, C: int) -> torch.Tensor:
    """The capacity buffer: ``xg`` (G, n, d) tokens, their (G, n, k) expert
    ids, slots and keep mask -> (G * E * C, d), every kept pair's token in
    its (group, expert, slot) row and zeros elsewhere.  The rows are
    distinct, so the scatter is a plain copy; a dropped pair is masked
    out (JAX sends it out of range, ``mode="drop"``)."""
    G, n, d = xg.shape
    g_idx = torch.arange(G, device=xg.device)[:, None, None]
    buf = torch.zeros((G * n_experts * C, d), dtype=xg.dtype,
                      device=xg.device)
    rows = (g_idx * n_experts + ids) * C + pos
    buf[rows[keep]] = xg[:, :, None, :].expand(G, n, ids.shape[-1], d)[keep]
    return buf


def combine(out: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
            keep: torch.Tensor, gate: torch.Tensor, n_experts: int,
            C: int) -> torch.Tensor:
    """The tokens' outputs from the (G * E * C, d) expert outputs: each
    pair's slot weighted by its gate (0 where dropped), summed slot by
    slot in the JAX order -> (G, n, d)."""
    G, n, k = ids.shape
    g_idx = torch.arange(G, device=out.device)[:, None, None]
    rows = (g_idx * n_experts + ids) * C + pos.clamp(max=C - 1)
    w = torch.where(keep, gate, 0.0).to(out.dtype)
    y = torch.zeros((G, n, out.shape[-1]), dtype=out.dtype,
                    device=out.device)
    for s in range(k):
        y = y + out[rows[..., s]] * w[..., s, None]
    return y


def expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Every expert's SwiGLU on its slots: ``buf`` (..., E, C, d) with
    weights (E, d, f), (E, d, f), (E, f, d) -> (..., E, C, d)."""
    dtype = buf.dtype
    g = torch.einsum("...ecd,edf->...ecf", buf, w_gate.to(dtype))
    u = torch.einsum("...ecd,edf->...ecf", buf, w_up.to(dtype))
    return torch.einsum("...ecf,efd->...ecd", F.silu(g) * u,
                        w_down.to(dtype))


class MoE(nn.Module):
    """Routed experts (+ shared experts): JAX's ``moe_apply`` as a module.

    ``router`` (d, E) and the expert stacks are parameters in the JAX
    layout; ``shared`` is an :class:`~repro_torch.models.layers.MLP` of
    width ``n_shared_experts * d_ff_shared``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        mo, d = cfg.moe, cfg.d_model
        self.cfg = cfg
        self.router = nn.Parameter(torch.empty(d, mo.n_experts))
        self.w_gate = nn.Parameter(torch.empty(mo.n_experts, d,
                                               mo.d_ff_expert))
        self.w_up = nn.Parameter(torch.empty(mo.n_experts, d, mo.d_ff_expert))
        self.w_down = nn.Parameter(torch.empty(mo.n_experts, mo.d_ff_expert,
                                               d))
        if mo.n_shared_experts:
            self.shared = MLP(d, mo.d_ff_shared * mo.n_shared_experts)

    def forward(self, x: torch.Tensor, groups: Optional[int] = None,
                dense_eval: bool = False, shard=None):
        return moe_apply(self, x, groups=groups, dense_eval=dense_eval,
                         shard=shard)


def moe_apply(moe: MoE, x: torch.Tensor, groups: Optional[int] = None,
              dense_eval: bool = False, shard=None):
    """x (B, T, d) -> ``(y (B, T, d), aux)``, as JAX's ``moe_apply``.

    ``groups=None`` is one flat capacity buffer over all B * T tokens;
    ``groups=G`` splits the tokens into G groups, each with its own sort
    and its own capacity (GShard).  ``dense_eval`` runs every expert on
    every token and combines with the zero-masked gate matrix: no
    capacity, no drops.  Dropped pairs (past the capacity) add nothing:
    they are masked out of the scatter and their gate is 0 in the gather.

    Under ``shard=(mesh, rules)`` (DTensors) the routed body runs once per
    rank through ``local_map`` (:func:`_routed`): every model rank routes
    the same tokens and computes its own experts' part (``"expert"``
    mode: experts on the model axis, an uneven split as DTensor splits
    it) or every expert's part over its own slice of each expert's ffn
    (``"tensor"`` mode), the expert weights' FSDP shards gathered first;
    the output leaves as a partial sum over the model axis, reduced into
    the residual's placement.  An uneven split can leave a rank no
    expert (40 over 16 ranks: 3 each, then 1, then none): its part is 0.  The capacity, the sort and the drops are
    JAX's whatever the layout: a data shard routes its own rows only
    where its rows are whole groups (``groups`` a multiple of the batch
    shards); otherwise every rank routes all B * T tokens (gathered over
    the batch axes).  The aux loss's means are reduced over every rank
    that routed a share of the tokens, then combined: the global loss."""
    cfg = moe.cfg
    mo = cfg.moe
    B, T, d = x.shape
    n_tok = B * T
    G = groups or 1
    if n_tok % G:
        raise ValueError(f"{n_tok} tokens do not split into {G} groups")
    ins = [("batch", "seq", None), (None, None),
           ("experts", None, "expert_ff"), ("experts", None, "expert_ff"),
           ("experts", "expert_ff", None)]
    split, shards, e0 = ("batch", "model"), 1, 0
    if shard is not None:
        mesh, rules = shard
        sizes = axis_sizes(mesh)
        b_axes = rules.table["batch"] or ()
        b_axes = (b_axes,) if isinstance(b_axes, str) else b_axes
        dp = math.prod(sizes[a] for a in b_axes)
        if G % dp:  # a group spans data shards: route every token
            ins[0], split, dp = (None, "seq", None), ("model",), 1
        G //= dp
        shards = sizes.get("model", 1)
        e0 = local_box(tuple(moe.w_gate.shape), mesh, placements(
            mesh, rules, ins[2]))[0][0]
    out = ("partial",) + ins[0]
    y, me, ce = run_local(
        functools.partial(_routed, cfg, G, n_tok, e0, shards, dense_eval),
        shard, tuple(ins), [out, ("partial", None), ("partial", None)],
        x, moe.router, moe.w_gate, moe.w_up, moe.w_down, split=split)
    if shard is not None:  # the partial means reduced (a collective each)
        me, ce = me.full_tensor(), ce.full_tensor()
    aux = switch_aux(cfg, me, ce)
    if mo.n_shared_experts:
        y = y + moe.shared(x)
    return y, aux


def _routed(cfg: ModelConfig, groups: int, n_tok: int, e0: int, shards: int,
            dense_eval: bool, x, router, w_gate, w_up, w_down):
    """The routed experts on plain tensors (one rank's part under a
    mesh): x (B, T, d) in ``groups`` groups, routed over all E experts by
    ``router`` (d, E); the expert stacks hold experts ``e0`` onward (all
    of them, or the rank's own) and all of each one's ffn or a slice of
    it.  Returns ``(y (B, T, d): the sum over these experts and ffn
    columns, the aux loss's two parts over ``n_tok`` tokens, divided by
    ``shards``)`` (:func:`aux_parts`)."""
    mo = cfg.moe
    B, T, d = x.shape
    dtype = x.dtype
    ng = B * T // groups
    xg = x.reshape(groups, ng, d)
    probs, gate_vals, expert_ids = route(xg, router, mo.top_k)
    me, ce = aux_parts(cfg, probs, expert_ids, n_tok, shards)
    n_local = w_gate.shape[0]
    if dense_eval:
        gates = torch.zeros((groups, ng, mo.n_experts), dtype=dtype,
                            device=x.device)
        for s in range(mo.top_k):
            gates.scatter_add_(-1, expert_ids[..., s:s + 1],
                               gate_vals[..., s:s + 1].to(dtype))
        gates = gates[..., e0:e0 + n_local]
        h_g = torch.einsum("gnd,edf->gnef", xg, w_gate.to(dtype))
        h_u = torch.einsum("gnd,edf->gnef", xg, w_up.to(dtype))
        y = torch.einsum("gnef,efd,gne->gnd", F.silu(h_g) * h_u,
                         w_down.to(dtype), gates)
    elif n_local == 0:  # an uneven split leaves the last ranks no expert
        y = torch.zeros_like(xg)
    else:
        C = capacity(ng, cfg)
        pos = positions_in_expert(expert_ids.reshape(groups, ng * mo.top_k)
                                  ).reshape(groups, ng, mo.top_k)
        keep, local_ids = pos < C, expert_ids
        if n_local < mo.n_experts:  # this rank's experts only
            keep = keep & (expert_ids >= e0) & (expert_ids < e0 + n_local)
            local_ids = (expert_ids - e0).clamp(0, n_local - 1)
        buf = dispatch(xg, local_ids, pos, keep, n_local, C)
        out = expert_ffn(buf.view(groups, n_local, C, d), w_gate, w_up,
                         w_down).reshape(-1, d)
        y = combine(out, local_ids, pos, keep, gate_vals, n_local, C)
    return y.reshape(B, T, d), me, ce
