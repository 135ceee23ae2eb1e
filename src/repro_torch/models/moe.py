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

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.base import ModelConfig
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


def switch_aux(cfg: ModelConfig, probs: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss over all tokens (f32 scalar)."""
    mo = cfg.moe
    flat = ids.reshape(-1)
    n_tok = flat.numel() // mo.top_k
    me = probs.reshape(n_tok, mo.n_experts).mean(0)
    ce = torch.zeros(mo.n_experts, dtype=torch.float32, device=probs.device)
    ce.index_add_(0, flat, torch.full(flat.shape, 1.0 / (n_tok * mo.top_k),
                                      device=probs.device))
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
                dense_eval: bool = False):
        return moe_apply(self, x, groups=groups, dense_eval=dense_eval)


def moe_apply(moe: MoE, x: torch.Tensor, groups: Optional[int] = None,
              dense_eval: bool = False):
    """x (B, T, d) -> ``(y (B, T, d), aux)``, as JAX's ``moe_apply``.

    ``groups=None`` is one flat capacity buffer over all B * T tokens;
    ``groups=G`` splits the tokens into G groups, each with its own sort
    and its own capacity (GShard).  ``dense_eval`` runs every expert on
    every token and combines with the zero-masked gate matrix: no
    capacity, no drops.  Dropped pairs (past the capacity) add nothing:
    they are masked out of the scatter and their gate is 0 in the gather.
    """
    cfg = moe.cfg
    mo = cfg.moe
    B, T, d = x.shape
    dtype = x.dtype
    n_tok = B * T
    G = groups or 1
    if n_tok % G:
        raise ValueError(f"{n_tok} tokens do not split into {G} groups")
    ng = n_tok // G
    xg = x.reshape(G, ng, d)
    probs, gate_vals, expert_ids = route(xg, moe.router, mo.top_k)
    aux = switch_aux(cfg, probs, expert_ids)

    if dense_eval:
        gates = torch.zeros((G, ng, mo.n_experts), dtype=dtype,
                            device=x.device)
        for s in range(mo.top_k):
            gates.scatter_add_(-1, expert_ids[..., s:s + 1],
                               gate_vals[..., s:s + 1].to(dtype))
        h_g = torch.einsum("gnd,edf->gnef", xg, moe.w_gate.to(dtype))
        h_u = torch.einsum("gnd,edf->gnef", xg, moe.w_up.to(dtype))
        y = torch.einsum("gnef,efd,gne->gnd", F.silu(h_g) * h_u,
                         moe.w_down.to(dtype), gates)
    else:
        C = capacity(ng, cfg)
        pos = positions_in_expert(expert_ids.reshape(G, ng * mo.top_k)
                                  ).reshape(G, ng, mo.top_k)
        keep = pos < C
        buf = dispatch(xg, expert_ids, pos, keep, mo.n_experts, C)
        out = expert_ffn(buf.view(G, mo.n_experts, C, d), moe.w_gate,
                         moe.w_up, moe.w_down).reshape(-1, d)
        y = combine(out, expert_ids, pos, keep, gate_vals, mo.n_experts, C)
    if mo.n_shared_experts:
        y = y + moe.shared(xg)
    return y.reshape(B, T, d), aux
