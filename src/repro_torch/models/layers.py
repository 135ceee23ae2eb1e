"""Shared neural layers: RMS norm, RoPE, the SwiGLU MLP.

Counterpart of :mod:`repro.models.layers`, with the same arithmetic: the
norm and RoPE run in f32 inside and return the input's dtype; the MLP
casts its weights to the activations' dtype, as JAX's ``.astype(dtype)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding.rules import gathered, is_dtensor, replicated_like
from .params import ParamDef


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * weight.float()).to(dtype)


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> "tuple[torch.Tensor, torch.Tensor]":
    """cos/sin tables for given positions: (..., dim // 2), f32.  For a
    DTensor ``positions`` the tables are DTensors placed as it is."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    if is_dtensor(positions):
        inv = replicated_like(inv, positions)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); cos/sin: (B, T, D // 2) — rotate-half convention."""
    dtype = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dtype)


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x`` through a bias-free ``nn.Linear`` whose weight is cast to
    x's dtype, as JAX's ``x @ w.astype(dtype)``; a DTensor weight with
    its FSDP shards gathered first (:func:`~repro_torch.sharding.rules.
    gathered`)."""
    return F.linear(x, gathered(lin.weight).to(x.dtype))


def mlp_defs(d_model: int, d_ff: int) -> dict[str, ParamDef]:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", "ff")),
        "w_up": ParamDef((d_model, d_ff), ("embed", "ff")),
        "w_down": ParamDef((d_ff, d_model), ("ff", "embed")),
    }


class MLP(nn.Module):
    """SwiGLU: ``(silu(x W_gate) * (x W_up)) W_down``; ``nn.Linear``
    weights in PyTorch's (out, in) layout."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_gate = nn.Linear(d_model, d_ff, bias=False)
        self.w_up = nn.Linear(d_model, d_ff, bias=False)
        self.w_down = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        g = F.linear(x, gathered(self.w_gate.weight).to(dtype))
        u = F.linear(x, gathered(self.w_up.weight).to(dtype))
        return F.linear(F.silu(g) * u,
                        gathered(self.w_down.weight).to(dtype))
