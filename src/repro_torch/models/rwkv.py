"""RWKV6 ("Finch") block: time-mix with data-dependent per-channel decay,
and channel-mix.

Counterpart of :mod:`repro.models.rwkv`.  Recurrence per head (state S in
R^{Dk x Dv}):

    o_t = r_t^T (S_{t-1} + (u ⊙ k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,     w_t = exp(-exp(w0 + lora(x_t)))

A prefill runs the chunked linear-attention form (:func:`wkv_chunked`):
within a chunk the decays are pairwise differences of cumulative log
decays, clamped at 0 so ``exp`` never overflows, and a loop over the
chunks carries the f32 state.  Unlike the JAX package, which refuses a T
that is longer than a chunk and not a multiple of it, the last chunk may
be shorter.  A single token with a cache takes the exact recurrence
(:func:`wkv_recurrent`).  Casts follow JAX's one for one.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.base import ModelConfig
from ..sharding.rules import gathered, model_shards, run_local, write_into
from .layers import linear, rms_norm
from .params import ParamDef


def rwkv_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    r = cfg.rwkv
    d = cfg.d_model
    return {
        # time-mix
        "mu_r": ParamDef((d,), (None,), "zeros"),
        "mu_k": ParamDef((d,), (None,), "zeros"),
        "mu_v": ParamDef((d,), (None,), "zeros"),
        "mu_w": ParamDef((d,), (None,), "zeros"),
        "mu_g": ParamDef((d,), (None,), "zeros"),
        "wr": ParamDef((d, d), ("embed", "heads_flat")),
        "wk": ParamDef((d, d), ("embed", "heads_flat")),
        "wv": ParamDef((d, d), ("embed", "heads_flat")),
        "wg": ParamDef((d, d), ("embed", "heads_flat")),
        "wo": ParamDef((d, d), ("heads_flat", "embed")),
        "w0": ParamDef((d,), (None,), "zeros"),
        "wA": ParamDef((d, r.decay_lora), ("embed", "lora")),
        "wB": ParamDef((r.decay_lora, d), ("lora", None)),
        "u": ParamDef((d,), (None,), "zeros"),
        "ln_x": ParamDef((d,), (None,), "ones"),
        # channel-mix
        "mu_k_cm": ParamDef((d,), (None,), "zeros"),
        "mu_r_cm": ParamDef((d,), (None,), "zeros"),
        "wk_cm": ParamDef((d, cfg.d_ff), ("embed", "ff")),
        "wv_cm": ParamDef((cfg.d_ff, d), ("ff", "embed")),
        "wr_cm": ParamDef((d, d), ("embed", "heads_flat")),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Token shift: x_{t-1}, with x_{-1} = ``prev`` (B, d) or 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv_chunked(r, k, v, w_log, u, chunk: int, state0=None):
    """r, k, v, w_log: (B, T, H, D); u: (H, D); state0: (B, H, D, D) or
    None (zeros).  Returns ``(o (B, T, H, D), final state (B, H, D, D))``,
    both f32.  Chunks of ``min(chunk, T)`` steps; the last one takes what
    is left.  The (B, L, L, H, D) decay tensor is built in place unless
    autograd records (grad mode on and an input requiring grad): then the
    same passes run out of place, with the same numbers."""
    B, T, H, D = r.shape
    L = min(chunk, T)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w_log, u,
                                                    state0))
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w_log))
    S = (rf.new_zeros((B, H, D, D)) if state0 is None else state0.float())
    os_ = []
    for t0 in range(0, T, L):
        rc, kc, vc, wc = (t[:, t0:t0 + L] for t in (rf, kf, vf, wf))
        Lc = rc.shape[1]
        tri = torch.ones((Lc, Lc), dtype=torch.bool,
                         device=r.device).tril(-1)  # s < t
        lam = wc.cumsum(1)  # inclusive cumulative log decay Λ_t
        lam_ex = lam - wc  # exclusive: E_t = Λ_{t-1}
        # intra-chunk decays as pairwise differences, <= 0 for s < t, so
        # exp never overflows (a factorized e^{E_t} e^{-Λ_s} would under
        # saturating decay)
        diff = lam_ex[:, :, None] - lam[:, None, :]  # (B, L(t), L(s), H, D)
        if grad:  # autograd needs exp's output: no pass in place
            dmat = diff.clamp(max=0.0).exp() * tri[None, :, :, None, None]
            dmat = dmat * kc[:, None]
        else:
            dmat = diff.clamp_(max=0.0).exp_().mul_(
                tri[None, :, :, None, None]).mul_(kc[:, None])
        A = torch.einsum("blhd,blshd->bhls", rc, dmat)
        o_intra = torch.einsum("bhls,bshd->blhd", A, vc)
        bonus = (rc * (u * kc)).sum(-1)  # (B, L, H)
        o_intra = o_intra + bonus[..., None] * vc
        o_inter = torch.einsum("blhd,bhdv->blhv", rc * lam_ex.exp(), S)
        # S' = diag(e^{Λ_L}) S + Σ_s (k_s e^{Λ_L - Λ_s}) v_s^T
        tail = (lam[:, -1:] - lam).exp()  # exponent <= 0
        S = (lam[:, -1].exp()[..., None] * S
             + torch.einsum("bshd,bshv->bhdv", kc * tail, vc))
        os_.append(o_intra + o_inter)
    return torch.cat(os_, 1), S


def wkv_recurrent(r, k, v, w_log, u, state0=None):
    """The exact per-step recurrence (decode path and oracle); the same
    arguments and results as :func:`wkv_chunked`."""
    B, T, H, D = r.shape
    S = (r.new_zeros((B, H, D, D), dtype=torch.float32) if state0 is None
         else state0.float())
    os_ = []
    for t in range(T):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w_log))
        kv = kt[..., :, None] * vt[..., None, :]  # (B, H, Dk, Dv)
        os_.append(torch.einsum("bhd,bhdv->bhv", rt,
                                S + u[None, :, :, None] * kv))
        S = wt.exp()[..., None] * S + kv
    return torch.stack(os_, 1), S


class TimeMix(nn.Module):
    """RWKV6 time-mix (JAX's ``time_mix_apply``): token-shift mixes, the
    r / k / v / g projections, the decay LoRA, the WKV scan with the ``u``
    bonus, ``ln_x`` and the SiLU gate."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, lora = cfg.d_model, cfg.rwkv.decay_lora
        self.cfg = cfg
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "u"):
            setattr(self, name, nn.Parameter(torch.zeros(d)))
        self.ln_x = nn.Parameter(torch.ones(d))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, nn.Linear(d, d, bias=False))
        self.wA = nn.Linear(d, lora, bias=False)
        self.wB = nn.Linear(lora, d, bias=False)

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                shard=None):
        """x (B, T, d), the block's normed input.  ``cache``: one layer's
        ``{"state", "x_tm", ...}`` (views) or None; ``state`` and ``x_tm``
        (the last row of x) are overwritten in place.  Returns ``(out (B,
        T, d), cache)``.

        Under ``shard=(mesh, rules)`` (DTensors) the projections, ``ln_x``
        and the output projection are DTensor ops: r, k, v and g arrive
        split on heads over the model axis (``"heads_flat"``), the decay
        whole on every rank; the scan runs on each rank's own heads
        (:func:`_wkv`, through ``local_map``; the replicated decay and
        ``u`` sliced to them), and ``ln_x``'s RMS over all d features
        reduces across the model axis.  The cache's state, replicated
        over the model axis as JAX places it, is gathered back from the
        head shards."""
        cfg = self.cfg
        B, T, d = x.shape
        H, D = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        dtype = x.dtype
        if shard is not None:
            model_shards(shard[0], H, f"{cfg.name}: the WKV heads")
        xs = _shift(x, None if cache is None else cache["x_tm"])

        def mix(mu):
            return x + mu.to(dtype) * (xs - x)

        r = linear(self.wr, mix(self.mu_r)).reshape(B, T, H, D)
        k = linear(self.wk, mix(self.mu_k)).reshape(B, T, H, D)
        v = linear(self.wv, mix(self.mu_v)).reshape(B, T, H, D)
        g = F.silu(linear(self.wg, mix(self.mu_g)))
        w_raw = self.w0.float() + F.linear(
            torch.tanh(linear(self.wA, mix(self.mu_w))).float(),
            gathered(self.wB.weight).float())
        w_log = -w_raw.clamp(-20.0, 10.0).exp().reshape(B, T, H, D)
        u = self.u.float().reshape(H, D)

        heads = ("batch", "seq", "heads_flat", None)
        st = ("batch", "heads_flat", None, None)
        o, S = run_local(
            functools.partial(_wkv, cfg.rwkv.chunk,
                              T == 1 and cache is not None), shard,
            (heads, heads, heads, heads, ("heads_flat", None),
             None if cache is None else st),
            [heads, st], r, k, v, w_log, u,
            None if cache is None else cache["state"])
        if cache is not None:
            write_into(cache["state"], S)
            write_into(cache["x_tm"], x[:, -1])
        o = o.reshape(B, T, d).to(dtype)
        o = rms_norm(o, self.ln_x, cfg.norm_eps) * g
        return linear(self.wo, o), cache


def _wkv(chunk: int, step: bool, r, k, v, w_log, u, state0):
    """The WKV scan on plain tensors (one rank's heads under a mesh):
    :func:`wkv_chunked`, or :func:`wkv_recurrent` for one decode step
    (``step``)."""
    if step:
        return wkv_recurrent(r, k, v, w_log, u, state0)
    return wkv_chunked(r, k, v, w_log, u, chunk, state0)


class ChannelMix(nn.Module):
    """RWKV6 channel-mix (JAX's ``channel_mix_apply``): token-shift mixes,
    ``relu(x W_k)^2 W_v`` gated by ``sigmoid(x W_r)``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.mu_k_cm = nn.Parameter(torch.zeros(d))
        self.mu_r_cm = nn.Parameter(torch.zeros(d))
        self.wk_cm = nn.Linear(d, cfg.d_ff, bias=False)
        self.wv_cm = nn.Linear(cfg.d_ff, d, bias=False)
        self.wr_cm = nn.Linear(d, d, bias=False)

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None):
        """x (B, T, d), the block's second normed input; ``cache["x_cm"]``
        (the last row of x) is overwritten in place.  Returns ``(out (B, T,
        d), cache)``."""
        dtype = x.dtype
        xs = _shift(x, None if cache is None else cache["x_cm"])
        xk = x + self.mu_k_cm.to(dtype) * (xs - x)
        xr = x + self.mu_r_cm.to(dtype) * (xs - x)
        k = F.relu(linear(self.wk_cm, xk)).square()
        out = torch.sigmoid(linear(self.wr_cm, xr)) * linear(self.wv_cm, k)
        if cache is not None:
            write_into(cache["x_cm"], x[:, -1])
        return out, cache
