"""Mamba2 (SSD) block, the chunked formulation.

Counterpart of :mod:`repro.models.ssm`.  The selective-state-space
recurrence

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t x_t,     y_t = C_t . h_t + D x_t

is evaluated with the SSD chunk decomposition (Dao & Gu 2024): within a
chunk of length L the contribution is a masked (L, L) decay matmul, and a
loop over the chunks carries the f32 (B, H, P, N) state.  Unlike the JAX
package, which reshapes T into whole chunks and so refuses a T that is
longer than a chunk and not a multiple of it, the last chunk may be
shorter: the decomposition is exact for any length.  A single token with
a cache takes the exact one-step recurrence (:func:`ssd_step`).  Casts
follow JAX's one for one: projections and the conv in the activations'
dtype, ``dt``, ``a``, the scan and its state in f32.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.base import ModelConfig
from ..sharding.rules import model_shards, run_local, write_into
from .layers import linear, rms_norm
from .params import ParamDef


def ssm_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    gn = s.n_groups * s.d_state
    H = di // s.head_dim
    return {
        "wx": ParamDef((d, di), ("embed", "ff")),
        "wz": ParamDef((d, di), ("embed", "ff")),
        "wB": ParamDef((d, gn), ("embed", None)),
        "wC": ParamDef((d, gn), ("embed", None)),
        "wdt": ParamDef((d, H), ("embed", None)),
        "conv_x": ParamDef((s.conv_width, di), (None, "ff"), "normal", 0.5),
        "conv_B": ParamDef((s.conv_width, gn), (None, None), "normal", 0.5),
        "conv_C": ParamDef((s.conv_width, gn), (None, None), "normal", 0.5),
        "A_log": ParamDef((H,), (None,), "zeros"),
        "D": ParamDef((H,), (None,), "ones"),
        "dt_bias": ParamDef((H,), (None,), "zeros"),
        "norm": ParamDef((di,), (None,), "ones"),
        "wo": ParamDef((di, d), ("ff", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv with SiLU.  x: (B, T, C), w: (W, C) taps,
    state: (B, W-1, C) inputs before x (zeros when None).  The taps are
    summed in x's dtype, as JAX does.  Returns ``(silu(out) (B, T, C),
    new state (B, W-1, C))``, the new state the last W-1 inputs."""
    W, T = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + T] * w[i] for i in range(W))
    new_state = xp[:, xp.shape[1] - (W - 1):] if W > 1 else None
    return F.silu(out), new_state


def _segsum_exp(l: torch.Tensor) -> torch.Tensor:
    """exp of segment sums: (..., L) -> (..., L, L) lower-triangular decay,
    entry (t, s) = exp(l_{s+1} + ... + l_t) for s <= t, else 0.  The sums
    above the diagonal are positive (``l`` is a negative log decay) and
    overflow ``exp``; they are set to -inf before it, so they come out 0
    and never ``inf * 0``."""
    L = l.shape[-1]
    cs = l.cumsum(-1)
    diff = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((L, L), dtype=torch.bool, device=l.device).triu(1)
    return diff.masked_fill(upper, float("-inf")).exp()


def ssd_chunked(x, dt, a, B_mat, C_mat, chunk: int, state0=None):
    """SSD scan.  x: (B, T, H, P), dt: (B, T, H), a: (H,), B/C: (B, T, N);
    state0: (B, H, P, N) or None (zeros).

    Returns ``(y (B, T, H, P), final state (B, H, P, N))``, both f32.
    Chunks of ``min(chunk, T)`` steps; the last one takes what is left.
    """
    Bsz, T, H, P = x.shape
    N = B_mat.shape[-1]
    L = min(chunk, T)
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B_mat.float(), C_mat.float()
    l = dtf * a  # (B, T, H) negative decay logs
    S = (x.new_zeros((Bsz, H, P, N), dtype=torch.float32) if state0 is None
         else state0.float())
    ys = []
    for t0 in range(0, T, L):
        xc, dtc, lc = xf[:, t0:t0 + L], dtf[:, t0:t0 + L], l[:, t0:t0 + L]
        Bc, Cc = Bf[:, t0:t0 + L], Cf[:, t0:t0 + L]
        cs = lc.cumsum(1)  # (B, Lc, H)
        # inter-chunk: y_t += C_t . (exp(cs_t) * S_prev)
        y_inter = torch.einsum("bln,bhpn->blhp", Cc, S) * cs.exp()[..., None]
        # intra-chunk: the masked (Lc, Lc) decay matmul, per head
        Dm = _segsum_exp(lc.transpose(1, 2))  # (B, H, Lc, Lc)
        CB = torch.einsum("bln,bsn->bls", Cc, Bc)
        M = CB[:, None] * Dm * dtc.transpose(1, 2)[:, :, None, :]
        y_intra = (M @ xc.transpose(1, 2)).transpose(1, 2)  # (B, Lc, H, P)
        # state update: S' = exp(cs_L) S + sum_s exp(cs_L - cs_s) dt_s x_s B_s
        decay_tail = (cs[:, -1:] - cs).exp() * dtc  # (B, Lc, H)
        S_chunk = torch.einsum("bsn,bshp->bhpn", Bc,
                               xc * decay_tail[..., None])
        S = cs[:, -1].exp()[..., None, None] * S + S_chunk
        ys.append(y_inter + y_intra)
    return torch.cat(ys, 1), S


def ssd_step(S, x, dt, a, B_mat, C_mat):
    """One exact step of the recurrence.  S: (B, H, P, N) f32, x: (B, H,
    P), dt: (B, H), a: (H,), B/C: (B, N).  Returns ``(y (B, H, P), new
    state)``, f32."""
    da = (dt * a).exp()
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, B_mat.float(), x.float())
    S = S * da[..., None, None] + upd
    return torch.einsum("bn,bhpn->bhp", C_mat.float(), S), S


class Mamba2(nn.Module):
    """The Mamba2 block body (no residual or norm), as JAX's ``ssm_apply``.

    Projections are ``nn.Linear`` in PyTorch's (out, in) layout; the conv
    taps ``conv_x``, ``conv_B``, ``conv_C`` (W, C) and the per-head
    ``A_log``, ``D``, ``dt_bias`` are parameters in the JAX layout."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        di = s.expand * d
        gn = s.n_groups * s.d_state
        H = di // s.head_dim
        self.cfg = cfg
        self.wx = nn.Linear(d, di, bias=False)
        self.wz = nn.Linear(d, di, bias=False)
        self.wB = nn.Linear(d, gn, bias=False)
        self.wC = nn.Linear(d, gn, bias=False)
        self.wdt = nn.Linear(d, H, bias=False)
        self.conv_x = nn.Parameter(torch.zeros(s.conv_width, di))
        self.conv_B = nn.Parameter(torch.zeros(s.conv_width, gn))
        self.conv_C = nn.Parameter(torch.zeros(s.conv_width, gn))
        self.A_log = nn.Parameter(torch.zeros(H))
        self.D = nn.Parameter(torch.ones(H))
        self.dt_bias = nn.Parameter(torch.zeros(H))
        self.norm = nn.Parameter(torch.ones(di))
        self.wo = nn.Linear(di, d, bias=False)

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                shard=None):
        """x (B, T, d).  ``cache``: one layer's ``{"conv_x", "conv_B",
        "conv_C", "state"}`` (views into :func:`init_cache`'s stacks) or
        None; its leaves are overwritten in place with the new conv
        inputs and the final f32 state.  Returns ``(out (B, T, d),
        cache)``.

        Under ``shard=(mesh, rules)`` (DTensors) the projections, the
        gated norm and the output projection are DTensor ops: x, z and
        the conv of x arrive split on ``"ff"`` over the model axis, dt
        and B/C whole on every rank; the convs and the scan run on each
        rank's own heads (:func:`_mix`, through ``local_map``; the
        replicated dt, ``A_log`` and ``D`` sliced to them), and the gated
        norm's RMS over all ``di`` features reduces across the model
        axis.  The cache's state, replicated over the model axis as JAX
        places it, is gathered back from the head shards."""
        s = self.cfg.ssm
        B, T, d = x.shape
        di = s.expand * d
        H = di // s.head_dim
        dtype = x.dtype
        if shard is not None:
            model_shards(shard[0], H, f"{self.cfg.name}: the SSD heads")

        z, xi = linear(self.wz, x), linear(self.wx, x)
        Bm, Cm = linear(self.wB, x), linear(self.wC, x)
        dt = F.softplus(linear(self.wdt, x).float() + self.dt_bias.float())
        state = {} if cache is None else cache
        step = T == 1 and cache is not None  # exact single-step decode
        feat, whole = ("batch", "seq", "ff"), ("batch", "seq", None)
        heads = ("batch", "seq", "heads_flat")
        taps = ((None, "ff"), (None, None), (None, None))
        conv = (("batch", None, "ff"), ("batch", None, None),
                ("batch", None, None))
        st = ("batch", "heads_flat", None, None)
        g, ncx, ncB, ncC, S = run_local(
            functools.partial(_mix, s.head_dim, s.chunk, step), shard,
            (feat, whole, whole, heads, feat, *taps, ("heads_flat",),
             ("heads_flat",), *(None if cache is None else c
                                for c in (*conv, st))),
            [feat, *conv, st],
            xi, Bm, Cm, dt, z, *(w.to(dtype) for w in (self.conv_x,
                                                        self.conv_B,
                                                        self.conv_C)),
            self.A_log, self.D, *(state.get(k) for k in
                                  ("conv_x", "conv_B", "conv_C", "state")))
        if cache is not None:
            for name, new in (("conv_x", ncx), ("conv_B", ncB),
                              ("conv_C", ncC), ("state", S)):
                write_into(cache[name], new)
        y = rms_norm(g, self.norm, self.cfg.norm_eps)
        return linear(self.wo, y), cache


def _mix(head_dim: int, chunk: int, step: bool, xi, Bm, Cm, dt, z, conv_x,
         conv_B, conv_C, A_log, D, cx, cB, cC, state):
    """The Mamba2 body between the projections and the gated norm, on
    plain tensors (one rank's heads under a mesh): the causal convs, the
    scan (:func:`ssd_chunked`, or one :func:`ssd_step` when ``step``),
    the ``D`` skip and the SiLU gate.  xi, z (B, T, H * head_dim), Bm, Cm
    (B, T, N), dt (B, T, H) f32, the taps, A_log and D (H,), the cache's
    conv inputs and state (or None).  Returns ``(y * silu(z) (B, T, H *
    head_dim) in xi's dtype, new conv_x, conv_B, conv_C inputs, final f32
    state)``."""
    B, T, di = xi.shape
    dtype = xi.dtype
    xi, ncx = _causal_conv(xi, conv_x, cx)
    Bm, ncB = _causal_conv(Bm, conv_B, cB)
    Cm, ncC = _causal_conv(Cm, conv_C, cC)
    a = -A_log.float().exp()  # (H,)
    xh = xi.reshape(B, T, di // head_dim, head_dim)
    if step:
        y, S = ssd_step(state, xh[:, 0], dt[:, 0], a, Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    else:
        y, S = ssd_chunked(xh, dt, a, Bm, Cm, chunk, state)
    y = y + D.float()[:, None] * xh.float()
    return y.reshape(B, T, di).to(dtype) * F.silu(z), ncx, ncB, ncC, S
