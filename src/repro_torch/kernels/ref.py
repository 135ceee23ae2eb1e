"""Plain torch versions of the port's kernels: their CPU path and the
references the CUDA kernels are held against on the card."""
from __future__ import annotations

import math

import torch

from ..core.triad_table import TRIAD_TABLE_64


def _member(cand: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row-wise membership: ``cand[d, j] in rows[d, :]``.  Every row is
    sorted ascending (SENTINEL tail), so this is one batched binary
    search rather than a (D, K, K) broadcast compare."""
    at = torch.searchsorted(rows, cand).clamp_(max=rows.shape[1] - 1)
    return rows.gather(1, at) == cand


def census_tiles_ref(out_u, in_u, out_v, in_v, nbr_u, nbr_v, u, v, n: int,
                     *, block=None, sentinel: int = 2**30) -> torch.Tensor:
    """Plain version of the triad-census tile kernel, in exact integers.

    Tile args: (D, K) int32, each row sorted ascending and padded with
    ``sentinel``; ``u``, ``v``: (D,) int32 canonical dyads (``u ==
    sentinel`` marks a padded dyad, which adds nothing); ``n``: the vertex
    count.  Returns the (16,) int64 census of dyadic + connected triads
    (null triads come from the closed form outside), or with ``block``
    the kernel's own contract: (D / block, 16) int32 per-block partials.
    """
    D = nbr_u.shape[0]
    dev = nbr_u.device
    uc, vc = u.long()[:, None], v.long()[:, None]
    pad = u == sentinel
    mu = (nbr_u != sentinel) & (nbr_u != vc)
    mv = (nbr_v != sentinel) & (nbr_v != uc)
    mv_only = mv & ~_member(nbr_v, nbr_u)  # S = N(u) ∪ N(v) \ {u, v}
    s_size = mu.sum(1) + mv_only.sum(1)

    e_uv = _member(v[:, None].to(out_u.dtype), out_u)[:, 0].long()
    e_vu = _member(u[:, None].to(out_v.dtype), out_v)[:, 0].long()
    dyad_code = e_uv + 2 * e_vu
    table = torch.as_tensor(TRIAD_TABLE_64, dtype=torch.int64, device=dev)

    def types(cand):
        c = (dyad_code[:, None] + 4 * _member(cand, out_u).long()
             + 8 * _member(cand, in_u).long()
             + 16 * _member(cand, out_v).long()
             + 32 * _member(cand, in_v).long())
        return table[c]

    canon_u = mu & (nbr_u > vc) & ~pad[:, None]
    canon_v = (mv_only & ((nbr_v > vc) | ((nbr_v > uc) & (nbr_v < vc)))
               & ~pad[:, None])
    base = 16 * torch.arange(D, device=dev)[:, None]
    per = torch.zeros(D * 16, dtype=torch.int64, device=dev)
    per.index_add_(0, (base + types(nbr_u)).reshape(-1),
                   canon_u.reshape(-1).long())
    per.index_add_(0, (base + types(nbr_v)).reshape(-1),
                   canon_v.reshape(-1).long())
    per = per.view(D, 16)
    per[:, 0] = 0
    dyadic = torch.where(pad, 0, n - s_size - 2)
    per.index_put_((torch.arange(D, device=dev),
                    torch.where(dyad_code == 3, 2, 1)), dyadic,
                   accumulate=True)
    if block is None:
        return per.sum(0)
    return per.view(D // block, block, 16).sum(1).int()


def flash_attention_ref(q, k, v, q_pos, kv_pos, window=None) -> torch.Tensor:
    """Dense causal (optionally windowed) GQA attention: the plain version
    of the flash kernel, as :func:`repro.kernels.ref.flash_attention_ref`.

    q: (B, T, H, D); k, v: (B, S, Hkv, D); positions (B, T) / (B, S) int.
    Key j is visible to query i iff ``kv_pos[j] <= q_pos[i]`` (and, with a
    window, ``kv_pos[j] > q_pos[i] - window``).  Scores, softmax and the
    weighted sum in f32; the output in q's dtype.  A query that sees no
    key gets the mean of v over all S slots (every score is -1e30).
    """
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, D).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) / math.sqrt(D)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    s = torch.where(mask[:, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return o.reshape(B, T, H, D).to(q.dtype)
