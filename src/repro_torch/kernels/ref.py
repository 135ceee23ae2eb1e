"""Plain torch version of the census tile kernel (its CPU path and the
reference the CUDA kernel is held against on the card)."""
from __future__ import annotations

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
