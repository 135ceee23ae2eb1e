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


def census_csr_ref(u, v, n: int, arrays, *, block=None,
                   sentinel: int = 2**30) -> torch.Tensor:
    """Plain version of the CSR census kernel, in exact integers.

    ``u``, ``v``: (D,) int32 canonical dyads (``u == sentinel`` marks a
    padded dyad, which adds nothing); ``arrays``: a
    :class:`~repro_torch.core.graph.GraphArrays` with ``nbr_ptr``,
    ``nbr_idx`` and the arc flags and range counts ``nbr_flag`` /
    ``nbr_cnt`` (:func:`repro_torch.kernels.ops.build_arc_flags_device`).
    Returns what :func:`census_tiles_ref` returns for the same dyads: the
    (16,) int64 census of dyadic + connected triads, or with ``block`` the
    (D / block, 16) int32 per-block partials.

    With ``dir(x, w) = [x -> w] + 2 [w -> x]`` read from the flags, a dyad
    (u, v) has dyad code ``c0 = dir(u, v)`` and
    ``|S| = deg u + deg v - 2 - |N(u) ∩ N(v)|``.  Every w > v of N(u)
    counts with code ``c0 + 4 dir(u, w)`` plus ``16 dir(v, w)`` when w is
    in N(v); every w > u of N(v) outside N(u) counts with
    ``c0 + 16 dir(v, w)``.  So the census is the flag counts over two row
    ranges (from the range counts) corrected by each element of the
    intersection.  The intersection expands the smaller row of each dyad
    and searches it in the larger one through ``searchsorted`` on 64-bit
    ``row * n + column`` keys.
    """
    dev = u.device
    D = u.shape[0]
    ptr, idx = arrays.nbr_ptr, arrays.nbr_idx
    flags, cnt = arrays.nbr_flag.long(), arrays.nbr_cnt.long()
    if cnt.dim() == 1:  # packed: flag-1 counts low, flag-2 counts high
        cnt = torch.stack([cnt & 0xFFFF, (cnt >> 16) & 0xFFFF])
    n_rows, M = ptr.shape[0] - 1, idx.shape[0]
    pos = torch.arange(M, dtype=ptr.dtype, device=dev)
    rows = torch.searchsorted(ptr, pos, right=True).long() - 1
    keys = torch.where(pos < ptr[-1], rows * n_rows + idx.long(),
                       torch.iinfo(torch.int64).max)

    def find(x, w):
        key = x * n_rows + w
        at = torch.searchsorted(keys, key).clamp_(max=M - 1)
        return at, keys[at] == key

    valid = u != sentinel
    uu = torch.where(valid, u, 0).long()
    vv = torch.where(valid, v, 0).long()
    ptr = ptr.long()
    pu, pv = ptr[uu], ptr[vv]
    du = torch.where(valid, ptr[uu + 1] - pu, 0)
    dv = torch.where(valid, ptr[vv + 1] - pv, 0)
    at_v, _ = find(uu, vv)  # v in N(u)
    at_u, _ = find(vv, uu)  # u in N(v)
    code0 = torch.where(valid, flags[at_v], 0)
    table = torch.as_tensor(TRIAD_TABLE_64, dtype=torch.int64, device=dev)
    per = torch.zeros(D * 16, dtype=torch.int64, device=dev)
    base = 16 * torch.arange(D, device=dev)

    def add(dyads, codes, amount):
        per.index_add_(0, base[dyads] + table[codes], amount)

    every = torch.arange(D, device=dev)
    for at, row_start, deg, shift in ((at_v, pu, du, 4), (at_u, pv, dv, 16)):
        # flag counts over the row's positions past the other vertex
        end = (row_start + deg - 1).clamp(min=0)
        c1, c2 = cnt[:, end] - cnt[:, at]
        c3 = end - at - c1 - c2
        for d, c_d in ((1, c1), (2, c2), (3, c3)):
            add(every, code0 + shift * d, torch.where(valid, c_d, 0))

    # N(u) ∩ N(v): each element of the smaller row searched in the larger
    small_u = du < dv
    small_ptr = torch.where(small_u, pu, pv)
    small_deg = torch.minimum(du, dv)
    large = torch.where(small_u, vv, uu)
    seg = torch.repeat_interleave(every, small_deg)
    first = torch.cumsum(small_deg, 0) - small_deg
    p = small_ptr[seg] + torch.arange(seg.shape[0], device=dev) - first[seg]
    w = idx[p].long()
    q, found = find(large[seg], w)
    f_small, f_large = flags[p], flags[q]
    fu = torch.where(small_u[seg], f_small, f_large)
    fv = torch.where(small_u[seg], f_large, f_small)
    s_size = du + dv - 2 - torch.zeros(D, dtype=torch.int64, device=dev
                                       ).index_add_(0, seg, found.long())
    c0 = code0[seg]
    high = (found & (w > vv[seg])).long()
    mid = (found & (w > uu[seg]) & (w < vv[seg])).long()
    add(seg, c0 + 4 * fu, -high)
    add(seg, c0 + 16 * fv, -high - mid)
    add(seg, c0 + 4 * fu + 16 * fv, high)

    per = per.view(D, 16)
    per[:, 0] = 0
    dyadic = torch.where(valid, n - s_size - 2, 0)
    per.index_put_((every, torch.where(code0 == 3, 2, 1)), dyadic,
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
