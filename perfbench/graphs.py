"""The benchmark's stand-in graphs: a directed degree-corrected block
model (Karrer and Newman, 2011) held to a network's published vertex and
arc counts, drawn on a device from a ``torch.Generator`` in a few large
calls.

The benchmark makes each graph's arc list here, hands the host copy to
the program's graph builder and the same list to the reference.  The same
seed on the same device gives the same arcs.

A configuration's ``graph`` gives:

* ``n`` and ``m``: the vertices and the distinct, loop-free arcs, exactly;
* ``out``: each vertex's candidate out-arcs, ``{"law": "fixed", "draws":
  k}`` (every vertex ``k``; the out-degree is then at most ``k``) or
  ``{"law": "lognormal", "mean": x, "sigma": s, "max": k}`` (a rounded
  log-normal with that mean, capped at ``k``);
* ``blocks``: the number of blocks; each vertex joins one at random;
* ``p_block``: the share of candidates drawn inside the source's block,
  the rest from all vertices;
* ``alpha``: target popularity, ``rank ** -alpha`` over a random ranking
  of the vertices, which sets the in-degree tail;
* ``older_only``: a vertex's arcs go only to vertices of a lower id (a
  citation graph: ids in time order, no cycles).

Candidates that repeat an arc, loop, or find no vertex to point to are
dropped, and ``m`` of the rest are kept, chosen at random: so the
out-degree law is the candidates' thinned to ``m / n`` a vertex.  Where
one round of candidates gives fewer than ``m`` distinct arcs, another
round is drawn, up to ``ROUNDS``.
"""
from __future__ import annotations

import math

import torch

#: rounds of candidates drawn at most before the draw gives up
ROUNDS = 4


def _pick(gen, cum_incl: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """For each candidate, a position in ``[lo, hi)`` drawn by weight
    (``cum_incl``: the inclusive running sum of the weights in position
    order); -1 where the range is empty."""
    zero = torch.zeros(1, dtype=cum_incl.dtype, device=cum_incl.device)
    cum_excl = torch.cat([zero, cum_incl])
    a, b = cum_excl[lo], cum_excl[hi]
    u = a + (b - a) * torch.rand(lo.numel(), generator=gen,
                                 device=lo.device, dtype=cum_incl.dtype)
    pos = torch.searchsorted(cum_incl, u, right=True)
    pos = torch.minimum(torch.maximum(pos, lo), hi - 1)
    return torch.where(hi > lo, pos, -1)


def _out_draws(gen, out: dict, n: int, device) -> torch.Tensor:
    """Each vertex's number of candidate out-arcs."""
    if out["law"] == "fixed":
        return torch.full((n,), int(out["draws"]), dtype=torch.int64,
                          device=device)
    if out["law"] == "lognormal":
        s = float(out["sigma"])
        mu = math.log(float(out["mean"])) - s * s / 2
        z = torch.randn(n, generator=gen, device=device,
                        dtype=torch.float64)
        return torch.exp(mu + s * z).round().to(torch.int64).clamp_(
            0, int(out["max"]))
    raise ValueError(f"unknown out-degree law {out['law']!r}")


def arcs(graph: dict, seed: int, device) -> "tuple[int, torch.Tensor, torch.Tensor]":
    """``(n, src, dst)``: ``graph["m"]`` distinct, loop-free int64 arcs on
    ``graph["n"]`` vertices, sorted by source then target."""
    n, m = int(graph["n"]), int(graph["m"])
    older = bool(graph.get("older_only", False))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ids = torch.arange(n, device=device)

    # target weights over a random ranking; blocks at random
    rank = torch.randperm(n, generator=gen, device=device) + 1
    w = rank.to(torch.float64).pow(-float(graph["alpha"]))
    block = torch.randint(int(graph["blocks"]), (n,), generator=gen,
                          device=device)
    # positions in (block, id) order, and each block's range of them
    order = torch.argsort(block * n + ids)
    pos_of = torch.empty_like(order)
    pos_of[order] = ids
    starts = torch.searchsorted(block[order],
                                torch.arange(int(graph["blocks"]) + 1,
                                             device=device))
    cum_block = torch.cumsum(w[order], 0)
    cum_all = torch.cumsum(w, 0)

    def candidates():
        draws = _out_draws(gen, graph["out"], n, device)
        src = torch.repeat_interleave(ids, draws)
        inside = torch.rand(src.numel(), generator=gen,
                            device=device) < float(graph["p_block"])
        # inside the block: a vertex of the same block (older: before it)
        b = block[src]
        at_b = _pick(gen, cum_block, starts[b],
                     pos_of[src] if older else starts[b + 1])
        dst_b = torch.where(at_b >= 0, order[at_b.clamp(min=0)], -1)
        # from all vertices (older: ids below the source's)
        zero = torch.zeros_like(src)
        at_a = _pick(gen, cum_all, zero, src if older else zero + n)
        dst = torch.where(inside, dst_b, at_a)
        keep = (dst >= 0) & (dst != src)
        return src[keep] * n + dst[keep]

    # at the configured sizes one round gives a few per cent more distinct
    # arcs than m, tens of standard deviations; a graph cut far smaller
    # for a test may need another round, which may pass the out-degree cap
    key = torch.unique(candidates())
    for _ in range(ROUNDS - 1):
        if key.numel() >= m:
            break
        key = torch.unique(torch.cat([key, candidates()]))
    if key.numel() < m:
        raise ValueError(f"{key.numel()} distinct candidate arcs, fewer "
                         f"than the {m} asked for: draw more")
    chosen = torch.randperm(key.numel(), generator=gen, device=device)[:m]
    key = torch.sort(key[chosen]).values
    return n, key // n, key % n
