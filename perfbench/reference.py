"""The plain reference: the 16-type triad census and the degree
statistics of a digraph, in plain PyTorch, from its arc list.

It shares no code with the program under test and counts in another way
than the program's per-dyad algorithm (Batagelj and Mrvar):

* triangles (three connected dyads) are found once each by orienting
  every edge from the lower to the higher (degree, id) rank and closing
  the wedges of each vertex's forward neighbours; each is typed by its
  64-code;
* open wedges (two connected dyads) are every pair of edges at a centre,
  counted per vertex from its out-only, in-only and mutual degrees,
  less the pairs that the triangles close;
* triads with one connected dyad are, for each dyad, the vertices
  adjacent to neither end: ``n - deg a - deg b`` plus the triangles on it;
* 003 is the rest of ``C(n, 3)``.

``acc`` is the type every sum is accumulated in: ``torch.int64`` (and
Python integers for 003) is exact; ``torch.int32`` and
``torch.float32`` give the lower-precision controls that the exact
comparison has to fail.
"""
from __future__ import annotations

import math

import torch

from .triads import NAMES, TABLE, code_of

#: wedge categories at a centre by the two edges' kinds relative to it:
#: out-only (0), in-only (1), mutual (2)
_CAT = {(0, 0): 0, (1, 1): 1, (0, 1): 2, (1, 0): 2, (2, 0): 3, (0, 2): 3,
        (2, 1): 4, (1, 2): 4, (2, 2): 5}
#: the triad type of an open wedge of each category (centre 0)
_WEDGE_TYPE = tuple(TABLE[code_of(arcs)] for arcs in (
    {(0, 1), (0, 2)}, {(1, 0), (2, 0)}, {(0, 1), (2, 0)},
    {(0, 1), (1, 0), (0, 2)}, {(0, 1), (1, 0), (2, 0)},
    {(0, 1), (1, 0), (0, 2), (2, 0)}))

DEGREE_BINS = 16


def directed_arcs(n: int, src: torch.Tensor, dst: torch.Tensor):
    """``(s, d)``: the distinct arcs, self-loops dropped, sorted."""
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])
    return key // n, key % n


def dyads(n: int, s: torch.Tensor, d: torch.Tensor):
    """``(key, state)`` of the connected dyads ``{a < b}``, sorted by
    ``key = a * n + b``; ``state`` is 1 for a -> b alone, 2 for b -> a
    alone and 3 for both."""
    lo, hi = torch.minimum(s, d), torch.maximum(s, d)
    key, inv = torch.unique(lo * n + hi, return_inverse=True)
    bit = torch.where(s < d, 1, 2)
    state = torch.zeros(key.numel(), dtype=torch.int64, device=s.device)
    return key, state.scatter_add_(0, inv, bit)


def _arc(x, y, s):
    """1 where the arc x -> y exists in a dyad of state ``s``."""
    return torch.where(x < y, s & 1, (s >> 1) & 1)


def _kind(c, t, s):
    """The kind of the edge c - t relative to c: 0 out-only, 1 in-only,
    2 mutual."""
    out, inn = _arc(c, t, s), _arc(t, c, s)
    return torch.where((out & inn).bool(), 2, inn)


class _Acc:
    """Sums in the accumulation type, one running value per name."""

    def __init__(self, acc: torch.dtype, device):
        self.acc, self.device = acc, device
        self.v: dict = {}

    def add(self, name, x: torch.Tensor) -> None:
        s = x.to(self.acc).sum(dtype=self.acc)
        self.v[name] = self.v[name] + s if name in self.v else s

    def get(self, name) -> torch.Tensor:
        return self.v.get(name, torch.zeros((), dtype=self.acc,
                                            device=self.device))


def _as_acc(x: int, acc: torch.dtype, device) -> torch.Tensor:
    if acc == torch.int32:  # what an int32 accumulator holds: x mod 2**32
        x = (x + 2 ** 31) % 2 ** 32 - 2 ** 31
    return torch.tensor(x, dtype=acc, device=device)


def census(n: int, src: torch.Tensor, dst: torch.Tensor, *,
           acc: torch.dtype = torch.int64, block: int = 1 << 24) -> list:
    """The 16 triad counts (Python ints, in ``NAMES`` order) of the
    digraph on ``n`` vertices with arcs ``src -> dst`` (int64 tensors;
    self-loops and repeats are dropped).  Wedges are closed ``block``
    pairs at a time."""
    dev = src.device
    s, d = directed_arcs(n, src, dst)
    key, state = dyads(n, s, d)
    del s, d
    a, b = key // n, key % n
    D = key.numel()
    sums = _Acc(acc, dev)

    def per_vertex(mask_a, mask_b):
        out = torch.zeros(n, dtype=torch.int64, device=dev)
        out.index_add_(0, a, mask_a.to(torch.int64))
        return out.index_add_(0, b, mask_b.to(torch.int64))

    o = per_vertex(state == 1, state == 2)
    i = per_vertex(state == 2, state == 1)
    mu = per_vertex(state == 3, state == 3)
    deg = o + i + mu
    for cat, x in enumerate((o * (o - 1) // 2, i * (i - 1) // 2, o * i,
                             mu * o, mu * i, mu * (mu - 1) // 2)):
        sums.add(("wedges", cat), x)
    rest = n - deg[a] - deg[b]
    sums.add("one_asym", torch.where(state == 3, 0, rest))
    sums.add("one_mutual", torch.where(state == 3, rest, 0))
    del rest, o, i, mu

    # orient each edge up the (degree, id) order; the forward CSR
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(deg * n + torch.arange(n, device=dev))] = \
        torch.arange(n, device=dev)
    up = rank[a] < rank[b]
    p, q = torch.where(up, a, b), torch.where(up, b, a)
    order = torch.argsort(p * n + q)
    fp, fq, fe = p[order], q[order], order
    del p, q, up, rank, order
    fptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    fptr[1:] = torch.cumsum(torch.bincount(fp, minlength=n), 0)
    pos = torch.arange(D, device=dev)
    pairs = fptr[fp + 1] - 1 - pos  # partners after each forward edge
    cum = torch.cumsum(pairs, 0)
    total = int(cum[-1]) if D else 0
    cuts = (torch.searchsorted(cum, torch.arange(
        block, total + block, block, device=dev), right=True).tolist()
        if total else [])
    lo = 0
    for hi in cuts:
        hi = max(hi, lo + 1)
        if lo >= D:
            break
        c = pairs[lo:hi]
        m = int(c.sum())
        if m:
            _close(n, lo, c, m, fp, fq, fe, key, state, sums, dev)
        lo = hi
    counts = [None] * 16
    for t in range(16):
        counts[t] = sums.get(("tri", t))
    for cat in range(6):
        t = _WEDGE_TYPE[cat]
        counts[t] = (sums.get(("wedges", cat))
                     - sums.get(("closed", cat)))
    counts[NAMES.index("012")] = sums.get("one_asym") + sums.get("t_asym")
    counts[NAMES.index("102")] = (sums.get("one_mutual")
                                  + sums.get("t_mutual"))
    c3 = math.comb(n, 3)
    if acc == torch.int64:
        rest15 = [int(x) for x in counts[1:]]
        return [c3 - sum(rest15)] + rest15
    total15 = torch.stack(counts[1:]).sum(dtype=acc)
    counts[0] = _as_acc(c3, acc, dev) - total15
    return [int(round(float(x))) for x in counts]


def _close(n, lo, c, m, fp, fq, fe, key, state, sums, dev):
    """Close the wedges of forward edges ``lo ..`` (``c`` partners
    each): find the triangles, type them, and add their closed wedges
    and their edges' incidences."""
    first = torch.arange(lo, lo + c.numel(), device=dev)
    rep = torch.repeat_interleave(first, c)
    start = torch.cumsum(c, 0) - c
    j = rep + 1 + torch.arange(m, device=dev) - torch.repeat_interleave(
        start, c)
    w, x, y = fp[rep], fq[rep], fq[j]
    k = torch.minimum(x, y) * n + torch.maximum(x, y)
    at = torch.searchsorted(key, k).clamp_(max=key.numel() - 1)
    hit = key[at] == k
    w, x, y = w[hit], x[hit], y[hit]
    s1, s2, s3 = state[fe[rep[hit]]], state[fe[j[hit]]], state[at[hit]]
    code = (_arc(w, x, s1) + 2 * _arc(x, w, s1) + 4 * _arc(w, y, s2)
            + 8 * _arc(y, w, s2) + 16 * _arc(x, y, s3)
            + 32 * _arc(y, x, s3))
    table = torch.tensor(TABLE, device=dev)
    types = torch.bincount(table[code], minlength=16)
    for t in range(16):
        sums.add(("tri", t), types[t])
    cat = torch.tensor([[_CAT[(r1, r2)] for r2 in range(3)]
                        for r1 in range(3)], device=dev)
    closed = torch.cat([cat[_kind(w, x, s1), _kind(w, y, s2)],
                        cat[_kind(x, w, s1), _kind(x, y, s3)],
                        cat[_kind(y, w, s2), _kind(y, x, s3)]])
    per_cat = torch.bincount(closed, minlength=6)
    for cc in range(6):
        sums.add(("closed", cc), per_cat[cc])
    mutual = (s1 == 3).to(torch.int64) + (s2 == 3) + (s3 == 3)
    sums.add("t_mutual", mutual)
    sums.add("t_asym", 3 - mutual)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """The bit length of each non-negative integer (0 for 0), by shifts
    alone: a floating-point log2 on the card may round 2**k below k."""
    bits = torch.zeros_like(x)
    for k in range(int(x.max()).bit_length() if x.numel() else 0):
        bits += (x >> k) > 0
    return bits


def degree_stats(n: int, src: torch.Tensor, dst: torch.Tensor) -> dict:
    """Out- and in-degree log2 histograms (bin 0 for degree 0, bin b for
    degrees in [2**(b-1), 2**b), the top bin for everything larger),
    maxima and means of the digraph's distinct, loop-free arcs."""
    s, d = directed_arcs(n, src, dst)
    out = torch.bincount(s, minlength=n)
    inn = torch.bincount(d, minlength=n)

    def hist(deg):
        b = bit_length(deg).clamp(max=DEGREE_BINS - 1)
        return torch.bincount(b, minlength=DEGREE_BINS).tolist()

    m = s.numel()
    return {"out_hist": hist(out), "in_hist": hist(inn),
            "max_out": int(out.max()), "max_in": int(inn.max()),
            "mean_out": m / n, "mean_in": m / n}
