"""The census's work and the card's peaks: the least time an NVIDIA H100
could take for one graph's census, whatever kernel computes it.

The work is counted from the graph alone, never from how the program
chunks, pads, buckets or flags it:

* compares: for each canonical dyad {u, v}, the smaller neighbourhood
  searched in the larger, ``min(deg u, deg v) * ceil(log2(max(deg u,
  deg v) + 1))`` int32 compares (``deg``: undirected degree);
* bytes: the graph's two CSRs (undirected neighbourhoods and out-arcs,
  int32 offsets and columns) and the dyad list (two int32 a dyad), read
  once, and the 16 int64 bins written once.

The bound is the larger of compares over the int32 lane rate and bytes
over the HBM rate.
"""
from __future__ import annotations

import torch

from .reference import bit_length, directed_arcs, dyads

#: NVIDIA H100 SXM5 80 GB HBM3, data sheet: bytes/s
HBM_BYTES_PER_S = 3.35e12
#: int32 operations/s, derived from the architecture and not published:
#: 132 SMs x 64 int32 lanes x 1,980 MHz (boost clock)
INT32_OPS_PER_S = 132 * 64 * 1.980e9
BINS = 16


def census_work(n: int, src: torch.Tensor, dst: torch.Tensor) -> dict:
    """``compares``, ``bytes`` and ``bound_s`` of the census of the digraph
    with arcs ``src -> dst`` (self-loops and repeats dropped)."""
    s, d = directed_arcs(n, src, dst)
    key, _ = dyads(n, s, d)
    a, b = key // n, key % n
    deg = (torch.bincount(a, minlength=n)
           + torch.bincount(b, minlength=n)).to(torch.int64)
    small = torch.minimum(deg[a], deg[b])
    large = torch.maximum(deg[a], deg[b])
    # ceil(log2(x + 1)) of an integer x >= 1 is its bit length
    compares = int((small * bit_length(large)).sum())
    D, m = key.numel(), s.numel()
    nbytes = (4 * (n + 1) + 4 * 2 * D      # undirected CSR
              + 4 * (n + 1) + 4 * m        # out-arc CSR
              + 8 * D                      # dyad list
              + 8 * BINS)                  # bins written
    return {"compares": compares, "bytes": nbytes,
            "bound_s": max(compares / INT32_OPS_PER_S,
                           nbytes / HBM_BYTES_PER_S)}
