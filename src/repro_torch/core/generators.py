"""Synthetic graph generators (the data substrate for census experiments).

Counterpart of :mod:`repro.core.generators`: numpy RNGs seeded the same
way, so the same seed gives the same arcs in both packages.

  * ``erdos_renyi``   — uniform random digraphs,
  * ``rmat``          — Kronecker/R-MAT power-law digraphs,
  * ``paper_profile`` — R-MAT instances whose (n, m) match the paper's
                        Table 4.1 datasets, optionally scaled down
                        (``*_arcs``: the arc lists, for other constructors).
"""
from __future__ import annotations

import numpy as np

from .graph import CSRGraph, from_edges

# (vertices, arcs, directed) from Table 4.1 of the paper.
PAPER_DATASETS: dict[str, tuple[int, int, bool]] = {
    "actors": (520_223, 2_940_808, False),
    "patents": (3_774_768, 16_518_948, True),
    "amazon": (403_394, 3_387_388, True),
    "slashdot": (82_144, 549_202, True),
    "google": (916_428, 5_105_039, True),
    "eatSR": (23_219, 325_589, True),
    "NDwww": (325_729, 1_497_135, True),
}


def erdos_renyi(n: int, m: int, seed: int = 0, *, device=None) -> CSRGraph:
    """Directed G(n, m): m arcs sampled uniformly without self-loops."""
    rng = np.random.default_rng(seed)
    k = int(m * 1.3) + 16  # oversample to survive dedup/self-loop removal
    src = rng.integers(0, n, size=k, dtype=np.int64)
    dst = rng.integers(0, n, size=k, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep][:m], dst[keep][:m]
    return from_edges(n, src, dst, directed=True, device=device)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, directed: bool = True, *,
         device=None) -> CSRGraph:
    """R-MAT power-law digraph with 2**scale vertices (Graph500 defaults)."""
    n, src, dst = rmat_arcs(scale, edge_factor, a, b, c, seed)
    return from_edges(n, src, dst, directed=directed, device=device)


def rmat_arcs(scale: int, edge_factor: int = 16, a: float = 0.57,
              b: float = 0.19, c: float = 0.19, seed: int = 0):
    """The arc list :func:`rmat` builds its graph from: ``(n, src,
    dst)``, before deduplication (for a graph built another way, such as
    :func:`repro_torch.core.graph.from_edges_mmap`)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        in_cd = r >= ab  # quadrant choice per Chakrabarti et al.
        in_b_or_d = ((r >= a) & (r < ab)) | (r >= abc)
        src |= in_cd.astype(np.int64) << bit
        dst |= in_b_or_d.astype(np.int64) << bit
    # permute vertex ids to break the Kronecker locality artifact
    perm = rng.permutation(n).astype(np.int64)
    return n, perm[src], perm[dst]


def paper_profile(name: str, scale_down: float = 64.0, seed: int = 0, *,
                  device=None) -> CSRGraph:
    """R-MAT graph matching a Table 4.1 dataset's (n, m) shape.

    ``scale_down`` divides both n and m; ``scale_down=1`` is the
    published size.
    """
    n, src, dst, directed = paper_profile_arcs(name, scale_down, seed)
    return from_edges(n, src, dst, directed=directed, device=device)


def paper_profile_arcs(name: str, scale_down: float = 64.0, seed: int = 0):
    """The arc list of :func:`paper_profile`'s graph: ``(n, src, dst,
    directed)``."""
    n, m, directed = PAPER_DATASETS[name]
    n_s = max(64, int(n / scale_down))
    m_s = max(128, int(m / scale_down))
    scale = max(6, int(np.ceil(np.log2(n_s))))
    ef = max(1, int(round(m_s / (1 << scale))))
    return (*rmat_arcs(scale, edge_factor=ef, seed=seed), directed)
