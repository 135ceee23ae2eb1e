"""Triad isomorphism tables for the sub-quadratic Triad Census algorithm.

The paper (Fig. 2.5) computes a 6-bit *triad code* for an ordered vertex
triple ``(u, v, w)``::

    code =      IsEdge(u, v)
         + 2  * IsEdge(v, u)
         + 4  * IsEdge(u, w)
         + 8  * IsEdge(w, u)
         + 16 * IsEdge(v, w)
         + 32 * IsEdge(w, v)

and maps the 64 possible codes onto the 16 isomorphism classes (MAN naming:
003, 012, 102, 021D, 021U, 021C, 111D, 111U, 030T, 030C, 201, 120D, 120U,
120C, 210, 300).  Rather than hard-coding the 64-entry table we *derive* it
here by canonicalizing every 3-vertex digraph under the 6 vertex
permutations and classifying each class structurally.  ``tests/test_triads``
asserts the known class multiplicities (1,6,3,3,3,6,6,6,6,2,3,3,3,6,6,1).
"""
from __future__ import annotations

import itertools

import numpy as np

# Canonical ordering of the 16 isomorphic triad types (index 0..15 = type 1..16).
TRIAD_NAMES: tuple[str, ...] = (
    "003", "012", "102", "021D", "021U", "021C", "111D", "111U",
    "030T", "030C", "201", "120D", "120U", "120C", "210", "300",
)


def _code_to_adj(code: int) -> np.ndarray:
    """6-bit triad code -> 3x3 adjacency matrix over vertices (u,v,w)=(0,1,2)."""
    a = np.zeros((3, 3), dtype=np.int64)
    a[0, 1] = (code >> 0) & 1
    a[1, 0] = (code >> 1) & 1
    a[0, 2] = (code >> 2) & 1
    a[2, 0] = (code >> 3) & 1
    a[1, 2] = (code >> 4) & 1
    a[2, 1] = (code >> 5) & 1
    return a


def _adj_to_code(a: np.ndarray) -> int:
    return int(
        a[0, 1] + 2 * a[1, 0] + 4 * a[0, 2] + 8 * a[2, 0] + 16 * a[1, 2] + 32 * a[2, 1]
    )


def _classify(a: np.ndarray) -> str:
    """Name the isomorphism class of a 3-vertex digraph via MAN + orientation."""
    pairs = [(0, 1), (0, 2), (1, 2)]
    mut = sum(1 for i, j in pairs if a[i, j] and a[j, i])
    asym = sum(1 for i, j in pairs if a[i, j] != a[j, i])
    null = 3 - mut - asym
    man = (mut, asym, null)
    outdeg = a.sum(axis=1)
    indeg = a.sum(axis=0)
    if man == (0, 0, 3):
        return "003"
    if man == (0, 1, 2):
        return "012"
    if man == (1, 0, 2):
        return "102"
    if man == (0, 2, 1):
        # 021D: out-star (A<-B->C); 021U: in-star (A->B<-C); 021C: path.
        if outdeg.max() == 2:
            return "021D"
        if indeg.max() == 2:
            return "021U"
        return "021C"
    if man == (1, 1, 1):
        # outsider = vertex not in the mutual dyad.
        for k in range(3):
            i, j = [x for x in range(3) if x != k]
            if a[i, j] and a[j, i]:
                outsider = k
                break
        # statnet convention: 111D = A<->B<-C (outsider sends), 111U = A<->B->C.
        return "111D" if outdeg[outsider] == 1 else "111U"
    if man == (0, 3, 0):
        # 030C: directed 3-cycle (all outdeg 1); 030T: transitive.
        return "030C" if (outdeg == 1).all() else "030T"
    if man == (1, 2, 0):
        for k in range(3):
            i, j = [x for x in range(3) if x != k]
            if a[i, j] and a[j, i]:
                outsider = k
                break
        if outdeg[outsider] == 2:
            return "120D"
        if indeg[outsider] == 2:
            return "120U"
        return "120C"
    if man == (2, 0, 1):
        return "201"
    if man == (2, 1, 0):
        return "210"
    if man == (3, 0, 0):
        return "300"
    raise AssertionError(f"unreachable MAN {man}")


def _build_table() -> np.ndarray:
    perms = list(itertools.permutations(range(3)))
    table = np.zeros(64, dtype=np.int32)
    for code in range(64):
        a = _code_to_adj(code)
        # classification is permutation-invariant; classify directly.
        name = _classify(a)
        table[code] = TRIAD_NAMES.index(name)
        # sanity: all permuted forms classify identically.
        for p in perms:
            pa = a[np.ix_(p, p)]
            assert _classify(pa) == name, (code, p)
    return table


#: 64-entry map: 6-bit triad code -> isomorphic type index in [0, 16).
TRIAD_TABLE_64: np.ndarray = _build_table()

#: Expected number of labeled codes per isomorphic class (well-known constants).
CLASS_MULTIPLICITY: np.ndarray = np.bincount(TRIAD_TABLE_64, minlength=16)
