"""The 16 triad types (MAN names) and the 64-code table, derived here
from the types' definitions.

A triad code of an ordered vertex triple ``(u, v, w)`` is

    e(u,v) + 2 e(v,u) + 4 e(u,w) + 8 e(w,u) + 16 e(v,w) + 32 e(w,v)

where ``e(x,y)`` is 1 when the arc x -> y exists.  Each code is classified
by its mutual / asymmetric / null dyad counts and, where that leaves a
choice, by the orientation of its arcs (Holland and Leinhardt's names).
"""
from __future__ import annotations

import itertools

NAMES = ("003", "012", "102", "021D", "021U", "021C", "111D", "111U",
         "030T", "030C", "201", "120D", "120U", "120C", "210", "300")

_ARCS = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))


def arcs_of(code: int) -> "set[tuple[int, int]]":
    """The arcs of a code over the vertices (u, v, w) = (0, 1, 2)."""
    return {a for bit, a in enumerate(_ARCS) if code >> bit & 1}


def code_of(arcs) -> int:
    """The code of a set of arcs over (0, 1, 2)."""
    return sum(1 << bit for bit, a in enumerate(_ARCS) if a in arcs)


def classify(arcs) -> str:
    """The MAN name of the 3-vertex digraph with these arcs."""
    arcs = set(arcs)
    pairs = list(itertools.combinations(range(3), 2))
    mutual = [p for p in pairs if p in arcs and p[::-1] in arcs]
    asym = [(i, j) if (i, j) in arcs else (j, i) for i, j in pairs
            if ((i, j) in arcs) != ((j, i) in arcs)]
    out = [sum((x, y) in arcs for y in range(3)) for x in range(3)]
    inn = [sum((y, x) in arcs for y in range(3)) for x in range(3)]
    man = (len(mutual), len(asym), 3 - len(mutual) - len(asym))
    simple = {(0, 0, 3): "003", (0, 1, 2): "012", (1, 0, 2): "102",
              (2, 0, 1): "201", (2, 1, 0): "210", (3, 0, 0): "300"}
    if man in simple:
        return simple[man]
    if man == (0, 2, 1):  # two arcs meeting at one vertex
        if 2 in out:
            return "021D"
        if 2 in inn:
            return "021U"
        return "021C"
    if man == (1, 1, 1):  # A<->B and one arc between B and C
        (src, dst), = asym
        pair = set(mutual[0])
        return "111U" if src in pair else "111D"
    if man == (0, 3, 0):
        return "030T" if 2 in out else "030C"
    # (1, 2, 0): the vertex outside the mutual pair sends, receives or passes
    c, = set(range(3)) - set(mutual[0])
    if out[c] == 2:
        return "120D"
    if inn[c] == 2:
        return "120U"
    return "120C"


#: TABLE[code] is the index in NAMES of the code's type.
TABLE = tuple(NAMES.index(classify(arcs_of(c))) for c in range(64))
