"""The comparison that decides ``correct``: every answer the timed path
gave, op by op, against the plain reference of the graph it was asked
about.

Each op's result becomes a list of numbers, the program's and the
reference's alike (``ops/<op>.py``, found by the op's name); the number
compared is how many of them differ over all answers.  The counts are
exact integers, so each limit is 0.  ``missing`` counts answers that
never came or came as an error.
"""
from __future__ import annotations

import importlib

import torch

MISSING_LIMIT = 0


def op(name: str):
    """The module of ``ops/<name>.py``."""
    return importlib.import_module(f"perfbench.ops.{name}")


def differing(a: list, b: list) -> int:
    """How many positions of two equally long lists differ."""
    if len(a) != len(b):
        return max(len(a), len(b))
    return sum(x != y for x, y in zip(a, b))


def check(answers: list, n: int, arcs: list, *, device,
          acc=torch.int64) -> dict:
    """``{name: {"value", "limit"}}`` for the answers: each a dict with
    ``graph`` (index into ``arcs``) and ``result`` (``{op: result}``, or
    None for an answer that never came or failed)."""
    refs: dict = {}
    off = {name: 0 for a in answers if a["result"] for name in a["result"]}
    missing = 0
    for a in answers:
        if a["result"] is None:
            missing += 1
            continue
        i = a["graph"]
        for name, res in a["result"].items():
            if (i, name) not in refs:
                src, dst = (t.to(device) for t in arcs[i])
                refs[i, name] = op(name).reference_values(n, src, dst,
                                                          acc=acc)
                del src, dst
            off[name] += differing(op(name).program_values(res),
                                   refs[i, name])
    out = {op(name).NUMBER: {"value": v, "limit": op(name).LIMIT}
           for name, v in off.items()}
    if not answers:  # a window that answered nothing answered wrong
        missing = 1
    out["missing"] = {"value": missing, "limit": MISSING_LIMIT}
    return out
