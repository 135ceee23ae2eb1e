"""The program's own spans over a traced window: the count and host
seconds of each ``census.*`` and ``service.*`` span that ``repro_torch``
recorded while the profiler ran (``repro_torch.core.spans.totals()``,
a tally the program keeps only while a profiler records, started afresh
with each profiling session).  A run without a trace, or a program that
records no spans, gives None."""
from __future__ import annotations

PREFIXES = ("census.", "service.")
DISPATCH = "census.dispatch"


def read(rec) -> "dict | None":
    """``{span name: {"n": count, "s": host seconds}}``, or None."""
    if not rec.get("trace"):
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    got = {k: v for k, v in spans.totals().items() if k.startswith(PREFIXES)}
    return got or None


def per_pass_ms(rec, plus, minus=()) -> "float | None":
    """The seconds of the spans ``plus`` less those of ``minus``, in ms
    per ``census.dispatch`` span (one per graph pass); None where the
    window holds no pass."""
    t = read(rec)
    if not t or not t.get(DISPATCH, {}).get("n"):
        return None
    s = (sum(t[k]["s"] for k in plus if k in t)
         - sum(t[k]["s"] for k in minus if k in t))
    return 1e3 * s / t[DISPATCH]["n"]
