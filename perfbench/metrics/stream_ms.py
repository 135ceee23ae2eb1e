"""``stream_ms``: host ms a graph pass spends building its device stream
and chunk schedule (padded arrays and arc flags, dyad enumeration, the
bucket sort, the task list): the ``census.stream`` spans of the traced
window over its ``census.dispatch`` spans (the program's spans,
:mod:`perfbench.program_spans`)."""
from ..program_spans import per_pass_ms


def read(rec):
    return per_pass_ms(rec, ["census.stream"])
