"""``device_wait_ms``: host ms a graph pass spends waiting on the card:
the ``census.wait`` spans (a full in-flight window) and ``census.fetch``
spans (the run's one copy, which drains the card) of the traced window,
over its ``census.dispatch`` spans (the program's spans,
:mod:`perfbench.program_spans`)."""
from ..program_spans import per_pass_ms


def read(rec):
    return per_pass_ms(rec, ["census.wait", "census.fetch"])
