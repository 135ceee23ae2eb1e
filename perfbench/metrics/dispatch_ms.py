"""``dispatch_ms``: host ms a graph pass spends in the executor's chunk
loop, less the time it blocked on the card's in-flight window: the
``census.dispatch`` spans of the traced window less its ``census.wait``
spans, over the ``census.dispatch`` spans (the program's spans,
:mod:`perfbench.program_spans`)."""
from ..program_spans import per_pass_ms


def read(rec):
    return per_pass_ms(rec, ["census.dispatch"], ["census.wait"])
