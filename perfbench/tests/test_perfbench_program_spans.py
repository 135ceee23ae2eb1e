"""The program's spans and service counters as the benchmark reads them:
a traced rehearsal reports the metrics that read them, each reader gives
its value from a hand-made record, and None where there is nothing to
read: no trace, or a program without the spans and counters."""
import sys

import pytest

from perfbench import harness, program_spans, trace
from perfbench.tests.helpers import rehearse

SPANS = ("stream_ms", "dispatch_ms", "device_wait_ms")
COUNTERS = ("stale_flush_share", "queue_wait_p95_ms")

TALLY = {"census.dispatch": {"n": 4, "s": 0.4},
         "census.wait": {"n": 90, "s": 0.1},
         "census.fetch": {"n": 4, "s": 0.02},
         "census.stream": {"n": 4, "s": 0.008},
         "census.chunk": {"n": 100, "s": 0.35}}
STATS = {"flushes": {"full": 6, "stale": 3, "admission": 0, "explicit": 1},
         "queue_wait_ms": {"n": 40, "p50": 120.0, "p95": 880.5,
                           "max": 1000.0}}


@pytest.mark.parametrize("cell", ["amazon.census", "amazon.fleet"])
def test_traced_line_reports_the_program_metrics(cell, monkeypatch):
    monkeypatch.setattr(trace, "TRACE_SECONDS", 0.3)
    suffix = cell.split(".")[1]
    rc, line, _ = rehearse(cell, trace=1)
    assert rc == 0 and line["correct"] is True
    want = {f"{f}.{suffix}" for f in SPANS}
    if suffix == "fleet":
        want |= {f"{f}.fleet" for f in COUNTERS}
    assert want <= set(line["metrics"])
    assert line["metrics"][f"dispatch_ms.{suffix}"]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_readers_from_hand_made_records(monkeypatch):
    from repro_torch.core import spans

    monkeypatch.setattr(spans, "totals",
                        lambda: {**TALLY, "bench.run_raw": {"n": 4, "s": 9}})
    rec = {"trace": {"window_s": 4.0}, "service_stats": STATS}
    assert program_spans.read(rec) == TALLY
    got = {f: harness.reader(f)(rec) for f in SPANS + COUNTERS}
    assert got == pytest.approx({"stream_ms": 2.0, "dispatch_ms": 75.0,
                                 "device_wait_ms": 30.0,
                                 "stale_flush_share": 30.0,
                                 "queue_wait_p95_ms": 880.5})


def test_readers_give_none_without_anything_to_read(monkeypatch):
    import repro_torch.core

    untraced = {"trace": None, "service_stats": {"batches": 3}}
    for f in SPANS + COUNTERS:
        assert harness.reader(f)(untraced) is None, f
    # a program that records no spans: the module is not there
    monkeypatch.delattr(repro_torch.core, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    traced = {"trace": {"window_s": 4.0}}
    for f in SPANS:
        assert harness.reader(f)(traced) is None, f
    idle = {"service_stats": {"flushes": dict.fromkeys(STATS["flushes"], 0),
                              "queue_wait_ms": {"n": 0, "p50": None,
                                                "p95": None, "max": None}}}
    for f in COUNTERS:
        assert harness.reader(f)(idle) is None, f
