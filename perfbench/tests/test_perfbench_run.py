"""Rehearsals of ``perfbench/run.py`` on the CPU at a tiny graph size
(the test-only size override), and the faults the check has to catch."""
import numpy as np
import pytest
import torch

from perfbench.loops import service
from perfbench.tests.helpers import BENCH, rehearse

CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")


def test_a_run_without_a_card_fails_and_prints_nothing(no_card, capsys):
    from perfbench import run

    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_an_unknown_cell_fails():
    from perfbench import run

    assert run.main(["--workload", "nope.census", "--seed", "1",
                     "--seconds", "1"], device="cpu") == 2


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["amazon.census", "amazon.fleet"])
def test_last_line_shape(cell, trace):
    rc, line, err = rehearse(cell, trace=trace)
    assert rc == 0 and line["correct"] is True
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert {"process_cpu_share", "gc_s", "graphs_by_half"} <= set(
        line["host"])
    assert line["attempted"] >= 1 and line["failed"] == 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert err.strip().splitlines()[-1].startswith("check missing:")
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in BENCH[kind]}
    assert set(line["metrics"]) <= allowed
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "setup_s" not in line["metrics"]
    else:
        assert "setup_s" in line["metrics"]


def test_patents_cell_rehearses():
    rc, line, _ = rehearse("patents.census", n=128)
    assert rc == 0 and line["correct"] is True
    assert "census_ms" in line["metrics"]


def test_same_seed_same_answers():
    _, a, _ = rehearse("amazon.census", seed=5, seconds=0.1)
    _, b, _ = rehearse("amazon.census", seed=5, seconds=0.1)
    assert a["checks"] == b["checks"]


def test_fleet_draws_keep_the_mix_in_every_block():
    mix = [{"ops": ["triad_census"], "weight": 3},
           {"ops": ["triad_census", "degree_stats"], "weight": 1}]
    d = service.draws(2 ** 31 + 3, 8, mix)
    first = [next(d) for _ in range(64)]
    for block in range(8):
        graphs = [g for g, _ in first[8 * block: 8 * block + 8]]
        assert sorted(graphs) == list(range(8))
    for block in range(16):
        kinds = [len(o) for _, o in first[4 * block: 4 * block + 4]]
        assert sorted(kinds) == [1, 1, 1, 2]


class _Profiler:
    """A stand-in for the traced window: starts after its first ``lead``
    units, recording nothing."""

    done = True

    def __init__(self, lead):
        self.lead, self.started = lead, False
        self.active, self.result, self.graph_ids = False, None, []

    def begin(self, t0):
        self.started = self.active = self.lead == 0

    def tick(self, now, graph_ids):
        self.lead -= 1
        self.started = self.active = self.started or self.lead <= 0

    def stop(self):
        self.active = False


@pytest.mark.parametrize("lead,read", [(0, False), (30, True)],
                         ids=["traced_throughout", "traced_after_30_units"])
def test_fleet_reads_service_times_before_the_profiler(lead, read,
                                                       monkeypatch):
    """The latency tail and the batch wait are read from requests
    completed before the profiler starts on the window's last seconds:
    none where it runs throughout, some where it starts later."""
    monkeypatch.setattr(service, "Tracer", lambda *a: _Profiler(lead))
    _, line, _ = rehearse("amazon.fleet", seconds=1.0, trace=1)
    assert line["correct"] is True
    got = {"batch_wait_p95_ms.fleet", "fleet_p95_ms"} & set(line["metrics"])
    assert got == ({"batch_wait_p95_ms.fleet", "fleet_p95_ms"} if read
                   else set())


def test_profiler_traces_the_windows_last_seconds():
    from perfbench import trace

    t = trace.Tracer(True, torch.device("cpu"), trace.TRACE_SECONDS + 5)
    t.begin(100.0)
    t.tick(104.9, [0])
    assert not t.started and not t.done
    t.tick(105.0, [1])
    assert t.started and t.graph_ids == []
    t.tick(t.t0 + 1, [2])
    assert t.active and not t.done
    t.tick(t.t0 + trace.TRACE_SECONDS, [3])
    assert t.done and t.graph_ids == [2, 3] and t.result["window_s"] > 0
    short = trace.Tracer(True, torch.device("cpu"), 1.0)
    short.begin(0.0)
    assert short.started and not short.done
    short.stop()
    assert trace.Tracer(False, torch.device("cpu"), 1.0).done


def test_fleet_loop_terminates_with_two_groups():
    """16 clients, max_batch 8, two (bucket, ops) groups: after every
    submit some client is ready, and every request completes by the
    flush after the window."""
    rc, line, _ = rehearse("amazon.fleet", seconds=1.0, n=4096)
    assert rc == 0 and line["failed"] == 0
    assert line["host"]["stalls"] == 0  # the pool's graphs share a bucket
    assert line["checks"]["missing"]["value"] == 0
    assert line["checks"]["stats_off"]["value"] == 0


# -- faults of the timed path: the check has to come out not correct --------

def _zero(orig):
    def f(*a, **k):
        return torch.zeros_like(orig(*a, **k))
    return f


def _half(orig):
    def f(*a, **k):  # half the blocks left out, the rest counted double
        p = orig(*a, **k).clone()
        p[1::2] = 0
        p[::2] *= 2
        return p
    return f


def _altered(orig):
    def f(*a, **k):  # one count altered where it is produced
        p = orig(*a, **k).clone()
        p[0, 5] += 1
        return p
    return f


@pytest.mark.parametrize("fault", [_zero, _half, _altered],
                         ids=["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_kernel_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.engine import backends

    monkeypatch.setattr(backends, "census_csr", fault(backends.census_csr))
    rc, line, _ = rehearse(cell, seconds=0.2, n=128)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["bins_off"]["value"] > 0


def test_fleet_loop_flushes_when_no_client_can_fill_a_group():
    """At 256 vertices the pool's graphs fall in several shape buckets,
    so every client can wait on a partial group: the loop flushes, counts
    a stall and still answers every request."""
    rc, line, _ = rehearse("amazon.fleet", seconds=1.0, n=256)
    assert rc == 0 and line["correct"] is True
    assert line["host"]["stalls"] > 0


def test_fleet_rows_swapped_is_not_correct(monkeypatch):
    from repro_torch.engine import backends

    orig = backends.run_batch

    def swapped(plan, graphs):
        return np.roll(orig(plan, graphs), 1, axis=0)

    monkeypatch.setattr(backends, "run_batch", swapped)
    _, line, _ = rehearse("amazon.fleet", seconds=0.5)
    assert line["correct"] is False


def test_fleet_degree_stats_altered_is_not_correct(monkeypatch):
    from repro_torch.engine import ops

    orig = ops.DegreeStatsOp.finalize

    def altered(self, raw, g):
        r = orig(self, raw, g)
        return r._replace(max_in=r.max_in + 1)

    monkeypatch.setattr(ops.DegreeStatsOp, "finalize", altered)
    _, line, _ = rehearse("amazon.fleet", seconds=0.5)
    assert line["correct"] is False
    assert line["checks"]["stats_off"]["value"] > 0
