"""``census``: one client running back-to-back censuses of the pool's
graphs in turn (``compile(g, ops, EngineConfig(**engine)).run_raw(g)``
and the layout's ``finalize``), each graph resident on the card."""
from __future__ import annotations

import time

from ..hoststate import HostState
from ..trace import Tracer, span
from . import common


def run(inputs, traffic, *, seed, seconds, trace, device, t_start) -> dict:
    from repro_torch.engine import compile

    ops = tuple(traffic.get("ops", ("triad_census",)))
    cfg = common.engine(traffic, device)
    graphs = inputs.graphs
    t0 = time.perf_counter()
    plan = compile(graphs[0], ops, cfg)
    common.first_run(plan, graphs[0], device)
    plan_cold_s = time.perf_counter() - t0
    plans = [compile(g, ops, cfg) for g in graphs]
    for p, g in zip(plans, graphs):  # a warm run of every graph
        p.layout.finalize(p.run_raw(g), g)
    tracer = Tracer(trace, device, seconds)
    setup_s = time.time() - t_start
    launches0 = common.launches()
    answers, unit_s, done_t = [], [], []
    host = HostState()
    start = now = time.perf_counter()
    tracer.begin(start)
    i = 0
    while True:
        k = i % len(graphs)
        before = now
        with span("run_raw"):
            raw = plans[k].run_raw(graphs[k])
        with span("finalize"):
            res = plans[k].layout.finalize(raw, graphs[k])
        answers.append({"graph": k, "result": res})
        i += 1
        now = time.perf_counter()
        unit_s.append(now - before)
        done_t.append(now - start)
        tracer.tick(now, [k])
        if now - start >= seconds and tracer.done:
            break
    window_s = now - start
    host_state = host.stop(window_s)
    tracer.stop()
    return {"setup_s": setup_s, "plan_cold_s": plan_cold_s,
            "window_s": window_s, "graphs": i,
            "launches": common.launches() - launches0, "answers": answers,
            "unit_s": unit_s, "done_t": done_t, "host": host_state,
            "attempted": i, "failed": 0, "trace": tracer.result,
            "traced_graphs": tracer.graph_ids}
