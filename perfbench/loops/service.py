"""``service``: a closed loop of ``clients`` clients over one
``CensusService(ServiceConfig(census=EngineConfig(**engine),
**service))``.  Each client submits one request, a graph of the pool and
an op set drawn from the seed by the ``mix`` weights, and submits again
when its completion surfaces; a request's latency runs from its
``submit`` until then.  Where every client waits on a group that is not
full (graphs in more shape buckets than the clients can fill), the loop
flushes and counts a stall.  After the window no request is submitted, and a
``flush`` completes those still pending; only completions inside the
window count toward the metrics, every answer toward the check."""
from __future__ import annotations

import collections
import time

import numpy as np

from ..hoststate import HostState
from ..trace import Tracer, span
from . import common


def draws(seed: int, pool: int, mix: list):
    """Endless (graph index, ops) draws: every ``pool`` requests use each
    graph once and every ``sum(weights)`` requests each op set its
    weight's times, each block in an order drawn from the seed."""
    rng = np.random.default_rng(seed)
    kinds = [tuple(m["ops"]) for m in mix for _ in range(int(m["weight"]))]
    gq: collections.deque = collections.deque()
    kq: collections.deque = collections.deque()
    while True:
        if not gq:
            gq.extend(int(x) for x in rng.permutation(pool))
        if not kq:
            kq.extend(kinds[int(x)] for x in rng.permutation(len(kinds)))
        yield gq.popleft(), kq.popleft()


def run(inputs, traffic, *, seed, seconds, trace, device, t_start) -> dict:
    from repro_torch.engine import compile
    from repro_torch.serve import CensusService, ServiceConfig

    cfg = common.engine(traffic, device)
    graphs = inputs.graphs
    mix = traffic["mix"]
    scfg = ServiceConfig(census=cfg, **traffic.get("service", {}))
    t0 = time.perf_counter()
    plan = compile(graphs[0], tuple(mix[0]["ops"]), cfg)
    common.first_run(plan, graphs[0], device)
    plan_cold_s = time.perf_counter() - t0
    warm = CensusService(scfg)  # a warm batch of the whole pool per op set
    for m in mix:
        for g in graphs:
            warm.submit(g, tuple(m["ops"]))
        warm.flush()
    svc = CensusService(scfg)
    requests = draws(seed, len(graphs), mix)

    ready = collections.deque(range(int(traffic["clients"])))
    inflight: dict = {}
    answers, latency, waits, unit_s, done_t = [], [], [], [], []
    tracer = Tracer(trace, device, seconds)
    setup_s = time.time() - t_start
    launches0 = common.launches()
    submitted = stalls = 0
    host = HostState()
    start = time.perf_counter()
    tracer.begin(start)
    while True:
        t_call = time.perf_counter()
        if ready:
            client = ready.popleft()
            k, ops = next(requests)
            with span("submit"):
                rid = svc.submit(graphs[k], ops)
            submitted += 1
            inflight[rid] = (client, t_call, k, ops)
            with span("poll"):
                done = svc.poll()
        else:  # every client waits on a group that no submit can fill
            stalls += 1
            with span("flush"):
                done = svc.flush()
        now = time.perf_counter()
        unit_s.append(now - t_call)
        for c in done:
            client_c, t_sub, kc, ops_c = inflight.pop(c.request_id)
            if not tracer.started:  # host clocks the profiler has not slowed
                latency.append(now - t_sub)
                waits.append(t_call - t_sub)
            answers.append(common.answer(c, kc, ops_c))
            done_t.append(now - start)
            ready.append(client_c)
        tracer.tick(now, [a["graph"] for a in answers[len(answers)
                                                     - len(done):]])
        if now - start >= seconds and tracer.done:
            break
    window_s = now - start
    host_state = host.stop(window_s)
    tracer.stop()
    in_window = len(answers)
    stats = svc.stats()
    launches = common.launches() - launches0
    for c in svc.flush():  # outside the window: no group left pending
        _, _, kc, ops_c = inflight.pop(c.request_id)
        answers.append(common.answer(c, kc, ops_c))
    answers += [{"graph": k, "result": None} for _, _, k, _ in
                inflight.values()]
    return {"setup_s": setup_s, "plan_cold_s": plan_cold_s,
            "window_s": window_s, "graphs": in_window,
            "launches": launches, "latency_s": latency,
            "batch_wait_s": waits, "service_stats": stats, "unit_s": unit_s,
            "done_t": done_t, "host": {**host_state, "stalls": stalls},
            "answers": answers,
            "attempted": submitted,
            "failed": sum(a["result"] is None for a in answers),
            "trace": tracer.result, "traced_graphs": tracer.graph_ids}
