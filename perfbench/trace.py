"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
last whole units of the measured window, reduced to the device's busy
time, its time by kernel name and the idle gaps by what the host was
doing.  The window's host-clock readings are taken before the profiler
starts: while it runs, and for the rest of the process after it has
run, the host dispatches more slowly.

The loops label the host's phases with ``record_function`` spans whose
names start with ``SPAN_PREFIX``; an idle gap is named after the span and
the innermost host operation that cover its middle.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

#: host seconds of the measured window that the profiler covers
TRACE_SECONDS = 4.0
#: the benchmark's own spans
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.traced_window"
TOP = 10
_SCAN = 64  # events looked back to find the innermost cover of a gap


def span(name: str):
    """A host span of the benchmark's (a no-op outside a profile)."""
    return record_function(SPAN_PREFIX + name)


class Tracer:
    """Starts the profiler after the first unit that ends ``seconds -
    TRACE_SECONDS`` into the window (at once in a shorter window) and
    stops it after the first unit that ends ``TRACE_SECONDS`` later; the
    loops run on until then (``done``).  Records the graphs whose work ran
    wholly inside.  ``started`` tells the loops when to stop taking
    host-clock readings.  A profiler is started and stopped once at
    construction, in set-up: the first start in a process sets up the
    device tracing and takes seconds."""

    def __init__(self, enabled: bool, device: torch.device, seconds: float):
        self.enabled = enabled
        self.device = device
        self.lead = max(0.0, seconds - TRACE_SECONDS)
        self.started = False
        self.active = False
        self.graph_ids: list = []
        self.prof = None
        if enabled:
            with profile(activities=self._activities()):
                torch.ones(1, device=device).add_(1)
                self._sync()

    def _activities(self) -> list:
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def done(self) -> bool:
        """Whether the traced window is over (or there is none)."""
        return not self.enabled or (self.started and not self.active)

    def begin(self, t0: float) -> None:
        """The window has started at ``t0``."""
        self.w0 = t0
        if self.lead == 0:
            self._start()

    def _start(self) -> None:
        if not self.enabled:
            return
        self._sync()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.window = record_function(WINDOW_SPAN)
        self.window.__enter__()
        self.t0 = time.perf_counter()
        self.started = self.active = True

    def tick(self, now: float, graph_ids) -> None:
        """After each unit: count its graphs if it ran traced and stop
        once the traced window has lasted ``TRACE_SECONDS``; or start the
        profiler once the window has run ``seconds - TRACE_SECONDS``."""
        if self.active:
            self.graph_ids.extend(graph_ids)
            if now - self.t0 >= TRACE_SECONDS:
                self.stop()
        elif not self.started and now - self.w0 >= self.lead:
            self._start()

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False

    @property
    def result(self):
        """The traced window reduced (:func:`reduce_events`), or None
        without a trace.  Read it after the measured window: reducing the
        events takes seconds."""
        if self.prof is None:
            return None
        self.stop()
        return reduce_events(_raw_events(self.prof))


def _raw_events(prof) -> list:
    """``(name, on_device, start_ns, end_ns)`` of every traced event;
    ``on_device`` marks work on the card (kernels, copies, sets), not the
    card-side copies of the host's annotations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_dev and _annotation(e):
            continue
        start = e.start_ns()
        out.append((e.name(), on_dev, start, start + e.duration_ns()))
    return out


def _annotation(e) -> bool:
    """Whether a device-side event is a copy of a host annotation (a
    ``record_function`` span) rather than work on the card."""
    if e.name().startswith(SPAN_PREFIX):
        return True
    try:
        return bool(e.is_user_annotation())
    except AttributeError:  # not in every torch version
        return False


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _cover(starts, events, t):
    """The latest-starting event of ``events`` (sorted by start) that
    covers ``t``, looking back at most ``_SCAN`` events; or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _SCAN, -1), -1):
        if events[j][3] >= t:
            return events[j]
    return None


def reduce_events(events: list) -> dict:
    """Busy and window seconds, device time by name, and idle time by the
    host's activity, from the raw events of one traced window."""
    win = [e for e in events if e[0] == WINDOW_SPAN]
    w0, w1 = (win[0][2], win[0][3]) if win else (
        min(e[2] for e in events), max(e[3] for e in events))
    device = [e for e in events if e[1]]
    busy = _union((max(e[2], w0), min(e[3], w1)) for e in device
                  if e[3] > w0 and e[2] < w1)
    by_name: dict = defaultdict(float)
    for e in device:
        by_name[e[0]] += (e[3] - e[2]) / 1e9
    host = sorted((e for e in events if not e[1] and e[0] != WINDOW_SPAN),
                  key=lambda e: e[2])
    spans = [e for e in host if e[0].startswith(SPAN_PREFIX)]
    ops = [e for e in host if not e[0].startswith(SPAN_PREFIX)]
    span_starts = [e[2] for e in spans]
    op_starts = [e[2] for e in ops]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle: dict = defaultdict(float)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        sp = _cover(span_starts, spans, mid)
        op = _cover(op_starts, ops, mid)
        label = (sp[0][len(SPAN_PREFIX):] if sp else "outside any span")
        label += " / " + (op[0][:80] if op else "python, no torch op")
        idle[label] += (g1 - g0) / 1e9
    busy_s = sum(e - s for s, e in busy) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "kernel_s": dict(by_name),
        "device_ops": sorted(([k[:120], v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }
