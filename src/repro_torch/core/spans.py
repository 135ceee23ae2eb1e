"""Program spans: named host intervals of the census path and the census
service, recorded only while a torch profiler records.

A span is a profiler range recorded by torch's low-overhead
``_RecordFunctionFast`` (``record_function`` where a torch lacks it), so
it lands in the profiler's trace as a host event beside the kernels it
launches, on the trace's one clock.  A ``record_function`` costs tens of
microseconds while a profiler records, enough to double a traced census
of ~400 chunks (six spans a chunk); this recorder costs a few.

With no profiler recording a span builds nothing: :func:`span` hands
back one shared ``nullcontext``, and the per-chunk code reads
:func:`enabled` once a pass (the executor) or once a chunk (the chunk
unit, the kernel wrapper) and takes its untraced branch.  There is no
other switch.

While a profiler records, each span also adds its count and host seconds
to a tally (:func:`totals`), which starts afresh when a profiling session
starts: the first :func:`span` that finds the profiler on after one that
found it off.  The tally lets a caller read the per-span totals of a
traced window without parsing the trace.

The spans, one name each (none starts with ``bench.``):

* ``census.run``: ``Plan.run_raw``, ``Plan.run_batch``, ``Plan.apply_delta``;
* ``census.stream``: a graph pass's device stream and chunk schedule
  (padded arrays and arc flags, dyad enumeration, the bucket sort, the
  memoized task list, a subset pass's upload);
* ``census.dispatch``: the executor's chunk loop of one pass;
* ``census.chunk``: one chunk of the in-order loop (or of a pool
  worker's), attempt, fold, counters and throttle;
* ``census.check``: ``census_csr``'s input checks;
* ``census.launch``: ``census_csr``'s output allocation and launch;
* ``census.reduce``: the chunk's partials summed into its bins;
* ``census.fold``: the chunk's contribution added into the accumulator;
* ``census.wait``: the host blocked on the card by the in-flight window;
* ``census.fetch``: the run's one device-to-host copy;
* ``census.finalize``: ``OpLayout.finalize``;
* ``service.flush``: ``CensusService`` flushing one group.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler

RUN = "census.run"
STREAM = "census.stream"
DISPATCH = "census.dispatch"
CHUNK = "census.chunk"
CHECK = "census.check"
LAUNCH = "census.launch"
REDUCE = "census.reduce"
FOLD = "census.fold"
WAIT = "census.wait"
FETCH = "census.fetch"
FINALIZE = "census.finalize"
FLUSH = "service.flush"

#: the recorder of a span (its enter and exit mark the range)
_record = getattr(torch._C._profiler, "_RecordFunctionFast",
                  torch.profiler.record_function)
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_TALLY: dict = {}  # name -> [count, host seconds] of the current session
_session_on = False  # whether the last span() found a profiler recording


def enabled() -> bool:
    """Whether a torch profiler is recording (torch's own Python flag)."""
    return _profiler._is_profiler_enabled


if not isinstance(getattr(_profiler, "_is_profiler_enabled", None), bool):
    enabled = torch._C._autograd._profiler_enabled  # a torch without it


class _Recording:
    """A profiler range ``name`` that also adds its host seconds to the
    tally when it ends."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = _record(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        with _LOCK:
            t = _TALLY.setdefault(self.name, [0, 0.0])
            t[0] += 1
            t[1] += dt
        return False


def recording(name: str) -> _Recording:
    """A recording span, for code that has already read :func:`enabled`."""
    return _Recording(name)


def span(name: str):
    """The span ``name`` if a profiler is recording, else a shared no-op
    context.  For code that runs a few times a pass; per-chunk code reads
    :func:`enabled` once and takes a branch with :func:`recording`."""
    global _session_on
    if enabled():
        if not _session_on:
            _session_on = True
            with _LOCK:
                _TALLY.clear()
        return recording(name)
    _session_on = False
    return _NULL


def totals() -> dict:
    """``{name: {"n": spans, "s": host seconds}}`` of the spans that ended
    since the current (or last) profiling session started."""
    with _LOCK:
        return {k: {"n": n, "s": s} for k, (n, s) in _TALLY.items()}
