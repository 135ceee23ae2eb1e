"""The host's state over a measured window, for finding why host-paced
runs differ: the time the hypervisor stole from the machine's cores, how
busy those cores were, this process's CPU time and involuntary context
switches, Python's garbage collections, and the cores' clock.  Read from
``/proc`` and ``getrusage``; what a platform lacks is left out."""
from __future__ import annotations

import gc
import resource
import time
from pathlib import Path


def _cpu_ticks():
    """``(total, idle + iowait, steal)`` ticks of all cores, or None."""
    try:
        f = Path("/proc/stat").read_text().splitlines()[0].split()[1:]
    except OSError:
        return None
    t = [int(x) for x in f[:8]]
    return sum(t), t[3] + t[4], t[7]


def _mhz():
    """The mean clock of the cores in MHz, where ``/proc/cpuinfo`` gives
    it."""
    try:
        v = [float(line.split(":")[1])
             for line in Path("/proc/cpuinfo").read_text().splitlines()
             if line.startswith("cpu MHz")]
    except OSError:
        return None
    return sum(v) / len(v) if v else None


class HostState:
    """Started at construction; :meth:`stop` gives the window's deltas."""

    def __init__(self):
        self.gc_s = 0.0
        self.gc_runs = 0
        self._gc_t0 = None
        gc.callbacks.append(self._on_gc)
        self.ticks = _cpu_ticks()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_runs += 1
            self._gc_t0 = None

    def stop(self, window_s: float) -> dict:
        gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out = {"process_cpu_share": ((ru.ru_utime - self.ru.ru_utime)
                                     + (ru.ru_stime - self.ru.ru_stime))
               / window_s,
               "involuntary_switches": ru.ru_nivcsw - self.ru.ru_nivcsw,
               "gc_s": self.gc_s, "gc_runs": self.gc_runs}
        ticks = _cpu_ticks()
        if self.ticks and ticks and ticks[0] > self.ticks[0]:
            total = ticks[0] - self.ticks[0]
            out["steal_share"] = (ticks[2] - self.ticks[2]) / total
            out["cores_busy_share"] = 1 - (ticks[1] - self.ticks[1]
                                           + ticks[2] - self.ticks[2]) / total
        mhz = _mhz()
        if mhz is not None:
            out["cpu_mhz"] = mhz
        return out
