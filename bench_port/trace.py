"""The device trace of a traced run, read from ``torch.profiler``.

The profiler records the device's kernels and copies, and the CUDA
runtime calls of every thread, but CPU spans only on the thread that
started it; the harness's spans are therefore host-clock times
(``perf_counter_ns``) mapped onto the trace's clock by two marks that the
starting thread records, one at each end of the window. A kernel belongs
to the harness span of the thread whose runtime call launched it (linked
by the CUDA correlation id) when that call lies inside the span: a
renamed or split kernel still counts.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_MARK = "bench_port.clock_mark"


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start: int  # ns, trace clock
    end: int
    correlation: int


@dataclasses.dataclass
class Launch:
    name: str
    start: int
    thread: int
    correlation: int


class Trace:
    """Kernels, copies and runtime calls of the traced window, on the
    trace's clock (ns), with the map from ``perf_counter_ns``."""

    def __init__(self, device_events: List[DeviceEvent], launches: List[Launch],
                 marks: Sequence[Tuple[int, int]], w0: int, w1: int):
        self.device_events = device_events
        self.launches = sorted(launches, key=lambda ln: ln.start)
        self._launch_starts = [ln.start for ln in self.launches]
        (p0, k0), (p1, k1) = marks
        self._slope = (k1 - k0) / (p1 - p0) if p1 != p0 else 1.0
        self._p0, self._k0 = p0, k0
        self.w0, self.w1 = self.at(w0), self.at(w1)
        self._by_corr: Dict[int, List[DeviceEvent]] = {}
        for ev in device_events:
            self._by_corr.setdefault(ev.correlation, []).append(ev)

    def at(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` instant on the trace's clock."""
        return int(self._k0 + (perf_ns - self._p0) * self._slope)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's operations inside the window, in order."""
        spans = sorted((max(e.start, self.w0), min(e.end, self.w1))
                       for e in self.device_events if e.end > self.w0 and e.start < self.w1)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_ns(self, span: Tuple[int, int], threads: Sequence[int]) -> Optional[int]:
        """Device time of the kernels launched by ``threads`` inside the host
        span (``perf_counter_ns``); None when no launch was found there."""
        s, e = self.at(span[0]), self.at(span[1])
        lo = bisect.bisect_left(self._launch_starts, s)
        hi = bisect.bisect_right(self._launch_starts, e)
        total, found = 0, False
        for ln in self.launches[lo:hi]:
            if ln.thread in threads:
                for ev in self._by_corr.get(ln.correlation, ()):
                    if not ev.name.startswith(("Memcpy", "Memset")):
                        total += ev.end - ev.start
                        found = True
        return total if found else None

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time in the window: [name, s]."""
        sums: Dict[str, int] = {}
        for ev in self.device_events:
            d = min(ev.end, self.w1) - max(ev.start, self.w0)
            if d > 0:
                sums[ev.name] = sums.get(ev.name, 0) + d
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """Stretches of the window with nothing running on the device."""
        gaps, t = [], self.w0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            gaps.append((t, self.w1))
        return gaps


def mark() -> int:
    """Record a span on this (the profiling) thread; returns its
    ``perf_counter_ns`` midpoint, to be paired with its trace time."""
    a = time.perf_counter_ns()
    with torch.profiler.record_function(_MARK):
        pass
    return (a + time.perf_counter_ns()) // 2


class Profiler:
    """A ``torch.profiler`` session over the window, with clock marks."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._marks: List[int] = []

    def start(self) -> None:
        self._prof.__enter__()
        self._marks.append(mark())

    def stop(self) -> None:
        self._marks.append(mark())
        self._prof.__exit__(None, None, None)

    def trace(self, w0: int, w1: int) -> Trace:
        """Read the session; ``w0``/``w1`` bound the window (``perf_counter_ns``)."""
        events = self._prof.profiler.kineto_results.events()
        device, launches, marks = [], [], []
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                start = e.start_ns()
                device.append(DeviceEvent(name, start, start + e.duration_ns(),
                                          e.correlation_id()))
            elif name == _MARK:
                marks.append(e.start_ns() + e.duration_ns() // 2)
            elif name.startswith("cu") and e.correlation_id():
                # A runtime call's launching thread is its resource id.
                launches.append(Launch(name, e.start_ns(), e.device_resource_id(),
                                       e.correlation_id()))
        marks.sort()
        if len(marks) != 2:
            raise RuntimeError(f"expected 2 clock marks in the trace, found {len(marks)}")
        return Trace(device, launches, list(zip(self._marks, marks)), w0, w1)
