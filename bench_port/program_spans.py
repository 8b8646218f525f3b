"""The port's own spans (``repro_torch/spans.py``) over a run: what the
readers of the span metrics share.

A traced run whose recorder was on between the profiler's start and stop
carries the records in ``run.spans`` (Span-like tuples: ``name``, ``rid``,
``parent``, ``thread``, ``start``, ``end``; ``perf_counter_ns``, the clock
``trace.Trace.at`` maps onto the device trace). Without them, or without
what a reader reads, a reader returns None and its metric is left out.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

# The scan thread's spans; they tile its loop and never overlap.
SCAN_SPANS = ("scan.wait_input", "scan.wait_device", "scan.reply", "scan.dispatch")
SDC_TOPK_KERNELS = ("sdc_scan_kernel", "sdc_merge_kernel")


def named(run, name: str) -> list:
    return [s for s in (getattr(run, "spans", None) or ()) if s.name == name]


def in_window(run, name: str) -> list:
    """The spans of ``name`` that start inside the window."""
    return [s for s in named(run, name) if run.t0 <= s.start <= run.t1]


def mean_ms(spans) -> Optional[float]:
    return sum(s.end - s.start for s in spans) / len(spans) / 1e6 if spans else None


def idle_split(run) -> Optional[Dict[str, int]]:
    """The window's device idle time (trace ns) by the scan thread's span
    open then, and under ``none`` the idle time in none of them; None
    without spans, a trace or exactly one scan thread."""
    if getattr(run, "spans", None) is None or run.trace is None:
        return None
    scan = [s for s in run.spans if s.name in SCAN_SPANS]
    if len({s.thread for s in scan}) != 1:
        return None
    tr = run.trace
    marks = sorted((tr.at(s.start), tr.at(s.end), s.name) for s in scan)
    starts = [m[0] for m in marks]
    split = dict.fromkeys(SCAN_SPANS + ("none",), 0)
    for g0, g1 in tr.idle_gaps():
        covered = 0
        # One thread's spans do not overlap: none before the last to start by g0 reaches it.
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(marks) and marks[i][0] < g1:
            s, e, name = marks[i]
            overlap = min(e, g1) - max(s, g0)
            if overlap > 0:
                split[name] += overlap
                covered += overlap
            i += 1
        split["none"] += (g1 - g0) - covered
    return split


def idle_share(run, names) -> Optional[float]:
    """% of the traced window the device idled under the scan spans ``names``."""
    split = idle_split(run)
    if split is None:
        return None
    return 100.0 * sum(split[n] for n in names) / (run.trace.w1 - run.trace.w0)


def launch_coverage(run) -> Optional[List[int]]:
    """[inside, all] of the window's ``sdc_topk`` launch calls: those whose
    call lies inside a ``scan.dispatch`` of the thread that made it. The
    trace names a thread by any of ``load.thread_keys()``; the search
    threads' keys map them onto the spans' native ids."""
    if getattr(run, "spans", None) is None or run.trace is None:
        return None
    tr = run.trace
    alias = {k: r.search_thread[0] for r in run.requests if r.search_thread
             for k in r.search_thread}
    dispatch: Dict[int, list] = {}
    for s in named(run, "scan.dispatch"):
        dispatch.setdefault(s.thread, []).append((tr.at(s.start), tr.at(s.end)))
    for v in dispatch.values():
        v.sort()
    corr = {ev.correlation for ev in tr.device_events
            if any(k in ev.name for k in SDC_TOPK_KERNELS)}
    inside = total = 0
    for ln in tr.launches:
        if ln.correlation not in corr or not tr.w0 <= ln.start <= tr.w1:
            continue
        total += 1
        own = dispatch.get(alias.get(ln.thread, ln.thread), [])
        i = bisect.bisect_right(own, (ln.start, float("inf"))) - 1
        inside += i >= 0 and own[i][0] <= ln.start <= own[i][1]
    return [inside, total]
