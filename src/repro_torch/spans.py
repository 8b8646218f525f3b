"""Host spans of the serving path: a recorder that is off unless started.

A span is a stretch of one thread's time between two readings of
``time.perf_counter_ns()``, named for what the thread was doing, with the
id of the request it served (None for one that serves no request) and the
name of the span it lies in. ``perf_counter_ns`` is the clock a profiler
trace can be mapped from by two marks taken on one thread, so the spans of
every thread can be laid over the device's kernels and idle gaps; the
profiler itself records host spans only on the thread that started it.

    from repro_torch import spans
    spans.start()
    ...                       # serve
    recorded = spans.stop()   # .spans, .dropped

Off, each site costs one read of the module global ``on``: no call, no
allocation, no lock. On, a site appends one record under a lock, up to
``CAP`` records a session; those past the cap are counted in ``dropped``.

The port's spans (request id: the ``QueryRouter``'s sequence number, or a
bare ``ServingPipeline``'s own, carried by its tickets through a failover
re-dispatch):

    serve.queued      ``QueryRouter.submit`` (or ``ServingPipeline.submit``)
                      entered -> the encode stage takes the request off the
                      admission queue; recorded by the encode thread
    encode.upload     ``CapturedEncode``: its stream's wait on the caller's
                      stream -> the copy into the graph's static input
                      returned (blocks while the caller's stream is busy)
    scan.wait_input   the scan thread blocked for an encoded batch (no request)
    scan.wait_device  the scan thread waiting for the awaited scan's event
    scan.reply        the wait returned -> the ticket resolved, recorded and
                      its callbacks run
    scan.dispatch     the ``dispatch_ahead`` wait over and the watchdog told
                      -> the scan appended in flight (the gate and the
                      search call)
    rerank.host       inside ``scan.dispatch``: the survivors' ids on the host
                      -> the last upload of their rows issued

The four ``scan.*`` spans tile the scan thread's loop but for its
microseconds of queue polling, expiry checks and provenance.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional

# Records a session keeps (about 200 bytes each).
CAP = 1 << 18

on = False


class Span(NamedTuple):
    name: str
    rid: Optional[int]  # request id; None for a span of no request
    parent: Optional[str]  # name of the span this one lies in
    thread: int  # threading.get_native_id() of the recording thread
    start: int  # time.perf_counter_ns()
    end: int


class Recorded(NamedTuple):
    spans: List[Span]
    dropped: int  # records past the cap, not kept


_lock = threading.Lock()
_spans: List[Span] = []
_dropped = 0
_context = threading.local()


def start() -> None:
    """Turn the recorder on with an empty record of at most ``CAP`` spans."""
    global on, _spans, _dropped
    with _lock:
        _spans, _dropped = [], 0
        on = True


def stop() -> Recorded:
    """Turn the recorder off; returns what it recorded since ``start``."""
    global on, _spans
    with _lock:
        on = False
        out = Recorded(_spans, _dropped)
        _spans = []
    return out


def record(name: str, rid: Optional[int], start_ns: int, end_ns: int,
           parent: Optional[str] = None) -> None:
    """Keep one span of the calling thread (dropped if the recorder was
    stopped meanwhile)."""
    global _dropped
    span = Span(name, rid, parent, threading.get_native_id(), start_ns, end_ns)
    with _lock:
        if not on:
            return
        if len(_spans) < CAP:
            _spans.append(span)
        else:
            _dropped += 1


def enter(rid: Optional[int], parent: Optional[str] = None) -> None:
    """Mark the calling thread as serving request ``rid`` inside the span
    ``parent``, until its next ``enter``; ``record_here`` reads the mark.
    A stage thread enters each request before calling into the index or
    the encode, which know no request."""
    _context.mark = (rid, parent)


def record_here(name: str, start_ns: int, end_ns: int) -> None:
    """``record`` under the request and parent the calling thread entered
    last (none when it never entered one)."""
    rid, parent = getattr(_context, "mark", (None, None))
    record(name, rid, start_ns, end_ns, parent)
