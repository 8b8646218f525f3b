"""Closed-loop clients, the measured window, and the harness's spans.

A traffic mix (``traffic/<name>.json``) is data for one generator of
closed loops, in which a client waits for each reply before its next request:

    clients              front ends, each one thread
    queries_per_request  rows of the query pool in one request
    warmup_requests      requests every client completes before the window
    check_queries        queries of finished requests the check samples

A client sends a request, waits for its ticket, copies the ids and scores
to the host (a front end replies from host memory; ``to_host``) and only
then sends the next one. Client c's j-th request takes the pool's rows from
``((j * clients + c) * queries_per_request) mod pool``.

The encode and the search that the harness hands to the pipeline are
wrapped (``Spans``) so that each request's encode and search calls are
timed on the host clock and the codes its encode produced are kept for
the check.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    client: int
    seq: int
    offset: int
    n_queries: int
    t_submit: int = 0  # perf_counter_ns before QueryRouter.submit
    t_admitted: int = 0  # after submit returned
    t_host: int = 0  # ids and scores on the host
    t_encode: Optional[tuple] = None  # (start, end) of its encode call
    t_search: Optional[tuple] = None  # (start, end) of its search call
    search_thread: Optional[tuple] = None  # ``thread_keys()`` of the search's thread
    codes: Any = None  # what its encode returned
    scores: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.t_host > 0


# Seconds a client waits for one reply before it counts the request failed.
REPLY_TIMEOUT_S = 120.0


def thread_keys() -> tuple:
    """The numbers a profiler trace may name this thread by: its system id,
    and its pthread id whole and cut to 32 bits (signed and unsigned)."""
    ident = threading.get_ident()
    low = ident & 0xFFFFFFFF
    return (threading.get_native_id(), ident, low, low - (1 << 32) if low >= 1 << 31 else low)


def to_host(t) -> np.ndarray:
    """A resolved answer's tensor as host memory. On the card the copy runs
    on a stream of the calling thread's own: the ticket resolved once the
    search's work had finished, and a copy queued on the device's default
    stream would wait for the scans dispatched since."""
    if not t.is_cuda:
        return t.numpy()
    stream = getattr(_client_stream, "stream", None)
    if stream is None:
        stream = _client_stream.stream = torch.cuda.Stream(t.device)
    with torch.cuda.stream(stream):
        return t.cpu().numpy()


_client_stream = threading.local()


class Spans:
    """Wraps an (encode, search) pair; records each call against the
    request whose batch (then codes) it was given."""

    def __init__(self):
        self.by_batch: Dict[int, Request] = {}
        self.by_codes: Dict[int, Request] = {}

    def encode(self, fn):
        def encode(batch):
            t0 = time.perf_counter_ns()
            codes = fn(batch)
            t1 = time.perf_counter_ns()
            rec = self.by_batch.get(id(batch))
            if rec is not None:
                rec.t_encode, rec.codes = (t0, t1), codes
                self.by_codes[id(codes)] = rec
            return codes

        return encode

    def search(self, fn):
        def search(codes):
            t0 = time.perf_counter_ns()
            out = fn(codes)
            t1 = time.perf_counter_ns()
            rec = self.by_codes.pop(id(codes), None)
            if rec is not None:
                rec.t_search = (t0, t1)
                rec.search_thread = thread_keys()
            return out

        search.reranked = getattr(fn, "reranked", False)
        return search


class Clients:
    """``traffic["clients"]`` closed-loop front ends over ``router``."""

    def __init__(self, router, pool: np.ndarray, traffic: dict, spans: Spans):
        self.router, self.pool, self.traffic, self.spans = router, pool, traffic, spans
        self.q = traffic["queries_per_request"]
        self.n = traffic["clients"]
        if self.pool.shape[0] % self.q:
            raise ValueError(f"the pool's {self.pool.shape[0]} rows are no multiple of "
                             f"{self.q} queries a request")
        self.requests: List[Request] = []
        self.completed = [0] * self.n
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._loop, args=(c,), name=f"client-{c}",
                                          daemon=True) for c in range(self.n)]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def _loop(self, c: int) -> None:
        j = 0
        while not self._stop.is_set():
            off = ((j * self.n + c) * self.q) % self.pool.shape[0]
            batch = self.pool[off:off + self.q]
            rec = Request(client=c, seq=j, offset=off, n_queries=self.q)
            self.spans.by_batch[id(batch)] = rec
            self.requests.append(rec)
            rec.t_submit = time.perf_counter_ns()
            try:
                ticket = self.router.submit(batch)
                rec.t_admitted = time.perf_counter_ns()
                scores, ids = ticket.result(timeout=REPLY_TIMEOUT_S)
                rec.scores, rec.ids = to_host(scores), to_host(ids)
                rec.t_host = time.perf_counter_ns()
            except Exception as e:  # a failed request is counted, not fatal
                rec.error = f"{type(e).__name__}: {e}"
            finally:
                self.spans.by_batch.pop(id(batch), None)
            self.completed[c] += 1
            j += 1

    def wait_warm(self, timeout_s: float) -> None:
        """Until every client has finished ``warmup_requests`` requests."""
        want = self.traffic["warmup_requests"]
        end = time.monotonic() + timeout_s
        while min(self.completed) < want:
            if time.monotonic() > end:
                raise RuntimeError(f"warm-up: clients finished {self.completed} of {want} "
                                   f"requests in {timeout_s:.0f} s")
            if any(r.error for r in self.requests):
                raise RuntimeError(f"warm-up request failed: "
                                   f"{next(r.error for r in self.requests if r.error)}")
            time.sleep(0.01)

    def stop(self, timeout_s: float) -> bool:
        """Send nothing more; wait for the requests in flight. True when
        every client thread has ended."""
        self._stop.set()
        end = time.monotonic() + timeout_s
        for t in self._threads:
            t.join(max(0.0, end - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)


def window_requests(requests: List[Request], t0: int, t1: int) -> List[Request]:
    """The requests the window owes: sent inside it, or answered inside it."""
    return [r for r in requests
            if t0 <= r.t_submit <= t1 or (r.done and t0 <= r.t_host <= t1)]


def completed_in(requests: List[Request], t0: int, t1: int) -> List[Request]:
    """Requests answered inside [t0, t1] without an error."""
    return [r for r in requests if r.error is None and r.done and t0 <= r.t_host <= t1]
