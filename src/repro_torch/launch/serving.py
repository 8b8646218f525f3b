"""Double-buffered async serving pipeline (paper Fig. 5's proxy stage).

Ports ``repro/launch/serving.py`` whole. The one change: JAX's
``block_until_ready`` becomes a device-sync hook. After a search is
dispatched the scan stage records a CUDA event on the current stream
(``_record_ready``) and ``await_oldest`` waits on it (``_wait_ready``);
for CPU tensors both are no-ops. PyTorch launches asynchronously like
JAX dispatches, so the stages overlap the same way. Both stage threads
use the device's default stream, so the scan of a batch is ordered
after the encode that produced its codes.

``launch/serve.py`` historically trained, encoded, and scored one batch
at a time on one thread: the device scan sat idle while the host
binarized the next query batch. This module closes that gap with a
two-stage pipeline plus a bounded admission queue:

  * **admission queue** (``AdmissionQueue``) — a bounded FIFO in front
    of the pipeline. ``policy="block"`` back-pressures the caller when
    full (batch clients); ``policy="shed"`` rejects instead (interactive
    traffic keeps bounded latency under bursts — the paper's proxy sheds
    rather than queueing unboundedly). Every admitted request carries
    its enqueue timestamp, so the reported latency is enqueue→reply, not
    just device time.
  * **encode stage** — a background thread pulls admitted requests and
    runs ``encode_fn`` (float embedding -> packed recurrent-binary
    codes). This is the same
    thread-plus-bounded-queue machinery as ``data.pipeline
    .PrefetchLoader``: the hand-off queue holds ``encode_ahead``
    batches, so encode of batch t+1 overlaps the scan of batch t.
  * **scan stage** — a second thread pulls encoded batches and calls
    ``search_fn``. Kernel launches are asynchronous, so the next scan is
    dispatched as soon as the in-flight window (``dispatch_ahead``
    scans at once) allows, and only then is the oldest awaited (its
    CUDA event) and its ticket resolved — the device never drains
    between batches.

Single encode thread, single scan thread, FIFO queues throughout:
results come back in submission order and are bit-identical to a
sequential encode+search loop (no cross-batch state anywhere).

``SearchFn`` is any ``codes -> (scores [Q, k], ids [Q, k])`` callable —
``FlatSDC.search`` closures, ``ivf.search`` closures,
``hnsw_lite.search_hnsw_batched`` closures, and the distributed
``engine.make_*_search`` functions all qualify, so one pipeline fronts
every index family.

The admission machinery (``AdmissionQueue``, ``Ticket``,
``LatencyStats``) is deliberately separable from the stage threads: a
``ServingPipeline`` is *one replica* — the replicated tier in
``launch/proxy.py`` composes N of them behind a ``QueryRouter`` and
reuses the same queue/policy/ticket semantics at the proxy level.

Invariants (the tests in ``tests/test_serving_pipeline.py``,
``tests/test_proxy_router.py`` and ``tests/test_lifecycle.py`` rely on
these; do not weaken them in a refactor):

  * **FIFO per client** — a client that awaits its tickets in
    submission order observes results in submission order. Both stages
    are single threads fed by FIFO queues, so there is no internal
    reordering to begin with.
  * **Bit-identity vs ``serve_sequential``** — the pipeline reorders
    *time*, never *math*: for the same (encode_fn, search_fn) and the
    same batches, every resolved ticket carries exactly the
    (scores, ids) the sequential encode->scan loop produces. No
    cross-batch state exists anywhere in the stages.
  * **First-wins ticket resolution** — ``Ticket._resolve`` is atomic
    and idempotent: the scan thread, a shutdown sweep, and a proxy
    failover re-dispatch may race to resolve one ticket, but exactly
    one value/error ever sticks and completion stats are recorded
    exactly once.
  * **Quiesce means quiet** — after ``quiesce()`` returns True, every
    admitted request has resolved and the stage threads are blocked on
    empty queues, so ``swap_fns``/``new_generation`` (the live index
    lifecycle in ``launch/lifecycle.py``) mutate nothing a stage is
    reading.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Protocol, Sequence, Tuple

import torch

Array = Any


def _record_ready(*arrays) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded on the current stream of the first CUDA tensor
    in ``arrays`` (after the work that produces them); None for CPU data."""
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(a.device))
            return event
    return None


def _wait_ready(event: Optional["torch.cuda.Event"]) -> None:
    """Block until ``event`` has completed (no-op for None); a fault in the
    awaited work surfaces here as an exception."""
    if event is not None:
        event.synchronize()


class SearchFn(Protocol):
    """codes [Q, D(/2)] -> (scores [Q, k], ids [Q, k])."""

    def __call__(self, q_codes: Array) -> Tuple[Array, Array]: ...


EncodeFn = Callable[[Any], Array]


class RequestShed(RuntimeError):
    """Raised by ``submit`` when the admission queue is full (shed policy)."""


class PipelineClosed(RuntimeError):
    """Raised by ``submit`` after ``close`` — and surfaced by tickets whose
    request was still queued when a non-draining close tore the stage
    threads down."""


class DeadlineExpired(RuntimeError):
    """Surfaced by a ticket whose per-query deadline passed before its
    batch reached a stage (expired work is shed at dequeue, never
    scanned). NOT retryable: the deadline is the client's, and retrying
    against the same deadline cannot succeed."""


class ScanStalled(RuntimeError):
    """A dispatched scan exceeded the watchdog's budget without
    completing (a hung — not raising — search). The proxy tier treats
    it like a replica failure: mark unhealthy, re-dispatch in-flight
    work to the survivors."""


class IncompatibleVersion(RuntimeError):
    """A versioned request reached a tier with healthy replicas but no
    replica serving the request's embedding version — natively or
    through a registered compat encoder. NOT retryable: unlike
    ``RequestShed`` (queue pressure, transient) this is a configuration
    gap; retrying against the same tier cannot succeed until an index
    swap or a ``CompatibilityMatrix.register`` changes what is
    reachable."""


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """Typed request: what to search, under which embedding version.

    Exactly one of ``queries`` (float embeddings [B, dim] — encoded by
    the serving replica) or ``codes`` (pre-packed int codes [B, D] —
    the encode stage is bypassed) must be set.

    embedding_version — version tag of the model that produced the
        queries (None = unversioned: routes anywhere, today's default).
        The router matches it against each replica's
        ``IndexVersion.embedding_version`` and falls back to a
        ``CompatibilityMatrix`` encoder when no native replica is
        routable — degrading by version before shedding.
    k               — optional per-request truncation of the index's
        configured top-k (k <= index k; None = index default, and the
        bit-identity invariant vs ``serve_sequential`` holds only then).
    deadline        — absolute ``time.perf_counter()`` instant, same
        semantics as the ``submit(..., deadline=)`` kwarg (which wins
        when both are given).
    effort          — optional advisory effort-level hint (see
        ``proxy.EffortKnob``): the router degrades the shared knob at
        least this far before dispatch. Coarse: the knob is shared by
        the whole tier, so a hint can speed up neighbours too.
    encode_override — replica-internal: the compat encoder chosen by the
        router for a cross-version dispatch. Clients leave it None.
    """

    queries: Any = None
    codes: Any = None
    embedding_version: Optional[str] = None
    k: Optional[int] = None
    deadline: Optional[float] = None
    effort: Optional[int] = None
    encode_override: Optional[EncodeFn] = None

    def __post_init__(self):
        if (self.queries is None) == (self.codes is None):
            raise ValueError(
                "SearchRequest takes exactly one of queries= or codes="
            )
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    @property
    def payload(self) -> Any:
        return self.queries if self.queries is not None else self.codes

    @property
    def n_queries(self) -> int:
        return int(getattr(self.payload, "shape", (1,))[0])


def as_search_request(batch: Any, *,
                      deadline: Optional[float] = None) -> SearchRequest:
    """Normalize a bare query batch to a ``SearchRequest``.

    The back-compat shim: every ``submit`` accepts either form, so
    pre-existing callers (and the bit-identity tests) keep passing
    arrays. An explicit ``deadline=`` kwarg wins over the request's own
    field; a bare batch becomes an unversioned float-query request.
    """
    if isinstance(batch, SearchRequest):
        if deadline is not None and deadline != batch.deadline:
            return dataclasses.replace(batch, deadline=deadline)
        return batch
    return SearchRequest(queries=batch, deadline=deadline)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Typed result: scores/ids plus serving provenance.

    Unpacks like the legacy ``(scores, ids)`` tuple (``vals, ids =
    result`` and ``result[0]``/``result[1]`` both work), so drivers
    written against ``Ticket.result()`` need no changes.

    served_by_version — embedding version of the index that actually
        answered (may differ from the request's version during a compat
        window); None when the tier is unversioned.
    replica     — replica id that answered (None below the proxy tier).
    generation  — that replica's index generation at dispatch.
    compat_encoded — True when the query crossed versions through a
        ``CompatibilityMatrix`` encoder rather than a native replica.
    reranked    — True when the answering index served in bi-granular
        mode (coarse scan + fine rerank) rather than a single-tier scan.
    """

    scores: Array
    ids: Array
    served_by_version: Optional[str] = None
    replica: Optional[int] = None
    generation: Optional[int] = None
    compat_encoded: bool = False
    reranked: bool = False

    def __iter__(self):
        return iter((self.scores, self.ids))

    def __getitem__(self, i):
        return (self.scores, self.ids)[i]

    def __len__(self):
        return 2


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs for ``ServingPipeline`` (see module docstring).

    queue_depth    — admission-queue capacity (requests, not batches).
    policy         — "block": submit back-pressures when full;
                     "shed": submit raises ``RequestShed`` instead.
    encode_ahead   — encoded batches buffered between the stages (>= 1;
                     1 is classic double buffering).
    dispatch_ahead — scans in flight on the device at once (>= 1).
                     1 keeps device work strictly serial (encode still
                     overlaps); >1 dispatches ahead of the oldest await,
                     which hides dispatch latency on devices with a
                     command queue but can cache-thrash a shared-core
                     CPU when the corpus is bigger than cache.
    """

    queue_depth: int = 8
    policy: str = "block"
    encode_ahead: int = 1
    dispatch_ahead: int = 1

    def __post_init__(self):
        if self.policy not in ("block", "shed"):
            raise ValueError(f"policy must be block|shed, got {self.policy!r}")
        if self.queue_depth < 1 or self.encode_ahead < 1 or self.dispatch_ahead < 1:
            raise ValueError("queue_depth/encode_ahead/dispatch_ahead must be >= 1")


class Ticket:
    """Handle for one submitted batch; resolves to (scores, ids).

    ``deadline`` is an absolute ``time.perf_counter()`` instant (None =
    no deadline): a stage that dequeues the batch after it has passed
    sheds the ticket with ``DeadlineExpired`` instead of scanning it.
    """

    def __init__(self, seq: int, n_queries: int,
                 deadline: Optional[float] = None):
        self.seq = seq
        self.n_queries = n_queries
        self.deadline = deadline
        self.t_enqueue = time.perf_counter()
        self.t_reply: Optional[float] = None
        # The typed request this ticket was admitted with (None for a
        # bare-batch shim admit); cleared on resolve so a retained
        # ticket does not pin the query arrays.
        self.request: Optional[SearchRequest] = None
        # Serving provenance, populated at dispatch (replica tier) or
        # via the resolve's provenance argument (proxy tier, where
        # racing failover re-dispatches mean only the winning resolve
        # may write them).
        self.served_by_version: Optional[str] = None
        self.served_by_replica: Optional[int] = None
        self.served_by_generation: Optional[int] = None
        self.compat_encoded = False
        self.reranked = False
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._resolve_lock = threading.Lock()
        self._callbacks: List[Callable[["Ticket"], None]] = []

    def _resolve(self, value=None, error: Optional[BaseException] = None,
                 provenance: Optional[tuple] = None) -> bool:
        # Atomic first-wins: the scan thread and a shutdown sweep may
        # race to resolve the same ticket; it never resolves twice and
        # a stored value is never clobbered. Returns True to the winner
        # (so completion stats are recorded exactly once).
        # ``provenance`` = (replica, version, generation, compat,
        # reranked): the proxy tier passes it here, under the same lock,
        # because two racing inner resolutions (failover re-dispatch)
        # must not let the loser overwrite the winner's serving
        # provenance.
        with self._resolve_lock:
            if self._done.is_set():
                return False
            if provenance is not None:
                (self.served_by_replica, self.served_by_version,
                 self.served_by_generation, self.compat_encoded,
                 self.reranked) = provenance
            self.t_reply = time.perf_counter()
            self._value, self._error = value, error
            self.request = None
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        # Outside the lock: a callback may re-enter ticket/router state
        # (the proxy's failover re-dispatch does). Shielded: _resolve
        # runs on stage threads, and a raising callback would otherwise
        # kill the scan loop and strand every queued ticket behind it.
        for cb in callbacks:
            try:
                cb(self)
            except BaseException:
                pass
        return True

    def add_done_callback(self, fn: Callable[["Ticket"], None]) -> None:
        """Run ``fn(ticket)`` when the ticket resolves (immediately if it
        already has). The proxy tier uses this for eager failover: a
        replica's scan error is observed the moment the ticket fails,
        not when the client gets around to ``result()``."""
        with self._resolve_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def done(self) -> bool:
        return self._done.is_set()

    def expired(self, now: Optional[float] = None) -> bool:
        """Has this ticket's deadline passed? (False when no deadline.)"""
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) >= self.deadline

    def error(self) -> Optional[BaseException]:
        """The resolving error, or None (also None while unresolved)."""
        return self._error if self._done.is_set() else None

    def result(self, timeout: Optional[float] = None) -> Tuple[Array, Array]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"ticket {self.seq} not ready after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def search_result(self, timeout: Optional[float] = None) -> SearchResult:
        """``result()`` plus serving provenance, as a ``SearchResult``.

        The typed face of the same resolution: identical arrays (the
        raw tuple path stays bit-identical for legacy callers), wrapped
        with which version/replica/generation actually answered.
        """
        vals, ids = self.result(timeout)
        return SearchResult(
            scores=vals, ids=ids,
            served_by_version=self.served_by_version,
            replica=self.served_by_replica,
            generation=self.served_by_generation,
            compat_encoded=self.compat_encoded,
            reranked=self.reranked,
        )

    @property
    def latency_s(self) -> float:
        """Enqueue -> reply wall time (admission wait included)."""
        if self.t_reply is None:
            raise RuntimeError("ticket not resolved yet")
        return self.t_reply - self.t_enqueue


_SENTINEL = object()


class AdmissionQueue:
    """Bounded admission front: FIFO + block/shed policy + ticket minting.

    The reusable half of the serving stack — ``ServingPipeline`` puts one
    in front of its stage threads (one queue per replica), and the proxy
    tier reuses the same policy semantics across replicas (a proxy sheds
    only when *every* replica's AdmissionQueue is full).

    ``admit`` mints a ``Ticket`` (seq number, enqueue timestamp) and
    enqueues ``(ticket, payload)``. Consumers drain with ``get`` /
    ``get_nowait``; ``close`` marks the queue closed and pushes a
    sentinel so a consumer loop can terminate; ``sweep`` fails every
    still-queued ticket with ``PipelineClosed``.
    """

    def __init__(self, *, depth: int, policy: str):
        if policy not in ("block", "shed"):
            raise ValueError(f"policy must be block|shed, got {policy!r}")
        self.depth = depth
        self.policy = policy
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False
        self.shed_count = 0

    @property
    def closed(self) -> bool:
        return self._closed

    def admit(self, payload: Any, *, force_block: bool = False,
              deadline: Optional[float] = None) -> Ticket:
        """Admit one payload; returns its ``Ticket``.

        block policy: waits for queue space (back-pressure).
        shed policy: raises ``RequestShed`` when the queue is full —
        unless ``force_block`` (the proxy's failover re-dispatch must
        not drop a ticket that was already admitted once).
        ``deadline``: absolute perf_counter instant after which the
        stages shed the batch at dequeue instead of serving it.
        """
        with self._lock:
            if self._closed:
                raise PipelineClosed("submit after close")
            seq = self._seq
            self._seq += 1
        if isinstance(payload, SearchRequest):
            n = payload.n_queries
        else:
            n = int(getattr(payload, "shape", (1,))[0])
        ticket = Ticket(seq, n, deadline=deadline)
        if isinstance(payload, SearchRequest):
            ticket.request = payload
        item = (ticket, payload)
        if self.policy == "shed" and not force_block:
            try:
                self._q.put_nowait(item)
            except queue.Full:
                with self._lock:
                    self.shed_count += 1
                raise RequestShed(
                    f"admission queue full (depth={self.depth})"
                ) from None
        else:
            self._q.put(item)
        return ticket

    def get(self):
        return self._q.get()

    def get_nowait(self):
        return self._q.get_nowait()

    def take_shed(self) -> int:
        """Return and zero the shed counter (generation rollover: the
        new generation's sheds must not be conflated with the old)."""
        with self._lock:
            n, self.shed_count = self.shed_count, 0
            return n

    def close(self) -> bool:
        """Mark closed; returns True on the first call only."""
        with self._lock:
            if self._closed:
                return False
            self._closed = True
            return True

    def push_sentinel(self):
        self._q.put(_SENTINEL)

    def sweep(self):
        """Drain the queue, failing every unconsumed ticket."""
        try:
            while True:
                item = self._q.get_nowait()
                if item is not _SENTINEL:
                    item[0]._resolve(error=PipelineClosed("pipeline closed"))
        except queue.Empty:
            pass


class LatencyStats:
    """Bounded completion accounting: exact totals + a latency window.

    Retaining whole tickets (and their result arrays) would grow without
    bound on a long-running pipeline, so completions are folded into
    running counters plus a sliding window of recent latencies for
    percentiles. ``window()`` exposes the raw window so the proxy tier
    can merge replicas into one report.
    """

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.n_completed = 0
        self.n_queries = 0
        self._latencies: "collections.deque" = collections.deque(maxlen=window)

    def record(self, ticket: Ticket):
        with self._lock:
            self.n_completed += 1
            self.n_queries += ticket.n_queries
            self._latencies.append(ticket.latency_s)

    def snapshot(self) -> Tuple[int, int, List[float]]:
        with self._lock:
            return self.n_completed, self.n_queries, list(self._latencies)

    def window(self) -> List[float]:
        with self._lock:
            return list(self._latencies)


class ServingPipeline:
    """Bounded-admission, double-buffered encode->scan serving pipeline.

    One pipeline is one *replica*: ``launch/proxy.py`` composes N of
    them behind a ``QueryRouter`` for the replicated tier.
    """

    def __init__(
        self,
        encode_fn: EncodeFn,
        search_fn: SearchFn,
        *,
        config: ServingConfig = ServingConfig(),
        scan_gate: Optional[threading.Lock] = None,
    ):
        """``scan_gate``: optional lock shared by co-located replicas.

        A real accelerator's command queue executes one program at a
        time, so N replicas on one device serialise naturally. The CPU
        does not — concurrent scans oversubscribe the host cores and
        thrash shared caches — so a ``ReplicaSet`` whose replicas share
        a device passes one lock to all pipelines and the scan stages
        take turns dispatching (encode still overlaps freely).
        """
        self.encode_fn = encode_fn
        self.search_fn = search_fn
        self.config = config
        # Embedding version of the index this replica currently serves
        # (provenance only — the ROUTING decision lives in the proxy's
        # version map). Set by ``QueryRouter.set_version`` / the rolling
        # swap; None = unversioned.
        self.embedding_version: Optional[str] = None
        self._scan_gate = scan_gate
        self._admission = AdmissionQueue(
            depth=config.queue_depth, policy=config.policy
        )
        self._encoded: "queue.Queue" = queue.Queue(maxsize=config.encode_ahead)
        self._stats = LatencyStats()
        # Index generation (bumped by new_generation on a rolling swap or
        # a canary revival): stats are scoped to the current generation
        # so a revived/re-indexed replica's counters are not conflated
        # with its previous run; lifetime totals accumulate separately.
        self.generation = 0
        self._lifetime_requests = 0
        self._lifetime_queries = 0
        self._lifetime_shed = 0
        # In-flight accounting for quiesce(): tickets admitted but not
        # yet resolved (by result, error, or sweep).
        self._idle_cond = threading.Condition()
        self._inflight_n = 0
        # Orders resolve+record against a generation rollover: quiesce()
        # wakes on the resolve (inside this lock), so new_generation()
        # cannot swap the stats out between a ticket's resolve and its
        # record — the last pre-swap completion lands in its own
        # generation, never the next one's.
        self._record_lock = threading.Lock()
        # Deadline sheds (expired tickets dropped at stage dequeue):
        # counted apart from admission-queue sheds — one is the tier
        # saturated, the other is the client's budget already spent.
        self._deadline_expired = 0
        self._lifetime_deadline_expired = 0
        # Stuck-scan watchdog state: dispatch times of in-flight scans
        # (seq -> perf_counter at dispatch), oldest first. The scan
        # thread cannot police itself — a hung ``search_fn`` blocks it —
        # so ``start_watchdog`` runs a monitor thread over this map.
        self._watch_lock = threading.Lock()
        self._scan_started: "collections.OrderedDict" = (
            collections.OrderedDict()
        )
        self._watchdog_thread: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        self.watchdog_stalls = 0
        # device-idle accounting (scan thread): time spent waiting for an
        # encoded batch = the device had nothing to do.
        self._scan_idle_s = 0.0
        self._scan_busy_s = 0.0
        self._encode_thread = threading.Thread(
            target=self._encode_loop, name="serving-encode", daemon=True
        )
        self._scan_thread = threading.Thread(
            target=self._scan_loop, name="serving-scan", daemon=True
        )
        self._encode_thread.start()
        self._scan_thread.start()

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    @property
    def shed_count(self) -> int:
        return self._admission.shed_count

    def submit(self, queries: Any, *, force_block: bool = False,
               deadline: Optional[float] = None) -> Ticket:
        """Admit one query batch; returns a ``Ticket``.

        block policy: waits for queue space (back-pressure).
        shed policy: raises ``RequestShed`` when the queue is full.
        ``force_block`` overrides a shed policy with back-pressure (used
        by the proxy's failover re-dispatch, which must never drop an
        already-admitted ticket).
        ``deadline``: absolute perf_counter instant; a batch still
        queued when it passes is shed at dequeue with
        ``DeadlineExpired``, never scanned.

        ``queries`` may be a bare batch (legacy shim: encoded by
        ``encode_fn``, full index top-k — bit-identical to the
        pre-``SearchRequest`` path) or a ``SearchRequest`` (typed path:
        codes bypass the encode stage, ``k`` truncates, the request's
        own deadline applies when the kwarg is None).
        """
        if isinstance(queries, SearchRequest) and deadline is None:
            deadline = queries.deadline
        # Reserve the in-flight slot BEFORE admission: once admit() has
        # enqueued the ticket, a concurrent quiesce() must already see
        # it, or "quiesce means quiet" has a window where an admitted
        # batch is invisible and a swap mutates the stages under it.
        with self._idle_cond:
            self._inflight_n += 1
        try:
            ticket = self._admission.admit(
                queries, force_block=force_block, deadline=deadline
            )
        except BaseException:
            with self._idle_cond:
                self._inflight_n -= 1
                if self._inflight_n == 0:
                    self._idle_cond.notify_all()
            raise
        ticket.add_done_callback(self._on_ticket_resolved)
        # A close() racing this submit may have fully shut the stages
        # down with this item still unconsumed (it landed after close()'s
        # own post-join sweep). Sweep whatever remains: only unconsumed
        # items are failed — an item the stages picked up resolves with
        # its real result, and never from here. While any stage thread
        # still lives, either the item precedes the shutdown sentinel
        # (it will be served) or close()'s post-join sweep catches it.
        if self._admission.closed and not self._scan_thread.is_alive():
            self._admission.sweep()
        return ticket

    def _on_ticket_resolved(self, _ticket: Ticket):
        with self._idle_cond:
            self._inflight_n -= 1
            if self._inflight_n == 0:
                self._idle_cond.notify_all()

    def _shed_expired(self, ticket: Ticket) -> None:
        """Fail a ticket whose deadline passed while it sat queued.

        Resolve + count share ``_record_lock`` for the same reason the
        scan loop's resolve+record do: a generation rollover must not
        slip between them and book the expiry in the wrong generation.
        """
        with self._record_lock:
            if ticket._resolve(error=DeadlineExpired(
                f"ticket {ticket.seq} expired "
                f"{time.perf_counter() - ticket.deadline:.4f}s past its "
                "deadline before it was scanned"
            )):
                self._deadline_expired += 1

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Drain WITHOUT closing: wait until every admitted request has
        resolved, then return True (False on timeout, with the pipeline
        untouched and still serving).

        The stage threads stay up and ``submit`` keeps working — callers
        that need exclusive access (the rolling index swap) must stop
        routing traffic here first (``QueryRouter.drain``). Once True is
        returned, both stages are blocked on empty queues, so
        ``swap_fns``/``new_generation`` are safe.
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._idle_cond:
            while self._inflight_n > 0:
                wait = None if deadline is None \
                    else deadline - time.perf_counter()
                if wait is not None and wait <= 0:
                    return False
                self._idle_cond.wait(wait)
        return True

    def swap_fns(self, *, encode_fn: Optional[EncodeFn] = None,
                 search_fn: Optional[SearchFn] = None):
        """Hot-swap the encode/search stages on a live pipeline.

        The stages read ``self.encode_fn``/``self.search_fn`` afresh for
        every item, so on a quiesced pipeline (``quiesce() == True`` and
        no traffic being routed here) the swap is atomic per batch: a
        request is served entirely by the old program or entirely by the
        new one, never a mix. Used by the rolling index swap
        (``launch/lifecycle.py``); warm the new program first
        (``warmup_replicas``) or the first post-swap batch pays the
        one-time set-up on the worker threads.
        """
        if encode_fn is not None:
            self.encode_fn = encode_fn
        if search_fn is not None:
            self.search_fn = search_fn

    def new_generation(self) -> int:
        """Start a fresh stats generation (rolling swap / canary revival).

        A revived replica's throughput and latency must not be conflated
        with its pre-death run — completed counters fold into lifetime
        totals and the window/idle accounting resets. Call only on a
        quiesced pipeline (the scan thread also writes the idle/busy
        clocks). Returns the new generation number.
        """
        with self._record_lock:
            n_req, n_q, _ = self._stats.snapshot()
            self._lifetime_requests += n_req
            self._lifetime_queries += n_q
            self._lifetime_shed += self._admission.take_shed()
            self._lifetime_deadline_expired += self._deadline_expired
            self._deadline_expired = 0
            self._stats = LatencyStats()
            self._scan_idle_s = 0.0
            self._scan_busy_s = 0.0
            self.generation += 1
            return self.generation

    # ------------------------------------------------------------------
    # stuck-scan watchdog
    # ------------------------------------------------------------------

    def scan_oldest_age(self) -> Optional[float]:
        """Seconds the oldest in-flight scan has been running (None when
        no scan is in flight). The watchdog's probe — also usable by an
        external monitor."""
        with self._watch_lock:
            if not self._scan_started:
                return None
            t0 = next(iter(self._scan_started.values()))
        return time.perf_counter() - t0

    def _watch_begin(self, seq: int) -> None:
        with self._watch_lock:
            self._scan_started[seq] = time.perf_counter()

    def _watch_end(self, seq: int) -> None:
        with self._watch_lock:
            self._scan_started.pop(seq, None)

    def start_watchdog(
        self,
        budget_s: float,
        on_stall: Callable[["ServingPipeline", int, float], None],
        *,
        poll: Optional[float] = None,
        clock: Optional[Any] = None,
    ) -> None:
        """Watch for scans that hang past ``budget_s`` without completing.

        A hung ``search_fn`` blocks the scan thread itself, so a
        separate monitor thread checks the oldest in-flight scan's age
        every ``poll`` seconds (default ``budget_s / 4``) and calls
        ``on_stall(pipeline, seq, age)`` ONCE per stalled scan — the
        proxy tier wires this to ``QueryRouter.mark_unhealthy`` so the
        existing failover path re-dispatches the replica's in-flight
        work. The stalled scan itself is left alone: there is no safe
        way to kill it, and first-wins resolution discards its result
        if it ever completes. Idempotent while the watchdog is alive.

        ``clock`` (a ``launch.clock.Clock``) drives only the poll
        cadence; the stall-age math stays on ``time.perf_counter``
        because ``_scan_started`` records real dispatch instants.
        """
        if budget_s <= 0:
            raise ValueError(f"watchdog budget must be > 0, got {budget_s}")
        if self._watchdog_thread is not None \
                and self._watchdog_thread.is_alive():
            return
        stop = threading.Event()
        self._watchdog_stop = stop
        tick = poll if poll is not None else budget_s / 4.0
        wait_tick = (
            stop.wait if clock is None
            else (lambda t: clock.wait(stop, t))
        )

        def loop():
            last_fired = -1  # seqs are monotonic; FIFO scans never return
            while not wait_tick(tick):
                with self._watch_lock:
                    if not self._scan_started:
                        continue
                    seq, t0 = next(iter(self._scan_started.items()))
                age = time.perf_counter() - t0
                if age <= budget_s or seq <= last_fired:
                    continue
                last_fired = seq
                with self._record_lock:
                    self.watchdog_stalls += 1
                try:
                    on_stall(self, seq, age)
                except BaseException:
                    pass  # a raising handler must not kill the monitor

        self._watchdog_thread = threading.Thread(
            target=loop, name="serving-watchdog", daemon=True
        )
        self._watchdog_thread.start()

    def stop_watchdog(self) -> None:
        self._watchdog_stop.set()
        t = self._watchdog_thread
        self._watchdog_thread = None
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def close(self, drain: bool = True):
        """Shut the pipeline down; joins both stage threads.

        drain=True finishes every admitted request first; drain=False
        resolves still-queued tickets with ``PipelineClosed``.
        """
        self.stop_watchdog()
        if not self._admission.close():
            return
        if not drain:
            # Pull whatever has not reached the encode stage yet and fail
            # it; in-flight batches still complete (FIFO, bounded).
            self._admission.sweep()
        self._admission.push_sentinel()
        self._encode_thread.join()
        self._scan_thread.join()
        # Post-join sweep: a submit racing this close may have enqueued
        # after the sentinel; its item sits in the dead queue. Fail those
        # tickets (atomic first-wins _resolve keeps real results intact).
        self._admission.sweep()

    def __enter__(self) -> "ServingPipeline":
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # stage threads
    # ------------------------------------------------------------------

    def _encode_loop(self):
        while True:
            item = self._admission.get()
            if item is _SENTINEL:
                self._encoded.put(_SENTINEL)
                return
            ticket, queries = item
            if ticket.expired():
                # Shed at dequeue: an expired batch is never encoded —
                # the client's budget is spent, and the stage time would
                # only delay still-live work behind it.
                self._shed_expired(ticket)
                continue
            req = ticket.request
            try:
                if req is not None and req.codes is not None:
                    codes = req.codes  # pre-encoded: bypass the stage
                else:
                    enc = self.encode_fn
                    src = queries
                    if req is not None:
                        # Compat hop: the router re-encodes a cross-
                        # version query with the bc-trained encoder it
                        # chose for THIS replica's index version.
                        if req.encode_override is not None:
                            enc = req.encode_override
                        src = req.queries
                    codes = enc(src)
            except BaseException as e:  # surfaced on the ticket
                ticket._resolve(error=e)
                continue
            self._encoded.put((ticket, codes))

    def _scan_loop(self):
        inflight: "collections.deque" = collections.deque()

        def await_oldest():
            ticket, vals, ids, ready = inflight.popleft()
            t0 = time.perf_counter()
            try:
                _wait_ready(ready)
            except BaseException as e:
                self._watch_end(ticket.seq)
                # Busy-clock write BEFORE the resolve and inside the
                # lock: the resolve wakes quiesce(), and a generation
                # rollover must not reset the clock between them.
                with self._record_lock:
                    self._scan_busy_s += time.perf_counter() - t0
                    ticket._resolve(error=e)
                return
            self._watch_end(ticket.seq)
            self._scan_busy_s += time.perf_counter() - t0
            # One critical section for resolve + record: the resolve is
            # what wakes quiesce(), so a generation rollover waiting on
            # _record_lock cannot slip in before the record.
            with self._record_lock:
                if ticket._resolve(value=(vals, ids)):
                    self._stats.record(ticket)

        while True:
            try:
                item = self._encoded.get_nowait()
            except queue.Empty:
                # No encoded batch ready: drain an in-flight scan (the
                # device is busy, not idle) before blocking for input —
                # tail batches must resolve without waiting for close().
                if inflight:
                    await_oldest()
                    continue
                t0 = time.perf_counter()
                gen0 = self.generation
                item = self._encoded.get()
                # An idle wait that spans a new_generation() (the blocked
                # get sat through a drain/rebuild window) belongs to no
                # generation: adding it would book the whole swap as the
                # NEW generation's device idle time.
                if self.generation == gen0:
                    self._scan_idle_s += time.perf_counter() - t0
            if item is _SENTINEL:
                break
            ticket, codes = item
            if ticket.expired():
                # Shed at dequeue (same as the encode stage): the scan
                # is the expensive step — expired work must never reach
                # the device.
                self._shed_expired(ticket)
                continue
            # Provenance at dispatch (single scan thread; the only
            # racing resolvers for a replica-level ticket are error
            # paths, where provenance is moot).
            req = ticket.request
            ticket.served_by_generation = self.generation
            ticket.served_by_version = self.embedding_version
            ticket.reranked = bool(getattr(self.search_fn, "reranked",
                                           False))
            if req is not None and req.encode_override is not None:
                ticket.compat_encoded = True
            # Bound device concurrency BEFORE dispatching: at most
            # dispatch_ahead scans run at once (1 = strictly serial
            # device — on shared-core CPU, concurrent full-corpus scans
            # thrash the cache; on the card the stream serialises
            # anyway and a deeper window just hides dispatch latency).
            while len(inflight) >= self.config.dispatch_ahead:
                await_oldest()
            # Watchdog clock starts at dispatch: a hung search_fn blocks
            # right here, where this thread can no longer observe it.
            self._watch_begin(ticket.seq)
            try:
                t0 = time.perf_counter()
                if self._scan_gate is not None:
                    # Co-located replicas take turns. Launches are
                    # async, so serialising the dispatch alone would
                    # still let N scans execute concurrently — hold the
                    # gate through completion so device work really is
                    # one replica at a time.
                    with self._scan_gate:
                        vals, ids = self.search_fn(codes)
                        _wait_ready(_record_ready(vals, ids))
                else:
                    vals, ids = self.search_fn(codes)  # async dispatch
                self._scan_busy_s += time.perf_counter() - t0
            except BaseException as e:
                self._watch_end(ticket.seq)
                ticket._resolve(error=e)
                continue
            if req is not None and req.k is not None:
                # Per-request truncation of the index's top-k (a view
                # of the async result — no extra device sync).
                vals, ids = vals[:, : req.k], ids[:, : req.k]
            inflight.append((ticket, vals, ids, _record_ready(vals, ids)))
        while inflight:
            await_oldest()

    # ------------------------------------------------------------------
    # monitoring
    # ------------------------------------------------------------------

    def latency_window(self) -> List[float]:
        """Recent enqueue->reply latencies (seconds, bounded window) —
        raw material for cross-replica percentile aggregation."""
        return self._stats.window()

    def stats(self) -> dict:
        """Throughput/latency/idle summary over completed requests.

        Percentiles come from a sliding window of the most recent
        completions (the counters are exact totals) so a long-running
        pipeline's accounting stays O(1) in memory.
        """
        with self._record_lock:  # one snapshot: a concurrent generation
            # rollover must not fold the window we just read into
            # lifetime_* (it would double-count a whole generation)
            n_req, n_q, lat = self._stats.snapshot()
            lifetime_req = self._lifetime_requests + n_req
            lifetime_q = self._lifetime_queries + n_q
            shed = self.shed_count
            lifetime_shed = self._lifetime_shed + shed
            deadline_expired = self._deadline_expired
            lifetime_deadline = (
                self._lifetime_deadline_expired + deadline_expired
            )
            watchdog_stalls = self.watchdog_stalls
            generation = self.generation
            wall = self._scan_idle_s + self._scan_busy_s
            idle = self._scan_idle_s
        lat = sorted(lat)
        return {
            # Scoped to the CURRENT index generation (post last swap or
            # revival); pre-swap totals live under lifetime_*.
            "generation": generation,
            "requests": n_req,
            "queries": n_q,
            "lifetime_requests": lifetime_req,
            "lifetime_queries": lifetime_q,
            "shed": shed,
            "lifetime_shed": lifetime_shed,
            # Deadline sheds are not queue sheds: the queue had room,
            # the client's time budget did not.
            "deadline_expired": deadline_expired,
            "lifetime_deadline_expired": lifetime_deadline,
            "watchdog_stalls": watchdog_stalls,
            "latency_p50_ms": 1e3 * _percentile(lat, 0.50),
            "latency_p99_ms": 1e3 * _percentile(lat, 0.99),
            "device_idle_frac": idle / wall if wall > 0 else 0.0,
        }


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(p * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def serve_batches(
    encode_fn: EncodeFn,
    search_fn: SearchFn,
    batches: List[Any],
    *,
    config: ServingConfig = ServingConfig(),
) -> Tuple[List[Tuple[Array, Array]], dict]:
    """Run ``batches`` through a fresh pipeline; returns (results, stats).

    Results are in submission order. The admission policy is forced to
    "block" — an offline driver should back-pressure, not shed.
    """
    config = dataclasses.replace(config, policy="block")
    pipe = ServingPipeline(encode_fn, search_fn, config=config)
    try:
        tickets = [pipe.submit(b) for b in batches]
        results = [t.result() for t in tickets]
    finally:
        pipe.close()
    return results, pipe.stats()


def warmup(
    encode_fn: EncodeFn,
    search_fn: SearchFn,
    batches: List[Any],
) -> None:
    """Pay the one-time set-up of the encode + search path for BOTH drivers.

    Runs the first batch (plus the last, when its shape differs — a
    ragged tail batch may pick other library kernels) through the
    sequential loop and through a throwaway pipeline. The first call
    builds and loads the CUDA kernels; the pipeline pass matters because
    PyTorch keeps per-thread library state (a cuBLAS handle per thread),
    which the pipeline's worker threads create on first use. Call this
    before timing anything.
    """
    warm = batches[:1]
    if len(batches) > 1 and _batch_shape(batches[-1]) != _batch_shape(warm[0]):
        warm = warm + batches[-1:]
    serve_sequential(encode_fn, search_fn, warm)
    serve_batches(encode_fn, search_fn, warm)


def warmup_replicas(
    replicas: Sequence[Tuple[EncodeFn, SearchFn]],
    batches: List[Any],
) -> None:
    """``warmup`` for a replica set: every (encode, search) pair, both
    drivers, lead + ragged-tail shapes.

    One helper instead of per-driver copies because the pitfalls are
    easy to drop on a rewrite: worker threads carry **per-thread library
    state** (set up on a pipeline worker's first call), and a **ragged
    tail batch is its own shape**; both drivers and both shapes must be
    warmed or the first timed batch pays the set-up. A replica set that
    repeats one (encode, search) pair is warmed once.
    """
    seen = set()
    for encode_fn, search_fn in replicas:
        key = (id(encode_fn), id(search_fn))
        if key in seen:
            continue
        seen.add(key)
        warmup(encode_fn, search_fn, batches)


def _batch_shape(b: Any):
    return getattr(b, "shape", None)


def serve_sequential(
    encode_fn: EncodeFn,
    search_fn: SearchFn,
    batches: List[Any],
) -> List[Tuple[Array, Array]]:
    """The pre-pipeline serving loop: encode, scan, await, repeat.

    The benchmark baseline the overlapped pipeline is gated against
    (same math, no overlap).
    """
    out = []
    for b in batches:
        codes = encode_fn(b)
        vals, ids = search_fn(codes)
        _wait_ready(_record_ready(vals, ids))
        out.append((vals, ids))
    return out
