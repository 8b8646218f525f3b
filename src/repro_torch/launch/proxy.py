"""Replicated serving tier: query router + proxy admission over N replicas
(ports ``repro/launch/proxy.py`` whole; it is pure Python over
``launch/serving.py``).

The paper's production engine (Fig. 5) does not serve from one pipeline:
a proxy tier spreads high-concurrency query streams over *replicas* of
the whole index and degrades gracefully when one goes down (cf. the
proxy/replica designs in *Embedding-based Retrieval in Facebook Search*
and *Recurrent Binary Embedding*). This module is that tier at library
scale, built entirely from ``launch/serving.py``'s admission machinery:

  * ``ReplicaSet`` — N ``ServingPipeline`` replicas. Each replica is a
    full copy of the serving path (encode + ``SearchFn``): a single-host
    flat/IVF/HNSW closure, or a distributed engine closure
    (``engine.*_search_from_snapshot``) over its own replica ``LeafMesh``
    (``mesh.make_replica_meshes`` partitions the devices into one mesh a
    replica — each replica shards the whole corpus over *its* leaves).
  * ``QueryRouter`` — routes each submitted batch to one replica under a
    pluggable policy (``round-robin`` | ``least-outstanding``), with

      - **cross-replica shedding**: under a shed policy, a batch that
        bounces off one replica's full admission queue is offered to the
        others; the proxy sheds only when *every* healthy replica is
        saturated (a single hot replica must not bounce traffic the
        tier has capacity for);
      - **failover**: a replica whose encode/scan raises is marked
        unhealthy and every ticket in flight on it is re-dispatched to
        the survivors — the proxy-level analogue of
        the engine's failover ``leaf_alive`` mask, except a
        replica holds the *whole* corpus, so failover costs a retry, not
        recall. Re-dispatch back-pressures instead of shedding (an
        admitted ticket is never dropped) and results stay bit-identical
        to single-replica serving, so a client awaiting its tickets in
        submission order sees an unchanged FIFO stream.

Every replica scores through the same kernels and every replica returns
bit-identical (scores, ids) for the same batch, which is what makes
routing and failover invisible to correctness: only latency and
throughput change.

On the card a replica's result is a pair of CUDA tensors that its
pipeline makes safe to read with an event recorded after the scan; the
router resolves a proxy ticket only from a done replica ticket, so it
adds no host read per ticket. A canary probe with ``expect`` is the one
place the router reads results on the host (``torch.equal`` on host
copies: bit identity, off the hot path).

Replica health is a five-state machine (per replica, owned by the
router; ``launch/lifecycle.py`` drives the swap transitions)::

            failure                     drain()
  healthy ─────────► unhealthy   healthy ─────► draining
     ▲                   │                          │ begin_rebuild()
     │ canary ok         │ probe()                  ▼
  probing ◄──────────────┘◄──────────────────── rebuilding

Only ``healthy`` replicas are routable. ``unhealthy`` is no longer
forever: a canary probe (``probe`` / the ``start_health_probe`` thread)
re-admits a replica whose transient fault has cleared — and every
re-admission bumps the replica pipeline's ``generation`` so its stats
are not conflated with the previous run.

Invariants (relied on by ``tests/test_proxy_router.py`` and
``tests/test_lifecycle.py``):

  * **FIFO per client** — a client awaiting its proxy tickets in
    submission order sees results in submission order, across routing,
    failover re-dispatch, and rolling swaps.
  * **Bit-identity vs ``serve_sequential``** — every replica serves the
    same math, so routed results equal the single-threaded loop's
    exactly, before, during, and after a swap to an equivalent index.
  * **First-wins ticket resolution** — a ``ProxyTicket`` is resolved
    exactly once (the router is the only resolver); a failover or drain
    re-dispatch racing a late success never clobbers a stored result.
  * **Admitted is never dropped** — failover and drain re-dispatch with
    ``force_block``; only ``submit`` itself may shed (or a deadline
    expire — the client's budget, not the tier's choice).

On top of routing and failover sits the robustness layer:

  * **deadlines** — ``submit(..., deadline=...)`` threads a per-query
    budget down to the replica stages, which shed expired batches at
    dequeue (``DeadlineExpired``, counted apart from queue sheds, and
    never treated as a replica failure);
  * **stuck-scan watchdogs** — ``start_watchdogs(budget_s)`` puts a
    monitor on every replica pipeline; a scan that hangs (instead of
    raising) past its budget marks the replica unhealthy with
    ``ScanStalled`` and the ordinary failover path re-dispatches its
    in-flight work — a hung replica no longer deadlocks the tier;
  * **graceful degradation** — ``enable_degradation(knob)`` steps a
    shared ``EffortKnob`` down (HNSW ef/beam, IVF nprobe) under queue
    pressure or near-deadline *before* any query is shed, and back up
    when pressure clears; degraded dispatches are counted per replica;
  * **retry + flap suppression** — ``submit_with_retry`` backs off
    (exponential + seeded jitter) on retryable ``RequestShed``; the
    health-probe loop backs off probing a replica whose revivals keep
    failing (``probe_backoff``) so a flapper cannot monopolise it.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import spans
from repro_torch.launch.clock import SYSTEM_CLOCK, Clock
from repro_torch.launch.serving import (
    Array,
    DeadlineExpired,
    EncodeFn,
    IncompatibleVersion,
    LatencyStats,
    PipelineClosed,
    RequestShed,
    ScanStalled,
    SearchFn,
    SearchRequest,
    ServingConfig,
    ServingPipeline,
    Ticket,
    as_search_request,
    _percentile,
)

logger = logging.getLogger(__name__)


def _host_equal(a: Any, b: Any) -> bool:
    """``np.array_equal`` for tensors (on any device) and arrays alike:
    same shape and the same values, compared on host copies with
    ``torch.equal`` (bit identity, never a tolerance)."""
    a, b = (x.detach().cpu() if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.ascontiguousarray(x)) for x in (a, b))
    if a.shape != b.shape:
        return False
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.equal(a.to(dtype), b.to(dtype))


class AllReplicasDown(RuntimeError):
    """Raised by ``QueryRouter.submit`` when every replica is unhealthy
    (a transiently out-of-service tier — drain/rebuild/probe in flight —
    raises the retryable ``RequestShed`` instead)."""


#: Per-replica health states (see the module docstring's diagram).
#: "retired" (added with the autoscaler) is terminal: a scaled-down
#: replica's slot — drained losslessly, pipeline closed, never probed
#: or routed again. Slots are never renumbered (every per-replica dict
#: is keyed by index), so retirement tombstones instead of deleting.
REPLICA_STATES = ("healthy", "draining", "rebuilding", "probing",
                  "unhealthy", "retired")

#: States a replica can never leave / serve from again. For routability
#: math ("is the tier transiently empty or genuinely down?") retired
#: slots count like unhealthy ones — except no probe will ever revive
#: them.
_GONE_STATES = ("unhealthy", "retired")


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------


class RoundRobin:
    """Cycle over healthy replicas; ties traffic evenly by arrival."""

    name = "round-robin"

    def __init__(self):
        self._next = 0

    def order(self, healthy: List[int], outstanding: Dict[int, int]) -> List[int]:
        k = self._next % len(healthy)
        self._next += 1
        return healthy[k:] + healthy[:k]


class LeastOutstanding:
    """Prefer the replica with the fewest un-replied tickets — adapts to
    replicas of unequal speed (a straggler accumulates outstanding work
    and stops receiving new batches until it drains)."""

    name = "least-outstanding"

    def order(self, healthy: List[int], outstanding: Dict[int, int]) -> List[int]:
        return sorted(healthy, key=lambda i: (outstanding.get(i, 0), i))


ROUTING_POLICIES = {
    RoundRobin.name: RoundRobin,
    LeastOutstanding.name: LeastOutstanding,
}


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------


class EffortKnob:
    """Shared mutable search-effort level: 0 = full effort, each step up
    trades recall for latency.

    The index closures read ``knob.level`` per call
    (``ivf_search_from_snapshot(..., effort=knob)`` halves nprobe or the
    probe budget per level), and the router steps the same knob object
    down under pressure and back up when it clears. Bi-granular closures
    (``rerank=``) spend levels on a cheaper axis first: each level halves
    ``k_coarse`` (floored at k) and only the residual levels fall through
    to nprobe or the budget (``index._snapshot.split_effort``).
    Thread-safe; reads are a bare int load so the search path pays
    nothing.
    """

    def __init__(self, n_levels: int = 3):
        if n_levels < 1:
            raise ValueError(f"EffortKnob needs n_levels >= 1, got {n_levels}")
        self.max_level = n_levels - 1
        self._lock = threading.Lock()
        self._level = 0
        self.degrade_count = 0
        self.restore_count = 0

    @property
    def level(self) -> int:
        return self._level

    def degrade(self) -> bool:
        """Step effort down one level; False when already at the floor."""
        with self._lock:
            if self._level >= self.max_level:
                return False
            self._level += 1
            self.degrade_count += 1
            return True

    def restore(self) -> bool:
        """Step effort back up one level; False when already at full."""
        with self._lock:
            if self._level <= 0:
                return False
            self._level -= 1
            self.restore_count += 1
            return True

    def reset(self) -> None:
        with self._lock:
            self._level = 0


# ---------------------------------------------------------------------------
# embedding-version compatibility
# ---------------------------------------------------------------------------


def _embedding_version(v: Any) -> Optional[str]:
    """Embedding version of a replica's recorded index version.

    ``set_version`` stores whatever the lifecycle hands it — an
    ``IndexVersion`` (which carries ``.embedding_version``) or a bare
    string tag. None = unversioned (routes any traffic)."""
    return getattr(v, "embedding_version", v)


class CompatibilityMatrix:
    """(query_version, index_version) -> compat encoder.

    The serving face of backward-compatible training (paper §3.2.3):
    ``bc_train_step`` anchors a new binarizer's output space to the old
    one's, so a query from either model can be encoded INTO the other's
    binary index without re-encoding the corpus. Registering
    ``(qv, iv) -> enc`` declares: a version-``qv`` float query, encoded
    by ``enc``, searches a version-``iv`` index at the bc recall floor.

    The router consults this at dispatch: a v2 query preferring a v2
    replica falls back to a v1 replica *through* the registered encoder
    when no native replica is routable — degrade by version before
    shedding, the version-axis analogue of the ``EffortKnob`` ladder.

    Same-version and unversioned pairs never need (or get) an entry:
    ``lookup`` returns None for them and the replica's own encoder runs.
    Thread-safe; ``register`` is how a live tier learns a new upgrade
    path mid-flight.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._enc: Dict[Tuple[str, str], EncodeFn] = {}

    def register(self, query_version: str, index_version: str,
                 encode_fn: EncodeFn) -> None:
        if query_version is None or index_version is None:
            raise ValueError("compat pair versions must be non-None")
        if query_version == index_version:
            raise ValueError(
                f"same-version pair {query_version!r} needs no compat encoder"
            )
        with self._lock:
            self._enc[(query_version, index_version)] = encode_fn

    def lookup(self, query_version: Optional[str],
               index_version: Optional[str]) -> Optional[EncodeFn]:
        """The compat encoder for a cross-version hop, else None.

        None also for native pairs (same version, or either side
        unversioned) — "no encoder needed", not "unreachable"; use
        ``compatible`` to distinguish."""
        if query_version is None or index_version is None \
                or query_version == index_version:
            return None
        with self._lock:
            return self._enc.get((query_version, index_version))

    def compatible(self, query_version: Optional[str],
                   index_version: Optional[str]) -> bool:
        if query_version is None or index_version is None:
            return True
        return (query_version == index_version
                or self.lookup(query_version, index_version) is not None)

    def pairs(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._enc)


def probe_backoff(interval: float, consecutive_failures: int,
                  *, cap_factor: float = 16.0) -> float:
    """Extra wait before re-probing a replica that failed its last
    ``consecutive_failures`` revival probes: ``interval * 2^(n-1)``,
    capped at ``cap_factor * interval``.

    Flap suppression: a replica that keeps failing its canary gets
    probed at 1x, 2x, 4x, ... the base interval instead of every tick —
    a permanently dead (or flapping) replica stops monopolising the
    probe loop, while the first retry is as fast as ever.
    """
    if consecutive_failures <= 0:
        return 0.0
    return interval * min(cap_factor,
                          2.0 ** (consecutive_failures - 1))


# ---------------------------------------------------------------------------
# replica set
# ---------------------------------------------------------------------------


class ReplicaSet:
    """N serving replicas, each its own ``ServingPipeline``.

    ``replicas`` is a sequence of (encode_fn, search_fn) pairs — one per
    replica. Engine replicas close over their own submesh program (see
    ``mesh.make_replica_meshes``); single-host replicas may simply share
    one index closure N times (N pipelines over the same arrays).
    """

    def __init__(
        self,
        replicas: Sequence[Tuple[EncodeFn, SearchFn]],
        *,
        config: ServingConfig = ServingConfig(),
        share_device: bool = False,
    ):
        """``share_device=True`` when the replicas are co-located on one
        device (N admission fronts over one card, or the CPU): their scan
        stages then share a lock and take turns, each holding it until
        its scan has finished (a CUDA event on the card), the way a
        device command queue serialises programs — without it,
        concurrent CPU scans oversubscribe the shared cores and every
        replica gets slower. Replicas on disjoint devices
        (``mesh.make_replica_meshes``) should keep the default False."""
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        self.config = config
        # Kept so replicas added later (autoscaler scale-up) join the
        # same device command queue as the originals.
        self._scan_gate = threading.Lock() if share_device else None
        self.pipelines = [
            ServingPipeline(enc, srch, config=config, scan_gate=self._scan_gate)
            for enc, srch in replicas
        ]

    def add(self, encode_fn: EncodeFn, search_fn: SearchFn) -> int:
        """Append one more replica pipeline; returns its slot index.

        The new pipeline inherits the set's config and scan gate. The
        caller (``QueryRouter.add_replica``) is responsible for health
        bookkeeping — a bare ``add`` leaves the pipeline running but
        unknown to any router.
        """
        pipe = ServingPipeline(encode_fn, search_fn, config=self.config,
                               scan_gate=self._scan_gate)
        self.pipelines.append(pipe)
        return len(self.pipelines) - 1

    @classmethod
    def from_factory(
        cls,
        n_replicas: int,
        factory: Callable[[int], Tuple[EncodeFn, SearchFn]],
        *,
        config: ServingConfig = ServingConfig(),
        share_device: bool = False,
    ) -> "ReplicaSet":
        """Build N replicas from ``factory(i) -> (encode_fn, search_fn)``."""
        return cls([factory(i) for i in range(n_replicas)], config=config,
                   share_device=share_device)

    def __len__(self) -> int:
        return len(self.pipelines)

    def close(self, drain: bool = True):
        for p in self.pipelines:
            p.close(drain=drain)

    def stats(self) -> List[dict]:
        return [p.stats() for p in self.pipelines]


# ---------------------------------------------------------------------------
# proxy tickets + router
# ---------------------------------------------------------------------------


class ProxyTicket(Ticket):
    """Client handle for one routed batch; survives replica failover.

    A ``Ticket`` with its own resolution event: the **router** resolves
    it — with the replica's result, or with an error only once no
    healthy replica could serve the batch. Clients never observe an
    intermediate replica failure; ``result()`` simply waits across
    re-dispatches. ``t_enqueue``→``t_reply`` therefore spans the whole
    proxy path, failover retries included.
    """

    def __init__(self, seq: int, request: SearchRequest,
                 deadline: Optional[float] = None, *, t_submit_ns: Optional[int] = None):
        super().__init__(seq, request.n_queries, deadline=deadline, t_submit_ns=t_submit_ns)
        # The typed request is retained for failover re-dispatch (and
        # cleared by Ticket._resolve: a resolved ticket held by a
        # long-running client must not pin its input alongside the
        # result for the rest of the run).
        self.request = request

        self._route_lock = threading.Lock()
        self._inner: Optional[Ticket] = None
        self._replica: Optional[int] = None
        self.redispatches = 0

    @property
    def queries(self) -> Any:
        """Legacy accessor: the raw submitted batch (None once resolved)."""
        return None if self.request is None else self.request.payload

    def _point_at(self, replica: int, inner: Ticket):
        with self._route_lock:
            if self._inner is not None:
                self.redispatches += 1
            self._inner, self._replica = inner, replica

    @property
    def replica(self) -> Optional[int]:
        """Index of the replica that last held the batch."""
        return self._replica


class QueryRouter:
    """Route query batches across a ``ReplicaSet`` (see module docstring).

    ``policy`` is ``"round-robin"``, ``"least-outstanding"``, or any
    object with ``.name`` and ``.order(healthy, outstanding) -> [int]``
    (the order in which replicas are offered a batch; under a shed
    policy, later entries are fallbacks when earlier queues are full).
    """

    def __init__(
        self,
        replicas: ReplicaSet,
        *,
        policy: Union[str, Any] = "round-robin",
        compat: Optional[CompatibilityMatrix] = None,
        clock: Clock = SYSTEM_CLOCK,
    ):
        """``compat``: the tier's embedding-version compatibility matrix
        (bc-trained cross-version encoders). Defaults to an empty one —
        versioned traffic then routes only to native-version replicas
        and raises ``IncompatibleVersion`` when none exists.

        ``clock``: time source for every control loop the router owns
        (retry backoff, probe scheduling, deadline checks). Production
        keeps the default ``SYSTEM_CLOCK``; tests inject a ``FakeClock``
        and advance simulated time instead of sleeping real time."""
        self.replicas = replicas
        self.clock = clock
        self.compat = compat if compat is not None else CompatibilityMatrix()
        if isinstance(policy, str):
            try:
                policy = ROUTING_POLICIES[policy]()
            except KeyError:
                raise ValueError(
                    f"unknown routing policy {policy!r}; "
                    f"known: {sorted(ROUTING_POLICIES)}"
                ) from None
        self.policy = policy
        self._lock = threading.Lock()
        # Wakes drain()/wait_state() waiters: notified on every health-
        # state transition and whenever a replica's outstanding set
        # shrinks — drains complete the instant the last ticket lands,
        # not on the next poll tick.
        self._cond = threading.Condition(self._lock)
        self._seq = 0
        self._closed = False
        # Set first thing in close(): any clock.wait parked on a retry
        # backoff (submit_with_retry, run_stream_with_swap's shed retry)
        # wakes immediately instead of waiting out its full delay.
        self._close_event = threading.Event()
        # _healthy is the ROUTABLE set; _state carries the full health
        # state machine (a draining replica is out of _healthy but not
        # unhealthy — see REPLICA_STATES).
        self._healthy = set(range(len(replicas)))
        self._state: Dict[int, str] = {
            i: "healthy" for i in range(len(replicas))
        }
        self._versions: Dict[int, Any] = {i: None for i in range(len(replicas))}
        self._outstanding: Dict[int, set] = {
            i: set() for i in range(len(replicas))
        }
        self.shed_count = 0  # proxy-level: every healthy replica was full
        self.failover_count = 0  # tickets re-dispatched off a dead replica
        self.revival_count = 0  # unhealthy replicas re-admitted by a probe
        # Deadline sheds observed at the proxy (expired before dispatch);
        # the per-replica pipelines count their own dequeue-time sheds.
        self._deadline_expired = 0
        # Graceful degradation (enable_degradation): a shared EffortKnob
        # the index closures read per call, stepped down under pressure
        # before any shed, back up when pressure clears.
        self._effort: Optional[EffortKnob] = None
        self._degrade_hi = 0.75
        self._degrade_lo = 0.25
        self._near_deadline_s = 0.0
        self._degraded: Dict[int, int] = {
            i: 0 for i in range(len(replicas))
        }
        # Dispatches that crossed embedding versions through a compat
        # encoder (per replica) — the version-axis degradation counter.
        self._compat_served: Dict[int, int] = {
            i: 0 for i in range(len(replicas))
        }
        # Consecutive failed revival probes per replica (flap
        # suppression state; reset on a successful probe).
        self._probe_failures: Dict[int, int] = {}
        # Failover tickets caught while the tier is transiently
        # unroutable (a drain/rebuild/probe holds every replica): parked
        # here, flushed by the next successful probe. Never spun on —
        # _redispatch runs on stage-thread callbacks, and busy-waiting
        # there can block the very scan thread a revival probe needs.
        self._parked: List[Tuple[ProxyTicket, BaseException]] = []
        # Replicas whose current rebuild started from 'unhealthy': their
        # post-rebuild probe success counts as a revival too (the swap
        # reclaimed a dead replica in place).
        self._rebuild_from_dead: set = set()
        self._errors: Dict[int, BaseException] = {}
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_stop = threading.Event()
        # Proxy-level completion accounting: enqueue->reply across the
        # whole tier (admission wait + any failover re-dispatches).
        self._stats = LatencyStats()

    # -- dispatch ------------------------------------------------------

    def _order(self) -> List[int]:
        healthy = sorted(self._healthy)
        counts = {i: len(self._outstanding[i]) for i in healthy}
        return self.policy.order(healthy, counts)

    def _route_version(self, replica: int) -> Optional[str]:
        """Embedding version ``replica`` currently serves (lock held)."""
        return _embedding_version(self._versions.get(replica))

    def _order_for_locked(self, req: SearchRequest) -> List[int]:
        """Policy order, filtered and re-ranked by embedding version
        (lock held): native-version replicas first (policy order within
        the group), then compat-reachable ones — degrade by version only
        when no native replica is routable. Unversioned requests (and
        unversioned replicas) see the plain policy order.

        A codes request cannot take the compat hop (there are no floats
        left to re-encode), so it is native-only.
        """
        order = self._order()
        qv = req.embedding_version
        if qv is None:
            return order
        native = [i for i in order
                  if self._route_version(i) in (None, qv)]
        if req.queries is None:
            return native
        compat = [i for i in order
                  if i not in native
                  and self.compat.lookup(qv, self._route_version(i))
                  is not None]
        return native + compat

    def submit(self, queries: Any, *,
               deadline: Optional[float] = None) -> ProxyTicket:
        """Admit one batch into the tier; returns a ``ProxyTicket``.

        Replicas are tried in policy order. Under ``policy="block"``
        pipelines the first choice back-pressures (no fallback — the
        caller asked for back-pressure); under ``policy="shed"`` a full
        replica queue falls through to the next, and ``RequestShed`` is
        raised only when **every** healthy replica is saturated — after
        one degrade-and-retry pass when degradation is enabled
        (effort steps down BEFORE any query is shed).

        ``deadline`` (absolute ``time.perf_counter()`` instant) rides
        the ticket down to the replica stages, which shed it at dequeue
        once expired. An already-expired deadline raises
        ``DeadlineExpired`` here — terminal, not retryable.

        ``queries`` may be a bare batch (legacy shim — unversioned,
        routes anywhere) or a ``SearchRequest``. A versioned request is
        offered native-version replicas first, then compat-reachable
        ones (through the tier's ``CompatibilityMatrix`` encoder);
        healthy replicas that serve the wrong version with no compat
        path raise ``IncompatibleVersion`` — terminal, like
        ``AllReplicasDown``, unlike ``RequestShed``.

        The ticket's ``seq`` is the request's id in its spans
        (``repro_torch/spans.py``), kept by every replica ticket it is
        dispatched as, failover re-dispatches included.
        """
        t_submit_ns = time.perf_counter_ns() if spans.on else None
        req = as_search_request(queries, deadline=deadline)
        deadline = req.deadline
        if deadline is not None and self.clock.now() >= deadline:
            with self._lock:
                self._deadline_expired += 1
            raise DeadlineExpired("deadline already expired at submit")
        with self._lock:
            if self._closed:
                raise PipelineClosed("submit after close")
            if not self._healthy:
                if all(s in _GONE_STATES for s in self._state.values()):
                    raise AllReplicasDown(
                        f"all {len(self.replicas)} replica slots "
                        "unhealthy or retired"
                    )
                # Transiently empty tier (drain/rebuild/probe in flight):
                # retryable, unlike AllReplicasDown.
                raise RequestShed(
                    "no routable replica (index swap or probe in progress)"
                )
            self._adjust_effort_locked(deadline)
            if req.effort is not None and self._effort is not None:
                # Advisory effort hint: pre-degrade the shared knob at
                # least this far (coarse — the knob is tier-wide).
                while self._effort.level < req.effort \
                        and self._effort.degrade():
                    pass
            order = self._order_for_locked(req)
            if not order:
                raise IncompatibleVersion(
                    f"no routable replica serves embedding version "
                    f"{req.embedding_version!r} and no compat encoder "
                    f"reaches one (healthy replica versions: "
                    f"{sorted(str(self._route_version(i)) for i in self._healthy)}, "
                    f"compat pairs: {self.compat.pairs()})"
                )
            seq = self._seq
            self._seq += 1
        ticket = ProxyTicket(seq, req, deadline=deadline, t_submit_ns=t_submit_ns)
        shed_error: Optional[RequestShed] = None
        for attempt in (0, 1):
            for replica in order:
                try:
                    self._dispatch(ticket, replica)
                    return ticket
                except RequestShed as e:
                    shed_error = e
                    continue
                except PipelineClosed:
                    continue  # replica torn down under us; try the next
            if shed_error is None:
                raise PipelineClosed("every healthy replica is closed")
            # Every healthy replica is saturated: degrade-before-shed.
            # Step the knob down once and retry — cheaper scans drain
            # the queues; the shed only happens when the knob is already
            # at its floor (or degradation is off).
            if attempt == 0 and self._effort is not None \
                    and self._effort.degrade():
                with self._lock:
                    order = self._order_for_locked(req) \
                        if self._healthy else []
                if order:
                    continue
            break
        with self._lock:
            self.shed_count += 1
        raise RequestShed(
            "all healthy replicas saturated"
        ) from shed_error

    def _adjust_effort_locked(self, deadline: Optional[float]) -> None:
        """Step the effort knob against current pressure (lock held).

        Pressure = outstanding tickets / tier queue capacity over the
        routable replicas. >= high water (or a near-deadline submit):
        degrade one level. <= low water: restore one level — hysteresis,
        so the knob does not thrash around a single threshold.
        """
        if self._effort is None or not self._healthy:
            return
        cap = len(self._healthy) * max(1, self.replicas.config.queue_depth)
        load = sum(len(self._outstanding[i]) for i in self._healthy)
        pressure = load / cap
        near = (
            deadline is not None
            and self._near_deadline_s > 0.0
            and deadline - self.clock.now() < self._near_deadline_s
        )
        if pressure >= self._degrade_hi or near:
            self._effort.degrade()
        elif pressure <= self._degrade_lo:
            self._effort.restore()

    def enable_degradation(self, effort: EffortKnob, *,
                           high_water: float = 0.75,
                           low_water: float = 0.25,
                           near_deadline_s: float = 0.0) -> None:
        """Turn on degrade-before-shed with ``effort`` (the SAME knob
        object the replica search closures were built over).

        Every submit re-evaluates queue pressure: >= ``high_water`` of
        tier capacity (or a deadline within ``near_deadline_s``) steps
        effort down; <= ``low_water`` steps it back up. A submit that
        would otherwise shed (every queue full) also degrades once and
        retries before giving up. Dispatches served at level > 0 are
        counted per replica (``degraded`` in stats).
        """
        if not 0.0 <= low_water < high_water <= 1.0:
            raise ValueError(
                f"need 0 <= low_water < high_water <= 1, got "
                f"{low_water}/{high_water}"
            )
        with self._lock:
            self._effort = effort
            self._degrade_hi = high_water
            self._degrade_lo = low_water
            self._near_deadline_s = near_deadline_s

    def submit_with_retry(
        self,
        queries: Any,
        *,
        deadline: Optional[float] = None,
        attempts: int = 6,
        base_delay_s: float = 0.005,
        max_delay_s: float = 0.25,
        jitter: float = 0.5,
        rng: Optional[random.Random] = None,
    ) -> ProxyTicket:
        """``submit`` with exponential backoff + jitter on retryable
        ``RequestShed`` (saturated tier, or a swap/probe transiently
        holding every replica).

        Terminal errors — ``AllReplicasDown``, ``PipelineClosed``,
        ``DeadlineExpired`` — propagate immediately; a deadline that
        expires *between* attempts cuts the retry loop short the same
        way. ``rng`` seeds the jitter (defaults to a fresh
        ``random.Random(0)``: deterministic, but pass a shared seeded
        instance when many clients retry in lockstep — identical jitter
        defeats its purpose).
        """
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        rng = rng if rng is not None else random.Random(0)
        last: Optional[RequestShed] = None
        for attempt in range(attempts):
            try:
                return self.submit(queries, deadline=deadline)
            except RequestShed as e:
                last = e
                if attempt == attempts - 1:
                    break
                delay = min(max_delay_s, base_delay_s * (2.0 ** attempt))
                delay *= 1.0 + jitter * rng.random()
                if deadline is not None \
                        and self.clock.now() + delay >= deadline:
                    with self._lock:
                        self._deadline_expired += 1
                    raise DeadlineExpired(
                        f"deadline would expire during retry backoff "
                        f"(attempt {attempt + 1}/{attempts})"
                    ) from e
                # Interruptible backoff: close() sets _close_event, so a
                # teardown mid-backoff wakes immediately instead of
                # waiting out the full delay (the old uninterruptible
                # time.sleep here made close() block on stragglers).
                if self.clock.wait(self._close_event, delay):
                    raise PipelineClosed(
                        "router closed during retry backoff"
                    ) from e
        raise last

    def _dispatch(self, ticket: ProxyTicket, replica: int, *, force: bool = False):
        req = ticket.request
        if req is None:
            # Resolved (and its batch released) after the caller's
            # done() check: a re-dispatch racing a success. Submitting
            # the cleared payload would poison a healthy replica with a
            # fake encode error — skip instead.
            return
        pipe = self.replicas.pipelines[replica]
        # Register in _outstanding BEFORE pipe.submit, re-checking
        # routability under the same lock: submit() picked this replica
        # from an earlier snapshot, and a drain() landing in the gap
        # would otherwise see an empty outstanding set, declare the
        # replica quiet, and let the swap mutate the pipeline while this
        # batch is still dispatching onto it. The compat encoder is
        # resolved under the SAME lock: the replica's version may have
        # rolled (mid-upgrade swap) since submit() ranked it.
        with self._lock:
            if replica not in self._healthy:
                raise RequestShed(
                    f"replica {replica} left rotation "
                    f"({self._state[replica]}) before dispatch"
                )
            compat_enc: Optional[EncodeFn] = None
            rv = self._route_version(replica)
            if req.embedding_version is not None and rv is not None \
                    and rv != req.embedding_version:
                compat_enc = None if req.queries is None \
                    else self.compat.lookup(req.embedding_version, rv)
                if compat_enc is None:
                    # Retryable at this level: submit/redispatch fall
                    # through to the next replica in version order.
                    raise RequestShed(
                        f"replica {replica} serves version {rv!r}; no "
                        f"compat encoder from {req.embedding_version!r}"
                    )
            self._outstanding[replica].add(ticket)
            degraded = self._effort is not None and self._effort.level > 0
        inner_req = req if compat_enc is None else dataclasses.replace(
            req, encode_override=compat_enc
        )
        try:
            inner = pipe.submit(inner_req, force_block=force, deadline=ticket.deadline,
                                rid=ticket.rid, t_submit_ns=ticket.t_submit_ns)  # may shed
        except BaseException:
            with self._lock:
                self._outstanding[replica].discard(ticket)
                self._cond.notify_all()
            raise
        if degraded:
            with self._lock:
                self._degraded[replica] += 1
        if compat_enc is not None:
            with self._lock:
                self._compat_served[replica] += 1
        ticket._point_at(replica, inner)
        inner.add_done_callback(
            lambda t, tk=ticket, r=replica, ce=compat_enc is not None:
                self._on_inner_done(tk, r, t, compat=ce)
        )

    # -- failover ------------------------------------------------------

    def _on_inner_done(self, ticket: ProxyTicket, replica: int, inner: Ticket,
                       *, compat: bool = False):
        """Replica-ticket completion: the single place proxy tickets are
        resolved (clients only ever wait on the proxy ticket, so they
        never observe an intermediate replica failure)."""
        err = inner.error()
        if err is None:
            with self._lock:
                self._outstanding[replica].discard(ticket)
                served_v = self._route_version(replica)
                self._cond.notify_all()
            if inner.served_by_version is not None:
                served_v = inner.served_by_version
            # Provenance rides the resolve (same first-wins lock): two
            # racing inner successes (failover straggler + re-dispatch)
            # must not let the loser stamp the winner's result.
            if ticket._resolve(
                value=inner.result(),
                provenance=(replica, served_v,
                            inner.served_by_generation, compat,
                            inner.reranked),
            ):
                self._stats.record(ticket)
            return
        if isinstance(err, DeadlineExpired):
            # The client's budget ran out while the batch sat queued —
            # the replica is fine. No failover (re-dispatching expired
            # work wastes a survivor's time), no health transition; the
            # pipeline already counted it.
            with self._lock:
                self._outstanding[replica].discard(ticket)
                self._cond.notify_all()
            ticket._resolve(error=err)
            return
        if isinstance(err, PipelineClosed):
            # Torn down by close(), not a scan failure: propagate.
            with self._lock:
                self._outstanding[replica].discard(ticket)
                self._cond.notify_all()
            ticket._resolve(error=err)
            return
        # Encode/scan failure: eager failover — the moment the replica
        # ticket fails, not when the client calls result(). First caller
        # marks the replica unhealthy and sweeps ALL its in-flight
        # tickets; this ticket may have landed after that sweep (dispatch
        # raced the failure), so re-dispatch it individually if so.
        self._on_replica_failure(replica, err)
        with self._lock:
            straggler = ticket in self._outstanding[replica]
            if straggler:
                self._outstanding[replica].discard(ticket)
                self._cond.notify_all()
                self.failover_count += 1  # missed the sweep, same fate
        if straggler:
            self._redispatch(ticket, err)

    def _on_replica_failure(self, replica: int, error: BaseException):
        """Mark ``replica`` unhealthy (first caller wins) and re-dispatch
        every ticket in flight on it, oldest first."""
        with self._lock:
            if replica not in self._healthy:
                return  # already handled (or draining/rebuilding/probing:
                # the drain path and probe own those transitions)
            self._healthy.discard(replica)
            self._state[replica] = "unhealthy"
            self._errors[replica] = error
            victims = sorted(self._outstanding[replica], key=lambda t: t.seq)
            self._outstanding[replica] = set()
            self.failover_count += len(victims)
            self._cond.notify_all()
        self._fail_parked_if_tier_down()
        for ticket in victims:
            self._redispatch(ticket, error)

    def _redispatch(self, ticket: ProxyTicket, error: BaseException):
        if ticket.done():
            return  # raced a resolve (first-wins); nothing to recover
        req = ticket.request
        if req is None:
            return  # resolved between done() and here; nothing to recover
        while True:
            with self._lock:
                order = self._order_for_locked(req) if self._healthy else []
                if not order and self._healthy and not self._closed:
                    # Healthy replicas exist but none serves (or compat-
                    # reaches) the request's embedding version: a
                    # version dead-end, not a transient outage. Parking
                    # would hang the client on a probe that cannot
                    # change the version topology — fail typed instead.
                    error = IncompatibleVersion(
                        f"failover: no routable replica serves embedding "
                        f"version {req.embedding_version!r} and no compat "
                        f"encoder reaches one"
                    )
                elif not order and not self._closed and any(
                    s not in _GONE_STATES for s in self._state.values()
                ):
                    # Transiently unroutable (a drain/rebuild/probe owns
                    # every replica this instant): an admitted ticket is
                    # never dropped, so park it for the next successful
                    # probe to flush instead of failing work a swap will
                    # outlive by milliseconds.
                    self._parked.append((ticket, error))
                    return
            if not order:
                # Closed, every replica unhealthy, or a version
                # dead-end: genuinely unservable.
                ticket._resolve(error=error)
                return
            try:
                # force=True: back-pressure rather than shed — an
                # admitted ticket is never dropped by failover.
                self._dispatch(ticket, order[0], force=True)
                return
            except RequestShed:
                continue  # replica left rotation between order and dispatch
            except PipelineClosed:
                with self._lock:
                    self._healthy.discard(order[0])
                    self._state[order[0]] = "unhealthy"
                    self._cond.notify_all()
                self._fail_parked_if_tier_down()
                continue

    def _fail_parked_if_tier_down(self):
        """Terminally fail parked failover tickets once no replica can
        ever take them (router closed / every replica unhealthy with no
        transient state left to wait out) — a client awaiting result()
        must not hang on a tier that has nothing left to revive it."""
        with self._lock:
            if not self._closed and any(
                s not in _GONE_STATES for s in self._state.values()
            ):
                return
            parked, self._parked = self._parked, []
        for ticket, err in parked:
            ticket._resolve(error=err)

    def _flush_parked(self):
        """Re-dispatch parked failover tickets (a replica just returned
        to rotation), oldest first."""
        with self._lock:
            parked, self._parked = self._parked, []
        for ticket, err in sorted(parked, key=lambda p: p[0].seq):
            self._redispatch(ticket, err)

    # -- lifecycle / monitoring ---------------------------------------

    def healthy(self) -> List[int]:
        """Routable replicas (state == "healthy")."""
        with self._lock:
            return sorted(self._healthy)

    def states(self) -> Dict[int, str]:
        """Per-replica health state (see REPLICA_STATES)."""
        with self._lock:
            return dict(self._state)

    def wait_state(self, replica: int, states: Sequence[str], *,
                   timeout: Optional[float] = None) -> bool:
        """Block until ``replica``'s health state is one of ``states``
        (condition wait, woken by every transition — no polling).
        Returns False on timeout. The swap controller uses this to wait
        out an in-flight canary probe instead of sleep-polling."""
        states = tuple(states)
        for s in states:
            if s not in REPLICA_STATES:
                raise ValueError(f"unknown replica state {s!r}")
        with self._cond:
            return self._cond.wait_for(
                lambda: self._state[replica] in states, timeout
            )

    def probe_failures(self) -> Dict[int, int]:
        """Consecutive failed revival probes per replica (flap
        suppression state of the background probe loop)."""
        with self._lock:
            return dict(self._probe_failures)

    def outstanding(self) -> Dict[int, int]:
        with self._lock:
            return {i: len(s) for i, s in self._outstanding.items()}

    def set_version(self, replica: int, version: Any) -> None:
        """Record the index version a replica serves.

        ``RollingSwapController`` calls this on swap. Beyond stats, the
        version's ``embedding_version`` now drives routing: versioned
        requests prefer native replicas and fall back through the
        ``CompatibilityMatrix``. The embedding version is also pushed
        into the replica pipeline so replica-level tickets carry it as
        provenance."""
        with self._lock:
            self._versions[replica] = version
        self.replicas.pipelines[replica].embedding_version = (
            _embedding_version(version)
        )

    def versions(self) -> Dict[int, Any]:
        with self._lock:
            return dict(self._versions)

    # -- live index lifecycle (drain / rebuild / probe / revive) -------

    def drain(self, replica: int, *, timeout: float = 30.0,
              poll: Optional[float] = None) -> None:
        """healthy -> draining: stop routing to ``replica`` and wait for
        its in-flight proxy tickets to finish.

        In-flight work completes normally (the routable survivors absorb
        new traffic meanwhile); the wait is a condition-variable sleep
        woken by each completion (mirrors ``ServingPipeline.quiesce``),
        so the drain returns the instant the last ticket lands.
        Tickets still unresolved at ``timeout`` are re-dispatched to the
        survivors via the failover path (force_block — an admitted
        ticket is never dropped), so a stuck replica cannot stall the
        swap. On return the replica holds no proxy tickets; pair with
        ``ServingPipeline.quiesce`` before touching its stages.
        ``poll`` is dead (kept for call compatibility): there is no
        polling loop any more.
        """
        del poll
        with self._cond:
            st = self._state[replica]
            if st != "healthy":
                raise ValueError(
                    f"drain: replica {replica} is {st!r}, need 'healthy'"
                )
            self._state[replica] = "draining"
            self._healthy.discard(replica)
            self._cond.notify_all()
            if self._cond.wait_for(
                lambda: not self._outstanding[replica], timeout
            ):
                return
            # Timed out: sweep the stragglers onto the survivors, oldest
            # first (their inner tickets may still resolve on the
            # draining replica — first-wins keeps whichever result lands
            # first).
            victims = sorted(self._outstanding[replica], key=lambda t: t.seq)
            self._outstanding[replica] = set()
            self.failover_count += len(victims)
            self._cond.notify_all()
        err = RuntimeError(
            f"replica {replica} did not drain within {timeout}s"
        )
        for ticket in victims:
            self._redispatch(ticket, err)

    def begin_rebuild(self, replica: int) -> None:
        """draining|unhealthy -> rebuilding: the caller owns the replica
        until it hands it back through ``probe``."""
        with self._lock:
            st = self._state[replica]
            if st not in ("draining", "unhealthy"):
                raise ValueError(
                    f"begin_rebuild: replica {replica} is {st!r}, need "
                    "'draining' or 'unhealthy'"
                )
            if st == "unhealthy":
                self._rebuild_from_dead.add(replica)
            else:
                self._rebuild_from_dead.discard(replica)
            self._state[replica] = "rebuilding"
            self._cond.notify_all()

    # -- elastic capacity (autoscaler scale-up / scale-down) -----------

    def add_replica(self, encode_fn: EncodeFn, search_fn: SearchFn) -> int:
        """Grow the tier by one replica slot; returns the new index.

        The slot enters in ``rebuilding`` — OUT of rotation, owned by
        the caller exactly like a swap-controller rebuild. It receives
        no traffic until a canary ``probe(slot, ..., from_rebuild=True)``
        succeeds, so the scale-up path gets the same warmed-and-probed
        admission discipline as an index swap. Deliberately not
        ``unhealthy``: admitting a brand-new replica is not a revival
        and must not inflate ``revival_count``.
        """
        with self._lock:
            if self._closed:
                raise PipelineClosed("add_replica after close")
            slot = self.replicas.add(encode_fn, search_fn)
            self._state[slot] = "rebuilding"
            self._versions[slot] = None
            self._outstanding[slot] = set()
            self._degraded[slot] = 0
            self._compat_served[slot] = 0
            self._rebuild_from_dead.discard(slot)
            self._cond.notify_all()
        return slot

    def retire_replica(self, replica: int, *, timeout: float = 30.0) -> None:
        """Shrink the tier: drain ``replica`` losslessly, then tombstone
        its slot as ``retired`` and close its pipeline.

        The drain is the proxy's ordinary drain path — in-flight proxy
        tickets finish (or re-dispatch to the survivors at ``timeout``),
        so scale-down never loses or reorders admitted work. Slots are
        never renumbered: the retired index stays in every per-replica
        dict, excluded from routing, probing, and the ``replicas``
        count. Idempotent on an already-retired slot. An ``unhealthy``
        replica retires without a drain (it holds no tickets); the
        transient states raise — their current owner (swap controller /
        probe) must finish first.
        """
        with self._lock:
            st = self._state[replica]
        if st == "retired":
            return
        if st == "healthy":
            self.drain(replica, timeout=timeout)
        elif st != "unhealthy":
            raise ValueError(
                f"retire_replica: replica {replica} is {st!r}; finish "
                "the in-flight drain/rebuild/probe first"
            )
        with self._lock:
            self._state[replica] = "retired"
            self._healthy.discard(replica)
            self._errors.pop(replica, None)
            self._probe_failures.pop(replica, None)
            self._cond.notify_all()
        # Unreachable by routing from here on; safe to tear down.
        self.replicas.pipelines[replica].close(drain=True)
        self._fail_parked_if_tier_down()

    def active_replicas(self) -> List[int]:
        """Slots not retired (healthy or recoverable) — the tier's
        current size as the autoscaler and bench gate count it."""
        with self._lock:
            return sorted(i for i, s in self._state.items()
                          if s != "retired")

    def mark_unhealthy(self, replica: int,
                       error: Optional[BaseException] = None) -> None:
        """Force a replica out of service (any state -> unhealthy).

        From ``healthy`` this is the normal failover path (in-flight
        tickets re-dispatch to the survivors). From the transient states
        it parks the replica where the canary re-probe can reclaim it —
        the swap controller uses this when an aborted swap would
        otherwise strand a replica in ``draining``/``rebuilding``
        forever (no probe targets those states)."""
        with self._lock:
            in_rotation = replica in self._healthy
            if error is not None:
                self._errors[replica] = error
        if in_rotation:
            self._on_replica_failure(
                replica, error or RuntimeError(
                    f"replica {replica} marked unhealthy"
                )
            )
        else:
            with self._lock:
                self._state[replica] = "unhealthy"
                self._cond.notify_all()
            self._fail_parked_if_tier_down()

    def probe(self, replica: int, canary: Any, *, expect=None,
              timeout: float = 30.0, from_rebuild: bool = False) -> bool:
        """Canary-query an out-of-service replica; success re-admits it.

        The paper-style health re-probe: a real query batch is pushed
        through the replica's own pipeline (encode + scan, force_block).
        If it resolves — and matches ``expect``'s (scores, ids) when
        given — the replica returns to the routable set. A probe of an
        ``unhealthy`` replica that succeeds is a **revival** (counted in
        ``revival_count``) and starts a fresh stats generation, ending
        the old one-strike-forever behavior. Failure parks the replica
        back in ``unhealthy`` for the next probe.

        ``from_rebuild`` is the swap controller's hand-back: only it may
        probe a ``rebuilding`` replica. Without the flag a probe of a
        replica in ``rebuilding`` or ``probing`` returns False untouched
        — the background probe loop must never re-admit a replica whose
        stages another thread is mid-mutation (its target snapshot can
        go stale between listing and probing).
        """
        with self._lock:
            st = self._state[replica]
            if st == "healthy":
                return True
            if st == "draining":
                raise ValueError(
                    f"probe: replica {replica} is draining (finish the "
                    "drain/rebuild first)"
                )
            if st == "rebuilding" and not from_rebuild:
                return False  # the swap controller owns it
            if st == "probing":
                return False  # another probe is already in flight
            # A rebuild that reclaimed a dead replica counts as a
            # revival too; its generation was already bumped by the
            # swap controller, so only the direct unhealthy->probing
            # path needs a fresh one here.
            revival = st == "unhealthy" or (
                st == "rebuilding" and replica in self._rebuild_from_dead
            )
            fresh_generation = st == "unhealthy"
            self._rebuild_from_dead.discard(replica)
            self._state[replica] = "probing"
            self._cond.notify_all()
        pipe = self.replicas.pipelines[replica]
        if fresh_generation:
            # Separate the revived run's stats from the dead run's. The
            # quiesce must actually succeed: bumping the generation with
            # an old-generation scan still in flight would let its
            # completion race the stats reset — the exact conflation the
            # generation exists to prevent. A still-stuck replica goes
            # back to unhealthy for the next probe.
            if not pipe.quiesce(timeout=min(timeout, 5.0)):
                with self._lock:
                    self._state[replica] = "unhealthy"
                    self._cond.notify_all()
                self._fail_parked_if_tier_down()
                return False
            pipe.new_generation()
        try:
            ticket = pipe.submit(canary, force_block=True)
            vals, ids = ticket.result(timeout=timeout)
            if expect is not None:
                ev, ei = expect
                if not (_host_equal(ids, ei) and _host_equal(vals, ev)):
                    raise RuntimeError(
                        f"replica {replica} canary mismatch vs expected "
                        "(scores, ids)"
                    )
        except BaseException as e:
            with self._lock:
                self._state[replica] = "unhealthy"
                self._errors[replica] = e
                self._cond.notify_all()
            self._fail_parked_if_tier_down()
            return False
        with self._lock:
            self._state[replica] = "healthy"
            self._healthy.add(replica)
            self._errors.pop(replica, None)
            self._probe_failures.pop(replica, None)
            if revival:
                self.revival_count += 1
            self._cond.notify_all()
        # A replica is back: failover tickets parked while the tier was
        # transiently unroutable can flow again.
        self._flush_parked()
        return True

    def start_health_probe(self, canary: Any, *, interval: float = 1.0,
                           expect=None, timeout: float = 30.0) -> None:
        """Start the periodic re-probe loop: every ``interval`` seconds,
        canary-probe each ``unhealthy`` replica and revive the ones that
        answer. Idempotent; ``stop_health_probe``/``close`` stops it.

        Flap suppression: a replica whose revival probes keep failing is
        probed at ``probe_backoff(interval, n_failures)`` spacing
        (1x, 2x, 4x, ... the interval, capped) instead of every tick —
        a flapping or permanently dead replica cannot monopolise the
        loop while healthy work waits. The counter resets the moment a
        probe succeeds; ``probe_failures()`` exposes it.
        """
        with self._lock:
            if self._probe_thread is not None and self._probe_thread.is_alive():
                return
            self._probe_stop = threading.Event()
            stop = self._probe_stop

            def loop():
                next_due: Dict[int, float] = {}
                while not self.clock.wait(stop, interval):
                    with self._lock:
                        targets = [i for i, s in self._state.items()
                                   if s == "unhealthy"]
                    for i in targets:
                        if stop.is_set():
                            return
                        if self.clock.now() < next_due.get(i, 0.0):
                            continue  # backing off a flapper
                        if self.probe(i, canary, expect=expect,
                                      timeout=timeout):
                            next_due.pop(i, None)
                            continue
                        with self._lock:
                            fails = self._probe_failures.get(i, 0) + 1
                            self._probe_failures[i] = fails
                        next_due[i] = self.clock.now() + probe_backoff(
                            interval, fails
                        )

            self._probe_thread = threading.Thread(
                target=loop, name="router-health-probe", daemon=True
            )
            self._probe_thread.start()

    def stop_health_probe(self, *, timeout: float = 30.0) -> None:
        """Stop the probe loop and join its thread.

        Raises ``RuntimeError`` if the thread fails to exit within
        ``timeout`` — e.g. wedged inside ``probe`` on a stuck canary
        ticket. The old behaviour (silent join timeout) leaked a daemon
        thread that could revive replicas long after the caller believed
        probing had stopped; now the leak is loud and attributable.
        """
        self._probe_stop.set()
        t = self._probe_thread
        self._probe_thread = None
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
            if t.is_alive():
                raise RuntimeError(
                    f"health-probe thread did not exit within {timeout}s "
                    "(wedged on a stuck probe ticket?); a daemon thread "
                    "has leaked and may still revive replicas"
                )

    # -- stuck-scan watchdogs ------------------------------------------

    def start_watchdogs(self, budget_s: float, *,
                        poll: Optional[float] = None) -> None:
        """Arm a stuck-scan watchdog on every replica pipeline.

        A scan that runs past ``budget_s`` without completing marks its
        replica unhealthy with ``ScanStalled``; the ordinary failover
        path then re-dispatches the replica's in-flight tickets to the
        survivors — a hung (non-raising) scan no longer deadlocks the
        tier. The canary probe loop can revive the replica later if the
        hang clears; until then it is out of rotation.
        """
        for i, pipe in enumerate(self.replicas.pipelines):
            pipe.start_watchdog(
                budget_s, self._make_stall_handler(i), poll=poll,
                clock=self.clock,
            )

    def _make_stall_handler(self, replica: int):
        def on_stall(pipe: ServingPipeline, seq: int, age: float):
            self.mark_unhealthy(replica, ScanStalled(
                f"replica {replica} scan (inner ticket {seq}) still "
                f"running after {age:.3f}s (budget exceeded)"
            ))
        return on_stall

    def stop_watchdogs(self) -> None:
        for pipe in self.replicas.pipelines:
            pipe.stop_watchdog()

    def close(self, drain: bool = True):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # First: wake every clock.wait parked on a retry backoff so
        # teardown is not gated on waiting out backoff delays.
        self._close_event.set()
        self._fail_parked_if_tier_down()  # closed: parked tickets fail
        try:
            self.stop_health_probe(timeout=5.0)
        except RuntimeError as e:
            # close() must complete even with a wedged probe thread; the
            # leak is logged instead of raised (the direct
            # stop_health_probe caller gets the exception).
            logger.error("close(): %s", e)
        self.stop_watchdogs()
        self.replicas.close(drain=drain)

    def __enter__(self) -> "QueryRouter":
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        """One proxy-level report over the whole tier.

        Aggregates each replica's totals and merges their latency
        windows for tier-wide percentiles; per-replica breakdowns ride
        along under ``per_replica``.
        """
        with self._lock:  # one snapshot: per-replica flags must agree
            shed_proxy = self.shed_count
            failovers = self.failover_count
            revivals = self.revival_count
            deadline_proxy = self._deadline_expired
            degraded = dict(self._degraded)
            compat_served = dict(self._compat_served)
            effort_level = (
                self._effort.level if self._effort is not None else None
            )
            healthy = sorted(self._healthy)
            states = dict(self._state)
            versions = dict(self._versions)
        per = []
        for i, pipe in enumerate(self.replicas.pipelines):
            if i not in states:
                continue  # add_replica raced the snapshot above
            s = pipe.stats()  # carries "generation" (bumped per revival/swap)
            s["replica"] = i
            s["healthy"] = i in healthy
            s["state"] = states[i]
            s["degraded"] = degraded[i]
            s["compat_served"] = compat_served[i]
            v = versions[i]
            s["version"] = getattr(v, "tag", v)
            s["embedding_version"] = _embedding_version(v)
            per.append(s)
        n_req, n_q, lat = self._stats.snapshot()
        lat.sort()
        # Averages (idle) and the headline count cover only live slots;
        # retired pipelines are closed and would skew both.
        live = [s for s in per if s["state"] != "retired"]
        idle = (
            sum(s["device_idle_frac"] for s in live) / len(live)
            if live else 0.0
        )
        return {
            "replicas": len(live),
            "retired_replicas": len(per) - len(live),
            "router": getattr(self.policy, "name", type(self.policy).__name__),
            "healthy": healthy,
            # proxy-level completions: a failed-over request counts once
            # here even though two replicas saw it.
            "requests": n_req,
            "queries": n_q,
            # proxy-level sheds only: a replica-level bounce that another
            # replica absorbed is routing, not shedding.
            "shed": shed_proxy,
            "replica_shed": sum(s["shed"] for s in per),
            # Deadline sheds across the tier: expired-at-submit (proxy)
            # plus expired-at-dequeue (per-replica stages).
            "deadline_expired": deadline_proxy + sum(
                s["deadline_expired"] for s in per
            ),
            # Dispatches served at reduced effort + the knob's position.
            "degraded": sum(degraded.values()),
            "effort_level": effort_level,
            # Dispatches that crossed embedding versions through a
            # compat encoder (version-axis degradation).
            "compat_dispatches": sum(compat_served.values()),
            "watchdog_stalls": sum(s["watchdog_stalls"] for s in per),
            "failovers": failovers,
            "revivals": revivals,
            "states": states,
            # tier-wide percentiles over proxy enqueue->reply (admission
            # wait + failover re-dispatches included).
            "latency_p50_ms": 1e3 * _percentile(lat, 0.50),
            "latency_p99_ms": 1e3 * _percentile(lat, 0.99),
            "device_idle_frac": idle,
            "per_replica": per,
        }


# ---------------------------------------------------------------------------
# offline driver
# ---------------------------------------------------------------------------


def serve_replicated(
    replicas: Sequence[Tuple[EncodeFn, SearchFn]],
    batches: List[Any],
    *,
    policy: Union[str, Any] = "round-robin",
    config: ServingConfig = ServingConfig(),
    share_device: bool = False,
) -> Tuple[List[Tuple[Array, Array]], dict]:
    """Run ``batches`` through a fresh replicated tier; (results, stats).

    The replicated twin of ``serving.serve_batches``: results come back
    in submission order and are bit-identical to ``serve_sequential``
    on any single replica. Admission is forced to "block" per replica —
    an offline driver should back-pressure, not shed. See ``ReplicaSet``
    for ``share_device``.
    """
    config = dataclasses.replace(config, policy="block")
    router = QueryRouter(
        ReplicaSet(replicas, config=config, share_device=share_device),
        policy=policy,
    )
    try:
        tickets = [router.submit(b) for b in batches]
        results = [t.result() for t in tickets]
    finally:
        # stats() only after close(): the join guarantees every scan
        # thread has run its completion callbacks (exact counters).
        router.close()
    return results, router.stats()
