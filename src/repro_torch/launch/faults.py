"""Deterministic fault injection for the serving tier (chaos harness;
ports ``repro/launch/faults.py`` verbatim: it is pure Python).

The replicated tier (``launch/proxy.py``) recovers from replicas that
*raise*; this module supplies the faults that prove it — and the ones
the tier has machinery for (hung scans, latency spikes, flapping
revivals) — as one shared vocabulary instead of per-test wrappers.
A fault fires in Python before the wrapped call, so a failed or stuck
scan launches no kernel: the kernels' launch counts on the card see
only the calls that went through.

  * ``FaultPlan`` — a seeded, deterministic schedule of ``FaultEvent``s
    keyed on per-stage call index. Same plan + same call sequence =>
    same faults, every run (probabilistic clauses draw from a
    ``random.Random(seed)``, so even those replay exactly).
  * ``FaultInjector`` — wraps one ``(encode_fn, search_fn)`` replica
    pair; ``injector.encode`` / ``injector.search`` are drop-in stage
    callables that consult the plan on every call and fault on
    schedule. Stuck scans block until ``release()`` — call it before
    tearing the pipeline down or ``close()`` joins a thread that is
    waiting on you.
  * ``parse_chaos_spec`` — the ``--chaos SPEC`` string shared by
    ``launch/serve.py`` and the serve drivers (syntax below),
    mapping clauses onto per-replica ``FaultPlan``s.

Fault kinds (``FaultEvent.kind``):

  fail   raise ``InjectedFault`` instead of calling through
  delay  sleep ``arg`` seconds, then call through (latency spike)
  stick  block until ``FaultInjector.release()``, then call through
         (a hung scan: the stage thread wedges, nothing raises)
  flap   periodic ``fail``: starting at ``at``, fail ``count`` calls
         out of every ``arg`` (a replica that dies, revives under the
         canary probe, and dies again)

``--chaos`` spec syntax — comma-separated clauses::

  [rN.][stage.]kind[@AT][xCOUNT][~PROB][:ARG]   or   seed=N

  rN.     replica index the clause applies to (default r0)
  stage.  encode | search (default search)
  @AT     first affected 0-based call index (default 0)
  xCOUNT  consecutive calls affected; ``x*`` = every call from AT on
  ~PROB   probabilistic instead of positional: each call >= AT faults
          with probability PROB under the plan's seeded RNG
  :ARG    seconds for delay, period (calls) for flap

Examples: ``stick@40`` (scan 40 hangs), ``r1.fail@10x3`` (replica 1's
scans 10-12 raise), ``delay@0x*:0.02`` (every scan +20 ms),
``encode.fail~0.05,seed=7`` (5% of encodes raise, deterministically).
"""

from __future__ import annotations

import dataclasses
import random
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """The error a scheduled ``fail``/``flap`` fault raises. A distinct
    type so tests and drivers can tell injected chaos from real bugs."""


FAULT_KINDS = ("fail", "delay", "stick", "flap")
FAULT_STAGES = ("encode", "search")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (see module docstring for the semantics).

    ``count=0`` means "every call from ``at`` on" (the spec's ``x*``).
    ``prob > 0`` makes the event probabilistic (per-call coin flip from
    the plan's seeded RNG) instead of positional.
    """

    kind: str
    stage: str = "search"
    at: int = 0
    count: int = 1
    arg: float = 0.0
    prob: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )
        if self.stage not in FAULT_STAGES:
            raise ValueError(
                f"fault stage must be one of {FAULT_STAGES}, "
                f"got {self.stage!r}"
            )
        if self.at < 0 or self.count < 0:
            raise ValueError("fault at/count must be >= 0")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"fault prob must be in [0, 1], got {self.prob}")
        if self.kind == "delay" and self.arg <= 0.0:
            raise ValueError("delay fault needs arg > 0 (seconds)")
        if self.kind == "flap" and self.arg and self.arg < max(1, self.count):
            raise ValueError("flap period (arg) must be >= count")

    def applies(self, i: int, rng: Optional[random.Random] = None) -> bool:
        """Does this event fire on call ``i`` of its stage?"""
        if i < self.at:
            return False
        if self.prob > 0.0:
            # rng is consulted for EVERY eligible call (hit or miss), so
            # the draw sequence — and therefore the fault schedule — is
            # a pure function of (seed, call index).
            return rng is not None and rng.random() < self.prob
        if self.kind == "flap":
            period = int(self.arg) if self.arg else 2 * max(1, self.count)
            return (i - self.at) % period < self.count
        if self.count == 0:
            return True
        return i < self.at + self.count


class FaultPlan:
    """A deterministic schedule of fault events for one replica."""

    def __init__(self, events: Sequence[FaultEvent] = (), *, seed: int = 0):
        self.events = tuple(events)
        self.seed = seed

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.events)!r}, seed={self.seed})"

    def merged(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(self.events + other.events, seed=self.seed)

    # -- convenience constructors (the shapes tests hand-rolled before) --

    @classmethod
    def fail_after(cls, n: int, *, stage: str = "search") -> "FaultPlan":
        """Calls 0..n-1 succeed; every call >= n raises."""
        return cls([FaultEvent("fail", stage=stage, at=n, count=0)])

    @classmethod
    def fail_first(cls, n: int, *, stage: str = "search") -> "FaultPlan":
        """The first ``n`` calls raise, then the stage recovers — the
        transient fault a canary probe revives a replica from."""
        return cls([FaultEvent("fail", stage=stage, at=0, count=n)])

    @classmethod
    def fail_at(cls, *indices: int, stage: str = "search") -> "FaultPlan":
        return cls([FaultEvent("fail", stage=stage, at=i) for i in indices])

    @classmethod
    def stick_at(cls, n: int, *, stage: str = "search") -> "FaultPlan":
        """Call ``n`` blocks until ``FaultInjector.release()`` — the
        hung-scan fault the watchdog exists for."""
        return cls([FaultEvent("stick", stage=stage, at=n)])

    @classmethod
    def delay_every(cls, seconds: float, *, stage: str = "search",
                    at: int = 0) -> "FaultPlan":
        """Every call from ``at`` on sleeps ``seconds`` first (a slow
        replica, not a broken one)."""
        return cls([FaultEvent("delay", stage=stage, at=at, count=0,
                               arg=seconds)])


class FaultInjector:
    """Wrap one replica's ``(encode_fn, search_fn)`` with a fault plan.

    ``injector.encode`` / ``injector.search`` (or the ``pair`` tuple)
    drop into any place a replica pair goes — ``ReplicaSet``, a builder
    closure, the bench emitter. Call counting is per stage and
    thread-safe; every fault fired is appended to ``log`` as
    ``(stage, call_index, kind)`` so tests can assert the schedule ran.
    """

    def __init__(self, encode_fn: Callable, search_fn: Callable,
                 plan: FaultPlan, *, name: str = "replica",
                 clock: Any = None):
        # ``clock`` (launch.clock.Clock) times delay events; default is
        # the real clock. Tests on a FakeClock make an injected latency
        # spike a simulated-time event instead of a real sleep.
        self.plan = plan
        self.name = name
        self._clock = clock
        self._fns = {"encode": encode_fn, "search": search_fn}
        self._lock = threading.Lock()
        self.calls = {"encode": 0, "search": 0}
        self.log: List[Tuple[str, int, str]] = []
        self._release = threading.Event()
        self.stuck_count = 0
        # One RNG per stage, both derived from the plan seed: a
        # probabilistic encode clause must not perturb the search
        # stage's draw sequence (or vice versa).
        self._rng = {
            "encode": random.Random(plan.seed * 2 + 1),
            "search": random.Random(plan.seed * 2 + 2),
        }
        self.encode = self._wrap("encode")
        self.search = self._wrap("search")

    def _wrap(self, stage: str) -> Callable:
        inner = self._fns[stage]

        def call(x: Any):
            self._enter(stage)
            return inner(x)

        # The serving tier reads metadata off the stage callable itself
        # (``search_fn.reranked`` for result provenance, the shared
        # ``search_fn.effort`` knob for degradation) — injecting faults
        # must not strip it. The effort knob is copied by REFERENCE so
        # the proxy's level changes reach the wrapped closure.
        for attr in ("reranked", "effort"):
            if hasattr(inner, attr):
                setattr(call, attr, getattr(inner, attr))
        return call

    @property
    def pair(self) -> Tuple[Callable, Callable]:
        return self.encode, self.search

    def release(self) -> None:
        """Unblock every stuck stage call (past and future ``stick``
        events become no-ops). Call before closing a pipeline whose
        scan you wedged, or ``close()`` joins a thread waiting on you."""
        self._release.set()

    def _enter(self, stage: str) -> None:
        with self._lock:
            i = self.calls[stage]
            self.calls[stage] += 1
            fired = [
                ev for ev in self.plan.events
                if ev.stage == stage and ev.applies(i, self._rng[stage])
            ]
            for ev in fired:
                self.log.append((stage, i, ev.kind))
            if any(ev.kind == "stick" for ev in fired):
                self.stuck_count += 1
        # Apply OUTSIDE the lock: a stuck scan must not wedge the other
        # stage's (or another thread's) call counting.
        for ev in fired:
            if ev.kind == "delay":
                if self._clock is None:
                    time.sleep(ev.arg)
                else:
                    self._clock.sleep(ev.arg)
            elif ev.kind == "stick":
                self._release.wait()
            else:  # fail | flap
                raise InjectedFault(
                    f"injected {ev.kind} ({self.name}.{stage} call {i})"
                )


def wrap_replicas(
    replicas: Sequence[Tuple[Callable, Callable]],
    plans: Dict[int, FaultPlan],
) -> Tuple[List[Tuple[Callable, Callable]], Dict[int, FaultInjector]]:
    """Wrap ``replicas[i]`` with ``plans[i]`` where present.

    Returns (new replica list, {replica index: injector}) — the driver
    keeps the injectors to ``release()`` stuck scans at shutdown.
    """
    out = list(replicas)
    injectors: Dict[int, FaultInjector] = {}
    for i, plan in sorted(plans.items()):
        if not 0 <= i < len(out):
            raise ValueError(
                f"chaos spec targets replica {i} but the tier has "
                f"{len(out)} replicas"
            )
        inj = FaultInjector(out[i][0], out[i][1], plan, name=f"r{i}")
        injectors[i] = inj
        out[i] = inj.pair
    return out, injectors


# ---------------------------------------------------------------------------
# --chaos spec parsing
# ---------------------------------------------------------------------------

_CLAUSE_RE = re.compile(
    r"^(?:r(?P<replica>\d+)\.)?"
    r"(?:(?P<stage>encode|search)\.)?"
    r"(?P<kind>fail|delay|stick|flap)"
    r"(?:@(?P<at>\d+))?"
    r"(?:x(?P<count>\d+|\*))?"
    r"(?:~(?P<prob>[0-9.]+))?"
    r"(?::(?P<arg>[0-9.]+))?$"
)


def parse_chaos_spec(spec: str) -> Dict[int, FaultPlan]:
    """Parse a ``--chaos`` spec into per-replica ``FaultPlan``s.

    See the module docstring for the grammar. Raises ``ValueError`` on
    anything it does not recognise — a chaos run with a silently
    dropped clause would "pass" by testing nothing.
    """
    seed = 0
    events: Dict[int, List[FaultEvent]] = {}
    for raw in spec.split(","):
        clause = raw.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            try:
                seed = int(clause[5:])
            except ValueError:
                raise ValueError(f"bad chaos seed clause {clause!r}") from None
            continue
        m = _CLAUSE_RE.match(clause)
        if m is None:
            raise ValueError(
                f"bad chaos clause {clause!r} (expected "
                "[rN.][stage.]kind[@AT][xCOUNT][~PROB][:ARG] or seed=N)"
            )
        replica = int(m.group("replica") or 0)
        count_s = m.group("count")
        count = 0 if count_s == "*" else int(count_s) if count_s else 1
        ev = FaultEvent(
            kind=m.group("kind"),
            stage=m.group("stage") or "search",
            at=int(m.group("at") or 0),
            count=count,
            arg=float(m.group("arg") or 0.0),
            prob=float(m.group("prob") or 0.0),
        )
        events.setdefault(replica, []).append(ev)
    return {i: FaultPlan(evs, seed=seed) for i, evs in events.items()}


def apply_chaos(
    replicas: Sequence[Tuple[Callable, Callable]],
    spec: Optional[str],
) -> Tuple[List[Tuple[Callable, Callable]], Dict[int, FaultInjector]]:
    """Driver entry point: parse ``spec`` and wrap the targeted replicas.

    ``spec=None``/empty returns the replicas untouched (no injectors).
    """
    if not spec:
        return list(replicas), {}
    return wrap_replicas(replicas, parse_chaos_spec(spec))
