"""Shed-pressure autoscaler and declarative tier spec (ports
``repro/launch/autoscale.py`` whole; it is pure Python).

The tier routes, degrades, swaps, injects chaos and migrates across N
replicas — but N itself is frozen at construction. Production EBR
systems (Huang et al., arXiv:2006.11632) treat capacity
as part of the retrieval system: index cost and replica count must
track load. This module closes that loop:

  * ``TierSpec`` — the declarative desired state of a serving tier:
    replica bounds, index kind + build params, router policy, admission
    policy and queue depth, swap cadence, and the scaling thresholds
    (high/low-water hysteresis, cooldown, sliding window). One frozen,
    eagerly-validated record that ``serve.py --tier-spec spec.json``
    applies at startup and the ``Autoscaler`` re-applies as it resizes,
    so an operator edits ONE artifact, not a flag soup. Malformed specs
    fail with ``InvalidTierSpec`` naming the field and the fix.

  * ``Autoscaler`` — the control loop: every ``tick_s`` it reads
    ``QueryRouter.stats()`` (shed deltas) and ``outstanding()`` (queue
    occupancy) into a pressure signal in [0, 1], averages it over a
    sliding window, and scales through the EXISTING lifecycle paths —
    nothing here touches a pipeline directly:

      scale-up    build via ``IndexBuilder.build(snapshot, replica=i)``,
                  warm it (``serving.warmup_replicas``),
                  enter the tier in ``rebuilding`` via
                  ``QueryRouter.add_replica``, and canary-probe
                  (``probe(..., from_rebuild=True)``) BEFORE the slot
                  takes traffic — the same admission discipline as an
                  index swap. A failed canary retires the slot; it
                  never serves.
      scale-down  ``QueryRouter.retire_replica``: the proxy's ordinary
                  drain path, so in-flight tickets finish or re-dispatch
                  losslessly, then the slot is tombstoned ``retired``.

    Hysteresis (act only when the window MEAN crosses high/low water,
    two separated thresholds) plus a post-action cooldown keep a noisy
    trace from flapping the tier; the window clears after every action
    so a decision is never made on pre-action pressure.

All timing runs on an injected ``Clock`` (``launch.clock``): production
uses the default ``SYSTEM_CLOCK``; tests drive a ``FakeClock`` and
prove every hysteresis/cooldown/bounds property by advancing simulated
time, never by sleeping real time.

``device`` is placement, not part of the tier's shape: it stays out of
``TierSpec`` and its JSON. ``TierSpec.make_index_builder(device=...)``
and ``Autoscaler(..., device=...)`` take it (``"cuda"`` by default) and
hand it to ``lifecycle.make_builder``. Validating a spec constructs a
builder, which touches no device: builders resolve theirs only in
``build``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.launch import serving
from repro_torch.launch.clock import SYSTEM_CLOCK, Clock
from repro_torch.launch.lifecycle import (
    CorpusSnapshot,
    IndexBuilder,
    builder_version,
    make_builder,
)
from repro_torch.launch.proxy import ROUTING_POLICIES, QueryRouter
from repro_torch.launch.serving import EncodeFn, SearchFn


class InvalidTierSpec(ValueError):
    """A ``TierSpec`` (or its JSON form) failed validation.

    Typed so operators and tests can distinguish a malformed spec from
    the generic ``ValueError`` soup; the message always names the bad
    field and the accepted range."""


#: Admission policies a spec may ask of the per-replica queues.
ADMISSION_POLICIES = ("block", "shed")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise InvalidTierSpec(msg)


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Declarative desired state of one serving tier.

    Scaling semantics: the autoscaler samples tier pressure every
    ``tick_s`` seconds, averages the last ``window_s`` worth of samples,
    and scales up when the mean is >= ``high_water`` (below
    ``max_replicas``) or down when it is <= ``low_water`` (above
    ``min_replicas``). ``cooldown_s`` is the minimum spacing between
    consecutive scaling actions; the sample window resets after every
    action. ``swap_every_s`` is the declared index-swap cadence (0 =
    no periodic swap) — consumed by the serve drivers, recorded here so
    the whole tier shape lives in one artifact.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    index: str = "flat"
    build_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    router: str = "round-robin"
    policy: str = "shed"
    queue_depth: int = 4
    swap_every_s: float = 0.0
    high_water: float = 0.5
    low_water: float = 0.1
    cooldown_s: float = 5.0
    window_s: float = 3.0
    tick_s: float = 1.0

    def __post_init__(self):
        _require(isinstance(self.min_replicas, int)
                 and not isinstance(self.min_replicas, bool)
                 and self.min_replicas >= 1,
                 f"min_replicas must be an int >= 1, got "
                 f"{self.min_replicas!r}")
        _require(isinstance(self.max_replicas, int)
                 and not isinstance(self.max_replicas, bool)
                 and self.max_replicas >= self.min_replicas,
                 f"max_replicas must be an int >= min_replicas "
                 f"({self.min_replicas}), got {self.max_replicas!r}")
        _require(isinstance(self.queue_depth, int)
                 and not isinstance(self.queue_depth, bool)
                 and self.queue_depth >= 1,
                 f"queue_depth must be an int >= 1, got "
                 f"{self.queue_depth!r}")
        _require(self.policy in ADMISSION_POLICIES,
                 f"policy must be one of {ADMISSION_POLICIES}, got "
                 f"{self.policy!r}")
        _require(self.router in ROUTING_POLICIES,
                 f"router must be one of {sorted(ROUTING_POLICIES)}, "
                 f"got {self.router!r}")
        for name in ("swap_every_s", "high_water", "low_water",
                     "cooldown_s", "window_s", "tick_s"):
            v = getattr(self, name)
            _require(isinstance(v, (int, float))
                     and not isinstance(v, bool),
                     f"{name} must be a number, got {v!r}")
        _require(0.0 <= self.low_water < self.high_water <= 1.0,
                 f"need 0 <= low_water < high_water <= 1, got "
                 f"low_water={self.low_water} high_water={self.high_water}")
        _require(self.cooldown_s >= 0.0,
                 f"cooldown_s must be >= 0, got {self.cooldown_s}")
        _require(self.swap_every_s >= 0.0,
                 f"swap_every_s must be >= 0, got {self.swap_every_s}")
        _require(self.tick_s > 0.0,
                 f"tick_s must be > 0, got {self.tick_s}")
        _require(self.window_s >= self.tick_s,
                 f"window_s must be >= tick_s ({self.tick_s}), got "
                 f"{self.window_s}")
        _require(isinstance(self.build_params, dict),
                 f"build_params must be a dict, got "
                 f"{type(self.build_params).__name__}")
        # The registry is the source of truth for index kinds and their
        # knobs — a typo'd build param must die at spec load, not after
        # the tier has been serving for an hour and tries to scale up.
        try:
            self.make_index_builder()
        except (ValueError, TypeError) as e:
            raise InvalidTierSpec(f"index/build_params rejected: {e}") from e

    def make_index_builder(self, device="cuda") -> IndexBuilder:
        """A fresh ``IndexBuilder`` for this spec's index kind/params,
        building on ``device``."""
        return make_builder(self.index, device=device, **self.build_params)

    @property
    def window_ticks(self) -> int:
        """Samples in a full decision window (>= 1)."""
        return max(1, round(self.window_s / self.tick_s))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TierSpec":
        if not isinstance(data, dict):
            raise InvalidTierSpec(
                f"tier spec must be a JSON object, got "
                f"{type(data).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise InvalidTierSpec(
                f"unknown tier spec keys {unknown}; known: {sorted(known)}"
            )
        return cls(**data)

    @classmethod
    def from_json(cls, text: str) -> "TierSpec":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise InvalidTierSpec(f"tier spec is not valid JSON: {e}") from e
        return cls.from_dict(data)

    @classmethod
    def from_file(cls, path: str) -> "TierSpec":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())


class Autoscaler:
    """Scale a live ``QueryRouter`` tier to track shed pressure.

    ``spec`` bounds and parameterises every decision (see ``TierSpec``).
    New replicas come from ``replica_factory(slot) -> (encode_fn,
    search_fn)`` when given (engine tiers hand one that closes over the
    slot's submesh); otherwise from the spec's own index builder over
    ``snapshot`` with ``encode_fn`` — ``IndexBuilder.build(snapshot,
    replica=slot)``, the same constructor the swap path uses.

    ``device`` places the replicas the spec's builder makes (``"cuda"``
    by default; a ``replica_factory`` places its own).

    ``canary`` (default ``warm_batches[0]``) is the admission probe
    batch; ``expect`` optionally pins its (scores, ids). ``pressure_fn``
    replaces the stats-derived pressure signal — tests use it to feed
    synthetic traces; production leaves it None.

    The loop never acts on a partial window, never acts twice within
    ``cooldown_s``, and clears its window after acting; bounds
    violations (a tier below ``min_replicas`` after a failed probe, or
    above ``max_replicas`` after a spec edit) are corrected immediately,
    cooldown notwithstanding — the spec is desired state, not advice.
    """

    def __init__(
        self,
        router: QueryRouter,
        spec: TierSpec,
        *,
        snapshot: Optional[CorpusSnapshot] = None,
        encode_fn: Optional[EncodeFn] = None,
        replica_factory: Optional[
            Callable[[int], Tuple[EncodeFn, SearchFn]]
        ] = None,
        warm_batches: Optional[List[Any]] = None,
        canary: Any = None,
        expect: Any = None,
        pressure_fn: Optional[Callable[[], float]] = None,
        clock: Clock = SYSTEM_CLOCK,
        probe_timeout: float = 30.0,
        drain_timeout: float = 30.0,
        on_event: Optional[Callable[[str], None]] = None,
        device="cuda",
    ):
        if canary is None and warm_batches:
            canary = warm_batches[0]
        if canary is None:
            raise ValueError("need a canary batch (or warm_batches)")
        self.router = router
        self.spec = spec
        self.clock = clock
        self.snapshot = snapshot
        self._warm = warm_batches
        self._canary = canary
        self._expect = expect
        self._pressure_fn = pressure_fn
        self._probe_timeout = probe_timeout
        self._drain_timeout = drain_timeout
        self._log = on_event or (lambda msg: None)

        self._builder: Optional[IndexBuilder] = None
        if replica_factory is None:
            if snapshot is None or encode_fn is None:
                raise ValueError(
                    "need snapshot + encode_fn (to build replicas from "
                    "the spec) or an explicit replica_factory"
                )
            self._builder = spec.make_index_builder(device)

            def replica_factory(slot: int) -> Tuple[EncodeFn, SearchFn]:
                return encode_fn, self._builder.build(snapshot, replica=slot)

        self._factory = replica_factory

        self._window: List[float] = []
        self._prev_totals: Optional[Tuple[int, int]] = None
        self._last_action_t: Optional[float] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        self.scale_up_count = 0
        self.scale_down_count = 0
        self.probe_failures = 0
        n = len(router.active_replicas())
        self.max_replicas_seen = n
        self.min_replicas_seen = n
        #: Every decision, in order: dicts with t / decision / pressure
        #: / replicas (and replica index for scaling actions).
        self.events: List[Dict[str, Any]] = []

    # -- pressure signal -----------------------------------------------

    def pressure(self) -> float:
        """Instantaneous tier pressure in [0, 1].

        ``max`` of two signals: queue occupancy (outstanding tickets
        over routable queue capacity — rises BEFORE sheds start) and
        the shed fraction since the previous sample (sheds per
        admission attempt — catches saturation a deep queue hides).
        """
        if self._pressure_fn is not None:
            return min(1.0, max(0.0, float(self._pressure_fn())))
        stats = self.router.stats()
        healthy = stats["healthy"]
        depth = max(1, self.router.replicas.config.queue_depth)
        out = self.router.outstanding()
        queue_frac = (
            sum(out.get(i, 0) for i in healthy) / (len(healthy) * depth)
            if healthy else 1.0
        )
        shed, req = stats["shed"], stats["requests"]
        if self._prev_totals is None:
            shed_frac = 0.0
        else:
            d_shed = shed - self._prev_totals[0]
            d_req = req - self._prev_totals[1]
            attempts = d_shed + d_req
            shed_frac = d_shed / attempts if attempts > 0 else 0.0
        self._prev_totals = (shed, req)
        return min(1.0, max(queue_frac, shed_frac))

    # -- actuation ------------------------------------------------------

    def _scale_up(self) -> bool:
        """Add one replica; True once it is warmed, probed, and routable."""
        slot = len(self.router.replicas.pipelines)
        encode_fn, search_fn = self._factory(slot)
        if self._warm:
            # Warm the throwaway pair first: stage threads carry
            # per-thread library state, and an un-warmed replica would
            # serve its first real batches through that set-up — the
            # exact latency spike a scale-up is meant to relieve.
            serving.warmup_replicas([(encode_fn, search_fn)], self._warm)
        slot = self.router.add_replica(encode_fn, search_fn)
        if self._builder is not None and self.snapshot is not None:
            self.router.set_version(
                slot, builder_version(self._builder, self.snapshot)
            )
        if self.router.probe(slot, self._canary, expect=self._expect,
                             timeout=self._probe_timeout,
                             from_rebuild=True):
            self.scale_up_count += 1
            self._log(f"scale-up: replica {slot} admitted")
            return True
        # Failed canary: the slot is unhealthy and has never served —
        # retire it so capacity accounting (and the next decision) do
        # not count a replica that cannot take traffic.
        self.probe_failures += 1
        self.router.retire_replica(slot)
        self._log(f"scale-up: replica {slot} failed its canary; retired")
        return False

    def _scale_down(self) -> Optional[int]:
        """Drain + retire one replica (newest slot first); its index."""
        healthy = self.router.healthy()
        if len(healthy) <= 1:
            return None  # never retire the last routable replica
        victim = max(healthy)
        self.router.retire_replica(victim, timeout=self._drain_timeout)
        self.scale_down_count += 1
        self._log(f"scale-down: replica {victim} drained and retired")
        return victim

    # -- the decision loop ---------------------------------------------

    def tick(self) -> str:
        """One control-loop step; returns the decision taken.

        One of ``"scale-up"``, ``"scale-down"``, ``"hold"``,
        ``"warming"`` (window not yet full), ``"cooldown"``,
        ``"below-min"`` / ``"above-max"`` (bounds enforcement), or
        ``"scale-up-failed"``.
        """
        with self._lock:
            now = self.clock.now()
            p = self.pressure()
            n = len(self.router.active_replicas())
            decision = self._decide(now, p, n)
            n = len(self.router.active_replicas())
            self.max_replicas_seen = max(self.max_replicas_seen, n)
            self.min_replicas_seen = min(self.min_replicas_seen, n)
            self.events.append({
                "t": now, "decision": decision, "pressure": p,
                "replicas": n,
            })
            return decision

    def _decide(self, now: float, p: float, n: int) -> str:
        spec = self.spec
        # Desired-state enforcement outruns hysteresis AND cooldown: a
        # tier outside its bounds is wrong, not noisy.
        if n < spec.min_replicas:
            ok = self._scale_up()
            self._after_action(now)
            return "below-min" if ok else "scale-up-failed"
        if n > spec.max_replicas:
            self._scale_down()
            self._after_action(now)
            return "above-max"
        self._window.append(p)
        if len(self._window) > spec.window_ticks:
            self._window.pop(0)
        if len(self._window) < spec.window_ticks:
            return "warming"
        if self._last_action_t is not None \
                and now - self._last_action_t < spec.cooldown_s:
            return "cooldown"
        mean = sum(self._window) / len(self._window)
        if mean >= spec.high_water and n < spec.max_replicas:
            ok = self._scale_up()
            self._after_action(now)
            return "scale-up" if ok else "scale-up-failed"
        if mean <= spec.low_water and n > spec.min_replicas:
            self._scale_down()
            self._after_action(now)
            return "scale-down"
        return "hold"

    def _after_action(self, now: float) -> None:
        # Pre-action samples describe a tier shape that no longer
        # exists; deciding on them would double-count one burst.
        self._window.clear()
        self._last_action_t = now

    # -- background loop ------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        """Tick every ``spec.tick_s`` until ``stop`` is set (the wait
        is clock-driven and interruptible — a FakeClock test advances
        through it; ``stop.set()`` wakes it immediately)."""
        while not self.clock.wait(stop, self.spec.tick_s):
            self.tick()

    def start(self) -> None:
        """Run the loop on a daemon thread; idempotent while alive."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self.run, args=(self._stop,),
            name="tier-autoscaler", daemon=True,
        )
        self._thread.start()

    def stop(self, *, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
            if t.is_alive():
                raise RuntimeError(
                    f"autoscaler thread did not exit within {timeout}s"
                )

    def summary(self) -> Dict[str, Any]:
        """Counters + bounds telemetry for the bench emitter / gate."""
        n = len(self.router.active_replicas())
        return {
            "replicas": n,
            "replicas_min": self.spec.min_replicas,
            "replicas_max": self.spec.max_replicas,
            "scale_ups": self.scale_up_count,
            "scale_downs": self.scale_down_count,
            "probe_failures": self.probe_failures,
            "max_replicas_seen": self.max_replicas_seen,
            "min_replicas_seen": self.min_replicas_seen,
            "decisions": len(self.events),
        }
