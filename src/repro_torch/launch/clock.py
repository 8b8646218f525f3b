"""Injectable time source for the serving tier's control loops (ports
``repro/launch/clock.py`` verbatim: it is pure Python).

Every control-loop behavior in the tier — probe backoff, retry backoff,
watchdog polls, autoscaler hysteresis and cooldowns — is a function of
*time*, and for years of wall-clock-tested control systems the lesson is
the same: testing them against the real clock makes every property slow
(sleep long enough to observe it) and flaky (the host decides how long a
"sleep" really was). This module makes time a dependency you inject:

  * ``Clock`` — the protocol: ``now()`` (monotonic seconds), ``sleep()``,
    and ``wait(event, timeout)`` — an *interruptible* sleep that returns
    the moment ``event`` is set. Loops must use ``wait`` with their stop
    event rather than ``sleep``, so a ``close()`` mid-backoff interrupts
    the wait instead of waiting out the full delay.
  * ``SystemClock`` — the production implementation: ``time.perf_counter``
    + ``time.sleep`` + ``threading.Event.wait``. A module singleton
    ``SYSTEM_CLOCK`` is the default everywhere, so threading a clock
    through a code path changes nothing until a test injects a fake.
  * ``FakeClock`` — simulated time under manual control: ``advance(dt)``
    moves the clock and wakes every thread blocked in ``sleep``/``wait``
    whose deadline has passed. ``wait_for_sleepers(n)`` blocks (briefly,
    in real time) until ``n`` threads are parked on the clock, which is
    how a test hands control back and forth with a loop deterministically:
    wait for the loop to park, advance exactly one interval, observe.

Invariants:

  * ``SystemClock.now`` IS ``time.perf_counter`` — deadlines computed
    from ``clock.now()`` stay comparable with the tier's existing
    ``perf_counter``-based ticket timestamps.
  * ``FakeClock`` never busy-waits and never sleeps real time longer
    than its poll quantum (default 5 ms, far under the suite's 50 ms
    real-sleep budget); time moves only when ``advance`` is called.
  * ``wait`` is level-triggered on the event: an event already set
    returns True immediately, on both implementations.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """What the tier's control loops need from a time source."""

    def now(self) -> float:
        """Monotonic seconds (comparable with ``time.perf_counter`` on
        the system implementation)."""
        ...

    def sleep(self, seconds: float) -> None:
        """Block this thread for ``seconds`` of clock time."""
        ...

    def wait(self, event: threading.Event, timeout: Optional[float]) -> bool:
        """Interruptible sleep: block until ``event`` is set (True) or
        ``timeout`` clock-seconds pass (False). ``None`` waits forever."""
        ...


class SystemClock:
    """The real clock: ``perf_counter`` / ``sleep`` / ``Event.wait``."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def wait(self, event: threading.Event, timeout: Optional[float]) -> bool:
        return event.wait(timeout)


#: Default clock for every control loop; inject a ``FakeClock`` in tests.
SYSTEM_CLOCK = SystemClock()


class FakeClock:
    """Manually advanced simulated time with waiter wakeup.

    ``now()`` returns the simulated instant; ``advance(dt)`` moves it
    forward and wakes every parked ``sleep``/``wait`` whose deadline has
    passed. Threads blocked in ``wait(event, ...)`` also notice the
    event being set from any thread within one poll quantum (a short
    *real* condition wait re-checks it), so production code that
    interrupts a backoff via ``event.set()`` works unmodified under the
    fake — no test hook needed at the set site.

    ``start`` deliberately defaults to a large offset rather than 0.0:
    code that mixes ``clock.now()`` deadlines with unconverted
    ``time.perf_counter()`` reads would "work" at small fake times and
    only break on long-lived processes; starting high makes that class
    of bug loud in tests instead.
    """

    def __init__(self, start: float = 1_000_000.0, poll_s: float = 0.005):
        self._t = float(start)
        self._cond = threading.Condition()
        self._poll_s = poll_s
        self._sleepers = 0
        self._parks = 0

    def now(self) -> float:
        with self._cond:
            return self._t

    def advance(self, dt: float) -> None:
        """Move simulated time forward by ``dt`` and wake all waiters."""
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        with self._cond:
            self._t += dt
            self._cond.notify_all()

    @property
    def sleepers(self) -> int:
        """Number of threads currently parked in ``sleep``/``wait``."""
        with self._cond:
            return self._sleepers

    def wait_for_sleepers(self, n: int, *, timeout: float = 10.0) -> bool:
        """Block (real time) until >= ``n`` threads are parked on this
        clock; the test-side handshake that makes advance() race-free."""
        with self._cond:
            return self._cond.wait_for(lambda: self._sleepers >= n, timeout)

    def tick(self, dt: float, *, timeout: float = 10.0) -> None:
        """Lockstep advance for driving ONE control loop: wait for a
        thread to park on the clock, move time forward by ``dt``, then
        block (real time) until some thread parks again — i.e. the loop
        woke, did one iteration's work, and came back to its wait. With
        a single loop on the clock this hands it exactly one tick; with
        several, use ``wait_for_sleepers`` + ``advance`` by hand.

        Raises ``TimeoutError`` if no thread parks within ``timeout``
        real seconds on either side of the advance (loop dead/wedged).
        """
        with self._cond:
            if not self._cond.wait_for(lambda: self._sleepers >= 1, timeout):
                raise TimeoutError(
                    f"tick({dt}): no thread parked on the clock within "
                    f"{timeout}s")
            before = self._parks
            self._t += max(0.0, dt)
            self._cond.notify_all()
            if not self._cond.wait_for(lambda: self._parks > before, timeout):
                raise TimeoutError(
                    f"tick({dt}): no thread re-parked within {timeout}s "
                    "after the advance (loop exited or wedged?)")

    def sleep(self, seconds: float) -> None:
        with self._cond:
            deadline = self._t + max(0.0, seconds)
            self._sleepers += 1
            self._parks += 1
            self._cond.notify_all()  # wake wait_for_sleepers watchers
            try:
                while self._t < deadline:
                    # Poll quantum only as a lost-wakeup safety net;
                    # advance() notifies, so the common path never waits
                    # out the quantum.
                    self._cond.wait(self._poll_s)
            finally:
                self._sleepers -= 1
                self._cond.notify_all()

    def wait(self, event: threading.Event, timeout: Optional[float]) -> bool:
        with self._cond:
            deadline = None if timeout is None else self._t + max(0.0, timeout)
            self._sleepers += 1
            self._parks += 1
            self._cond.notify_all()
            try:
                while True:
                    if event.is_set():
                        return True
                    if deadline is not None and self._t >= deadline:
                        return False
                    # Short real wait: re-checks the event (set() does
                    # not notify this condition) and is cut short by
                    # advance()'s notify.
                    self._cond.wait(self._poll_s)
            finally:
                self._sleepers -= 1
                self._cond.notify_all()
