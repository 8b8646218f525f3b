"""The injectable clock of the port's serving tier (``repro_torch/launch/
clock.py``) against the reference's (``repro/launch/clock.py``).

The module is a verbatim port, so each case runs one schedule of
``sleep``/``wait``/``advance``/``tick`` on both packages' clocks and
compares what each observed; real waits are the fake clock's 5 ms poll
quantum and joins on threads already released.
"""

import inspect
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.launch import clock as RC  # noqa: E402
from repro_torch.launch import clock as PC  # noqa: E402

SIDES = pytest.mark.parametrize("mod", [RC, PC], ids=["ref", "port"])


@pytest.mark.parametrize("name", ["Clock", "SystemClock", "FakeClock"])
def test_classes_are_the_reference_code(name):
    """A verbatim port: every class body is the reference's, line for line."""
    assert inspect.getsource(getattr(PC, name)) == inspect.getsource(getattr(RC, name))


def test_clock_protocol_is_satisfied_across_packages():
    for mod in (PC, RC):
        for clk in (PC.SYSTEM_CLOCK, PC.SystemClock(), PC.FakeClock()):
            assert isinstance(clk, mod.Clock)
    assert isinstance(PC.SYSTEM_CLOCK, PC.SystemClock)


def test_system_clock_is_perf_counter():
    before = time.perf_counter()
    now = PC.SYSTEM_CLOCK.now()
    assert before <= now <= time.perf_counter()
    ev = threading.Event()
    ev.set()
    assert PC.SYSTEM_CLOCK.wait(ev, 10.0) is True
    PC.SYSTEM_CLOCK.sleep(0.0)  # no-op


def _advance_schedule(mod):
    clk = mod.FakeClock(start=100.0)
    seen = [clk.now()]
    clk.advance(2.5)
    seen.append(clk.now())
    with pytest.raises(ValueError, match="backwards") as e:
        clk.advance(-0.1)
    return seen + [str(e.value), mod.FakeClock().now()]


def test_fake_clock_now_moves_only_on_advance():
    assert _advance_schedule(PC) == _advance_schedule(RC) == [
        100.0, 102.5, "cannot advance time backwards (dt=-0.1)", 1_000_000.0]


def _sleep_schedule(mod):
    clk = mod.FakeClock()
    woke = []
    th = threading.Thread(target=lambda: (clk.sleep(5.0), woke.append(clk.now())))
    th.start()
    seen = [clk.wait_for_sleepers(1), clk.sleepers, list(woke)]
    clk.advance(4.9)
    seen.append(th.is_alive())
    clk.advance(0.1)  # the deadline exactly
    th.join(timeout=5)
    return seen + [th.is_alive(), woke, clk.sleepers]


def test_fake_clock_sleep_parks_until_advance():
    got = _sleep_schedule(PC)
    assert got == _sleep_schedule(RC)
    assert got == [True, 1, [], True, False, [1_000_005.0], 0]


@SIDES
def test_fake_clock_wait_is_level_triggered_on_the_event(mod):
    clk = mod.FakeClock()
    ev = threading.Event()
    ev.set()
    t0 = clk.now()
    assert clk.wait(ev, 60.0) is True and clk.now() == t0


def _wait_schedule(mod, set_event):
    clk = mod.FakeClock()
    ev = threading.Event()
    out = []
    th = threading.Thread(target=lambda: out.append(clk.wait(ev, 3.0)))
    th.start()
    assert clk.wait_for_sleepers(1)
    if set_event:
        ev.set()  # the production interrupt: no clock advance at all
    else:
        clk.advance(3.0)
    th.join(timeout=5)
    return out, th.is_alive(), clk.now()


@pytest.mark.parametrize("set_event", [False, True])
def test_fake_clock_wait_times_out_or_wakes_on_the_event(set_event):
    got = _wait_schedule(PC, set_event)
    assert got == _wait_schedule(RC, set_event)
    assert got == ([set_event], False, 1_000_000.0 + (0.0 if set_event else 3.0))


def _tick_schedule(mod, n):
    clk = mod.FakeClock()
    stop = threading.Event()
    iters = []
    th = threading.Thread(
        target=lambda: [iters.append(clk.now()) for _ in iter(lambda: clk.wait(stop, 1.0), True)])
    th.start()
    for _ in range(n):
        clk.tick(1.0)
    stop.set()
    th.join(timeout=5)
    return iters, th.is_alive()


def test_fake_clock_tick_hands_a_loop_exactly_one_interval():
    got = _tick_schedule(PC, 3)
    assert got == _tick_schedule(RC, 3)
    assert got == ([1_000_001.0, 1_000_002.0, 1_000_003.0], False)


@SIDES
def test_fake_clock_tick_raises_when_no_thread_parks(mod):
    clk = mod.FakeClock()
    with pytest.raises(TimeoutError, match="no thread parked"):
        clk.tick(1.0, timeout=0.02)
    assert clk.now() == 1_000_000.0  # nothing parked: time did not move
