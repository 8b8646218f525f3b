"""Deterministic fault injection in the port (``repro_torch/launch/faults.py``)
against the reference (``repro/launch/faults.py``), with the robustness
primitives it drives: the ``--chaos`` grammar (the same plans, the same
errors), the four fault kinds on the same schedules and logs, seeded
probabilistic replay (the same draws), ``EffortKnob`` and
``probe_backoff``, and the port's index closures under the effort knob
held against the reference's at every level, bit for bit.
"""

import inspect
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tier as W  # noqa: E402
from repro.index import hnsw_lite as RH  # noqa: E402
from repro.index import ivf as RI  # noqa: E402
from repro.launch import faults as RF  # noqa: E402
from repro.launch import proxy as RP  # noqa: E402
from repro_torch.index import hnsw_lite as PH  # noqa: E402
from repro_torch.index import ivf as PI  # noqa: E402
from repro_torch.launch import clock as PC  # noqa: E402
from repro_torch.launch import faults as PF  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402

LEVELS = W.LEVELS


def _injector(mod, plan, clock=None):
    return mod.FaultInjector(lambda x: ("enc", x), lambda c: ("scan", c), plan, name="t",
                             clock=clock)


def _events(plans):
    return {i: (repr(p.events), p.seed) for i, p in plans.items()}


@pytest.mark.parametrize("name", ["FaultEvent", "FaultPlan", "FaultInjector", "wrap_replicas",
                                  "parse_chaos_spec", "apply_chaos"])
def test_fault_code_is_the_reference_code(name):
    """A verbatim port: only the module docstring differs."""
    assert inspect.getsource(getattr(PF, name)) == inspect.getsource(getattr(RF, name))


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "r1.search.fail@10x3, delay@0x*:0.02, encode.fail~0.25, seed=7",
    "stick@40", "r1.fail@10x3", "delay@0x*:0.02", "encode.fail~0.05,seed=7",
    "r2.flap@4x2:5,r0.search.stick@1", "",
])
def test_parse_chaos_spec_equals_reference(spec):
    got = PF.parse_chaos_spec(spec)
    assert _events(got) == _events(RF.parse_chaos_spec(spec))
    if spec.startswith("r1.search"):
        assert set(got) == {0, 1} and all(p.seed == 7 for p in got.values())
        (f,) = got[1].events
        assert (f.kind, f.stage, f.at, f.count) == ("fail", "search", 10, 3)
        d, e = got[0].events
        assert (d.kind, d.at, d.count, d.arg) == ("delay", 0, 0, 0.02)
        assert (e.kind, e.stage, e.prob) == ("fail", "encode", 0.25)


@pytest.mark.parametrize("spec", [
    "bogus", "r1.explode@3", "fail~1.5", "seed=x", "delay@3", "flap@0x4:2",
    "search.fail@3x2:nope",
])
def test_parse_chaos_spec_rejects_bad_clauses_as_the_reference(spec):
    got = W.error_of(PF.parse_chaos_spec, spec)
    assert got == W.error_of(RF.parse_chaos_spec, spec)
    assert got[0] == "ValueError"


def test_apply_chaos_none_is_untouched_and_bad_replica_rejected():
    replicas = [W.identity_replica(W.PORT, 0), W.identity_replica(W.PORT, 1)]
    out, injectors = PF.apply_chaos(replicas, None)
    assert out == list(replicas) and injectors == {}
    got = W.error_of(PF.wrap_replicas, replicas, {5: PF.FaultPlan.fail_first(1)})
    assert got == W.error_of(RF.wrap_replicas, replicas, {5: RF.FaultPlan.fail_first(1)})
    assert "replica 5" in got[1]
    out, injectors = PF.apply_chaos(replicas, "r1.fail@0")
    assert out[0] == replicas[0] and set(injectors) == {1}
    assert out[1] == injectors[1].pair


# ---------------------------------------------------------------------------
# fault kinds on schedule
# ---------------------------------------------------------------------------


def _outcomes(inj, n, stage="search"):
    out = []
    for i in range(n):
        try:
            getattr(inj, stage)(i)
            out.append(True)
        except Exception as e:  # noqa: BLE001 - the schedule records what was raised
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("plan", [
    lambda m: m.FaultPlan.fail_first(2),
    lambda m: m.FaultPlan.fail_after(1),
    lambda m: m.FaultPlan.fail_at(1, 3),
    lambda m: m.FaultPlan([m.FaultEvent("flap", at=2, count=1, arg=3.0)]),
    lambda m: m.FaultPlan([m.FaultEvent("fail", count=0, at=4, stage="encode")]),
], ids=["fail_first", "fail_after", "fail_at", "flap", "encode_fail_after"])
def test_positional_schedules_equal_reference(plan):
    runs = []
    for mod in (RF, PF):
        inj = _injector(mod, plan(mod))
        runs.append((_outcomes(inj, 9), _outcomes(inj, 6, "encode"), inj.log, inj.calls))
    assert runs[0] == runs[1]
    flap = _outcomes(_injector(PF, plan(PF)), 9)
    if plan(PF).events[0].kind == "flap":  # calls 2, 5, 8 fail
        assert [o is True for o in flap] == [True, True, False, True, True, False, True,
                                             True, False]


def test_fail_first_then_recovers_and_logs():
    inj = _injector(PF, PF.FaultPlan.fail_first(2))
    for i in range(2):
        with pytest.raises(PF.InjectedFault, match=f"search call {i}"):
            inj.search(i)
    assert inj.search("x") == ("scan", "x")
    assert inj.encode("e") == ("enc", "e")
    assert inj.log == [("search", 0, "fail"), ("search", 1, "fail")]
    assert inj.calls == {"encode": 1, "search": 3}
    assert issubclass(PF.InjectedFault, RuntimeError)


def test_delay_every_parks_on_the_clock_then_calls_through():
    clk = PC.FakeClock()
    inj = _injector(PF, PF.FaultPlan.delay_every(0.05, at=1), clock=clk)
    assert inj.search(0) == ("scan", 0)
    assert clk.sleepers == 0
    out = []
    th = threading.Thread(target=lambda: out.append(inj.search(1)))
    th.start()
    assert clk.wait_for_sleepers(1)
    assert th.is_alive() and not out
    clk.advance(0.05)
    th.join(timeout=5)
    assert not th.is_alive() and out == [("scan", 1)]
    assert inj.log == [("search", 1, "delay")]


def test_stick_blocks_until_release_then_calls_through():
    inj = _injector(PF, PF.FaultPlan.stick_at(0))
    out = []
    th = threading.Thread(target=lambda: out.append(inj.search("q")))
    th.start()
    deadline = time.time() + 5
    while time.time() < deadline and inj.stuck_count == 0:
        time.sleep(0.002)
    assert th.is_alive() and inj.stuck_count == 1 and not out
    inj.release()
    th.join(timeout=5)
    assert not th.is_alive() and out == [("scan", "q")]
    inj2 = _injector(PF, PF.FaultPlan.stick_at(0))
    inj2.release()
    assert inj2.search("q") == ("scan", "q")


@pytest.mark.parametrize("seed", [3, 4])
def test_probabilistic_schedule_replays_the_reference_draws(seed):
    def schedule(mod, s):
        return _outcomes(_injector(mod, mod.FaultPlan([mod.FaultEvent("fail", prob=0.4)],
                                                      seed=s)), 40)

    got = schedule(PF, seed)
    assert got == schedule(RF, seed) == schedule(PF, seed)
    assert any(o is True for o in got) and not all(o is True for o in got)
    assert schedule(PF, seed + 10) != got


def test_encode_prob_clause_does_not_perturb_search_schedule():
    def search_schedule(mod, both):
        evs = [mod.FaultEvent("fail", stage="search", prob=0.4)]
        if both:
            evs.append(mod.FaultEvent("fail", stage="encode", prob=0.4))
        inj = _injector(mod, mod.FaultPlan(evs, seed=5))
        out = []
        for i in range(30):
            if both:
                try:
                    inj.encode(i)
                except mod.InjectedFault:
                    pass
            try:
                inj.search(i)
                out.append(True)
            except mod.InjectedFault:
                out.append(False)
        return out

    assert search_schedule(PF, False) == search_schedule(PF, True) \
        == search_schedule(RF, True)


def test_wrapped_stage_keeps_the_closure_metadata():
    """``reranked`` and the effort knob survive the wrapping (the knob by
    reference, so the router's level changes reach the closure)."""
    knob = PP.EffortKnob(3)

    def search(c):
        return c, c

    search.reranked, search.effort = True, knob
    inj = PF.FaultInjector(lambda x: x, search, PF.FaultPlan(), name="r0")
    assert inj.search.reranked is True and inj.search.effort is knob
    assert not hasattr(inj.encode, "effort")


# ---------------------------------------------------------------------------
# effort knob + probe backoff
# ---------------------------------------------------------------------------


def test_effort_knob_steps_equal_reference():
    def run(mod):
        knob = mod.EffortKnob(3)
        seen = [(knob.level, knob.max_level)]
        for op in ("degrade", "degrade", "degrade", "restore", "restore", "restore",
                   "degrade", "reset"):
            seen.append((getattr(knob, op)(), knob.level, knob.degrade_count,
                         knob.restore_count))
        return seen + [mod.EffortKnob(1).degrade(), W.error_of(mod.EffortKnob, 0)]

    assert run(PP) == run(RP)
    assert run(PP)[0] == (0, 2)


def test_probe_backoff_equals_reference():
    for interval in (0.1, 1.0, 2.5):
        for n in range(0, 60):
            assert PP.probe_backoff(interval, n) == RP.probe_backoff(interval, n)
        assert PP.probe_backoff(interval, 3, cap_factor=2.0) == \
            RP.probe_backoff(interval, 3, cap_factor=2.0)
    np.testing.assert_allclose([PP.probe_backoff(0.1, n) for n in range(1, 6)],
                               [0.1, 0.2, 0.4, 0.8, 1.6])
    assert PP.probe_backoff(0.1, 0) == 0.0
    assert PP.probe_backoff(0.1, 50) == pytest.approx(1.6)


# ---------------------------------------------------------------------------
# the port's index closures under the effort knob, level by level
# ---------------------------------------------------------------------------


def _levels(closure, knob, q, n):
    out = []
    for _ in range(n):
        out.append(closure(q))
        knob.degrade()
    return out


def test_ivf_effort_levels_equal_reference(monkeypatch):
    W.hand_over_reference_inputs(monkeypatch, seed=1)
    cd, cq = W.code_corpus(n=400, q=16)
    kw = dict(k=10, nlist=8, nprobe=4, seed=1, kmeans_iters=3)
    rknob, pknob = RP.EffortKnob(3), PP.EffortKnob(3)
    want = _levels(RI.ivf_search_from_snapshot(cd, LEVELS, effort=rknob, backend="xla", **kw),
                   rknob, cq, 4)
    fn = PI.ivf_search_from_snapshot(cd, LEVELS, effort=pknob, device="cpu", **kw)
    assert fn.effort is pknob
    got = _levels(fn, pknob, torch.from_numpy(cq), 4)
    assert W.same_results(want, got)
    # level 1 is the closure built at nprobe 2
    half = PI.ivf_search_from_snapshot(cd, LEVELS, device="cpu", **dict(kw, nprobe=2))
    assert W.same_results([got[1]], [half(torch.from_numpy(cq))])


def test_hnsw_effort_levels_equal_reference(monkeypatch):
    W.hand_over_reference_inputs(monkeypatch, seed=0)
    cd, cq = W.code_corpus(n=400, q=16)
    kw = dict(k=10, M=8, ef_construction=24, ef=24, beam=8, seed=0)
    rknob, pknob = RP.EffortKnob(3), PP.EffortKnob(3)
    want = _levels(RH.hnsw_search_from_snapshot(cd, LEVELS, effort=rknob, backend="xla", **kw),
                   rknob, cq, 3)
    fn = PH.hnsw_search_from_snapshot(cd, LEVELS, effort=pknob, device="cpu", **kw)
    assert fn.effort is pknob
    assert W.same_results(want, _levels(fn, pknob, torch.from_numpy(cq), 3))
