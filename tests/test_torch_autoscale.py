"""The port's shed-pressure autoscaler and declarative tier spec
(``repro_torch/launch/autoscale.py``) against the reference's
(``repro/launch/autoscale.py``).

``TierSpec`` validation is held against the reference error for error,
message for message. The control loop runs on a ``FakeClock`` with a
synthetic pressure trace, on both packages, and its decisions, counters
and replica counts must be the same tick for tick. The spec's own
builder makes scale-up replicas over a snapshot on the CPU
(``device="cpu"``); their results are held against the reference's. No
test sleeps real time beyond the fake clock's poll quantum and joins on
released work.
"""

import json
import random
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tier as W  # noqa: E402
from repro.launch import autoscale as RA  # noqa: E402
from repro_torch.launch import autoscale as PA  # noqa: E402
from repro_torch.launch import clock as PC  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402
from repro_torch.launch import serving as PS  # noqa: E402

PORT, REF = W.PORT, W.REF


def _tier(side, clk, n=1, queue_depth=4, policy="shed"):
    return side.proxy.QueryRouter(
        side.proxy.ReplicaSet([W.identity_replica(side, i) for i in range(n)],
                              config=side.serving.ServingConfig(queue_depth=queue_depth,
                                                                policy=policy)),
        clock=clk)


def _scaler(side, router, spec, clk, pressure, **kw):
    kw.setdefault("replica_factory", lambda slot: W.identity_replica(side, slot))
    kw.setdefault("warm_batches", W.batches(side, 1))
    return side.autoscale.Autoscaler(router, spec, clock=clk,
                                     pressure_fn=lambda: pressure[0], **kw)


def _decisions(scaler):
    return [(e["t"], e["decision"], e["pressure"], e["replicas"]) for e in scaler.events]


def _run_both(scenario, *args):
    """``scenario(side, *args)`` on both packages; equal outcomes; the port's."""
    got = scenario(PORT, *args)
    assert got == scenario(REF, *args)
    return got


# ---------------------------------------------------------------------------
# TierSpec
# ---------------------------------------------------------------------------


def test_tier_spec_fields_defaults_and_policies_equal_reference():
    assert PA.ADMISSION_POLICIES == RA.ADMISSION_POLICIES
    assert PA.TierSpec().to_dict() == RA.TierSpec().to_dict()
    assert "device" not in PA.TierSpec().to_dict()  # placement, not the tier's shape
    assert issubclass(PA.InvalidTierSpec, ValueError)


def test_tier_spec_defaults_validate_and_round_trip():
    spec = PA.TierSpec(min_replicas=1, max_replicas=3, build_params={"k": 5})
    again = PA.TierSpec.from_json(json.dumps(spec.to_dict()))
    assert again == spec and spec.window_ticks == 3
    assert RA.TierSpec.from_json(json.dumps(spec.to_dict())).to_dict() == spec.to_dict()


def test_tier_spec_window_ticks_rounds_and_floors_at_one():
    for mod in (PA, RA):
        assert mod.TierSpec(window_s=0.1, tick_s=0.05).window_ticks == 2
        assert mod.TierSpec(window_s=1.0, tick_s=1.0).window_ticks == 1


BAD_SPECS = [
    dict(min_replicas=0), dict(min_replicas=True), dict(min_replicas=2, max_replicas=1),
    dict(max_replicas=2.0), dict(queue_depth=0), dict(queue_depth=-1), dict(policy="drop"),
    dict(router="hash-ring"), dict(high_water=0.3, low_water=0.3), dict(high_water=1.5),
    dict(low_water=-0.1), dict(high_water=0.2, low_water=0.4), dict(tick_s=0.0),
    dict(window_s=0.5, tick_s=1.0), dict(cooldown_s=-1.0), dict(swap_every_s=-5.0),
    dict(tick_s="1"), dict(build_params=[("k", 5)]), dict(index="pq"),
    dict(index="flat", build_params={"nlist": 8}), dict(index="hnsw", build_params={"nprobe": 2}),
    dict(index="ivf", build_params={"coarse_levels": 2}),
]


@pytest.mark.parametrize("bad", BAD_SPECS, ids=[str(b) for b in BAD_SPECS])
def test_tier_spec_rejects_malformed_fields_as_the_reference(bad):
    got = W.error_of(PA.TierSpec, **bad)
    assert got == W.error_of(RA.TierSpec, **bad)
    assert got[0] == "InvalidTierSpec"


def test_tier_spec_error_names_the_field():
    with pytest.raises(PA.InvalidTierSpec, match="queue_depth"):
        PA.TierSpec(queue_depth=-1)
    with pytest.raises(PA.InvalidTierSpec, match="low_water"):
        PA.TierSpec(high_water=0.2, low_water=0.4)
    with pytest.raises(PA.InvalidTierSpec, match=str(PA.ADMISSION_POLICIES)[1:-1]):
        PA.TierSpec(policy="bogus")


@pytest.mark.parametrize("text", [
    '{"min_replicas": 1, "replicas": 3}', "[1, 2, 3]", "{min_replicas: 1", '"flat"',
    '{"min_replicas": 2, "max_replicas": 3, "index": "ivf", "build_params": {"nlist": 8}}',
])
def test_tier_spec_from_json_equals_reference(text):
    try:
        got = PA.TierSpec.from_json(text).to_dict()
    except PA.InvalidTierSpec as e:
        got = ("InvalidTierSpec", str(e))
    try:
        want = RA.TierSpec.from_json(text).to_dict()
    except RA.InvalidTierSpec as e:
        want = ("InvalidTierSpec", str(e))
    assert got == want


def test_tier_spec_from_file_round_trips(tmp_path):
    spec = PA.TierSpec(min_replicas=1, max_replicas=2, index="flat", build_params={"k": 7},
                       high_water=0.6, low_water=0.2)
    p = tmp_path / "spec.json"
    p.write_text(json.dumps(spec.to_dict()))
    assert PA.TierSpec.from_file(str(p)) == spec


def test_spec_builder_takes_a_device_and_touches_none_when_validated():
    """Validation constructs a builder (on the card by default) and never
    resolves its device, so a spec loads on a machine without a card."""
    spec = PA.TierSpec(index="ivf", build_params={"k": 5, "nlist": 8})
    assert spec.make_index_builder().device == "cuda"
    assert spec.make_index_builder("cpu").device == "cpu"
    assert spec.make_index_builder().params == RA.TierSpec(
        index="ivf", build_params={"k": 5, "nlist": 8}).make_index_builder().params | {
            "backend": "auto"}


# ---------------------------------------------------------------------------
# hysteresis, cooldown, bounds: tick for tick against the reference
# ---------------------------------------------------------------------------


def _oscillating(side, low, high, seed):
    rng = random.Random(seed)
    mid, amp = (low + high) / 2, 1.2 * (high - low)
    clk = side.clock.FakeClock()
    router = _tier(side, clk, n=2)
    spec = side.autoscale.TierSpec(min_replicas=1, max_replicas=3, low_water=low,
                                   high_water=high, cooldown_s=0.0, window_s=4.0, tick_s=1.0)
    pressure = [mid]
    scaler = _scaler(side, router, spec, clk, pressure)
    try:
        sign, crossings = 1, 0
        for _ in range(60):
            a = amp * (0.8 + 0.4 * rng.random())
            pressure[0] = min(1.0, max(0.0, mid + sign * a))
            crossings += (pressure[0] >= high or pressure[0] <= low)
            sign = -sign
            scaler.tick()
            clk.advance(spec.tick_s)
    finally:
        router.close()
    return crossings, _decisions(scaler), scaler.summary(), router.active_replicas()


@pytest.mark.parametrize("low,high", [(0.1, 0.5), (0.2, 0.6), (0.3, 0.7)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hysteresis_never_flaps_as_the_reference(low, high, seed):
    crossings, decisions, summary, active = _run_both(_oscillating, low, high, seed)
    assert crossings == 60
    assert summary["scale_ups"] == summary["scale_downs"] == 0 and active == [0, 1]
    assert {d for _, d, _, _ in decisions} <= {"warming", "hold"}


def _trace(side, n, spec_kw, trace):
    """Tick the autoscaler through ``trace`` (pressure per tick, one second
    apart) over an identity tier of ``n`` replicas."""
    clk = side.clock.FakeClock()
    router = _tier(side, clk, n=n)
    spec = side.autoscale.TierSpec(**spec_kw)
    pressure = [trace[0]]
    scaler = _scaler(side, router, spec, clk, pressure)
    out = []
    try:
        for p in trace:
            pressure[0] = p
            out.append(scaler.tick())
            clk.advance(spec.tick_s)
        served = [router.submit(b).result(timeout=10) for b in W.batches(side, 3)]
        states = router.states()
    finally:
        router.close()
    return out, _decisions(scaler), scaler.summary(), states, \
        [(W.host(v).tolist(), W.host(i).tolist()) for v, i in served]


SPEC = dict(min_replicas=1, max_replicas=2, low_water=0.1, high_water=0.5, cooldown_s=0.0,
            window_s=1.0, tick_s=1.0)


@pytest.mark.parametrize("case", [
    ("sustained", 1, dict(SPEC, window_s=4.0), [0.9] * 4),
    ("cooldown", 1, dict(SPEC, max_replicas=3, cooldown_s=10.0), [0.9] * 12),
    ("window-reset", 1, dict(SPEC, max_replicas=3, window_s=2.0), [0.9, 0.9, 0.3, 0.3]),
    ("bounds", 1, SPEC, [1.0] * 6 + [0.0] * 6),
    ("above-max", 3, dict(SPEC, high_water=0.9, cooldown_s=1000.0), [0.5, 0.5]),
    ("below-min", 1, dict(SPEC, min_replicas=2, max_replicas=3, cooldown_s=1000.0), [0.0]),
    ("last-replica", 2, dict(SPEC, high_water=0.9), [0.0] * 4),
], ids=lambda c: c[0])
def test_decisions_equal_reference(case):
    name, n, spec_kw, trace = case
    out, _, summary, states, served = _run_both(_trace, n, spec_kw, trace)
    W.check_identity([(np.array(v), np.array(i)) for v, i in served], 3)
    want = {
        "sustained": ["warming", "warming", "warming", "scale-up"],
        "cooldown": ["scale-up"] + ["cooldown"] * 9 + ["scale-up", "cooldown"],
        "window-reset": ["warming", "scale-up", "warming", "hold"],
        "bounds": ["scale-up"] + ["hold"] * 5 + ["scale-down"] + ["hold"] * 5,
        "above-max": ["above-max", "cooldown"],
        "below-min": ["below-min"],
        "last-replica": ["scale-down", "hold", "hold", "hold"],
    }[name]
    assert out == want
    assert spec_kw["min_replicas"] <= summary["replicas"] <= spec_kw["max_replicas"]
    if name == "bounds":
        assert summary["max_replicas_seen"] == 2 and summary["min_replicas_seen"] == 1
        assert states == {0: "healthy", 1: "retired"}


def _real_pressure(side):
    """The stats-derived signal: one replica whose encode is held, its
    queue full and one submit shed, then released."""
    clk = side.clock.FakeClock()
    gate, started = threading.Event(), threading.Event()

    def encode(x):
        started.set()
        gate.wait(timeout=30)
        return x

    router = side.proxy.QueryRouter(side.proxy.ReplicaSet(
        [(encode, lambda c: (c * 2, c + 1))],
        config=side.serving.ServingConfig(queue_depth=2, policy="shed")), clock=clk)
    scaler = side.autoscale.Autoscaler(
        router, side.autoscale.TierSpec(**SPEC), clock=clk,
        replica_factory=lambda slot: W.identity_replica(side, slot),
        warm_batches=W.batches(side, 1))
    b = W.batches(side, 4)
    try:
        tickets = [router.submit(b[0])]
        assert started.wait(timeout=5)
        tickets += [router.submit(x) for x in b[1:3]]
        out = [W.error_of(router.submit, b[3])[0], scaler.tick()]  # saturated: scale up
        gate.set()
        results = [t.result(timeout=10) for t in tickets]
        clk.advance(1.0)
        out.append(scaler.tick())  # idle again: scale down
    finally:
        gate.set()
        router.close()
    return [(W.host(v).tolist(), W.host(i).tolist()) for v, i in results], out, \
        _decisions(scaler), router.active_replicas()


def test_stats_derived_pressure_equals_reference():
    results, out, decisions, active = _run_both(_real_pressure)
    W.check_identity([(np.array(v), np.array(i)) for v, i in results], 3)
    assert out == ["RequestShed", "scale-up", "scale-down"]
    # the queue full: 3 outstanding over a depth of 2, capped at 1.0; then
    # idle, and no shed among the 3 completions since the last sample
    assert [(d, p, n) for _, d, p, n in decisions] == [("scale-up", 1.0, 2),
                                                       ("scale-down", 0.0, 1)]
    assert active == [0]


# ---------------------------------------------------------------------------
# scale-down drains; scale-up is warmed and probed before traffic
# ---------------------------------------------------------------------------


def test_scale_down_drains_in_flight_work_losslessly():
    clk = PC.FakeClock()
    gate, first_in = threading.Event(), threading.Event()

    def slow_pair():
        def search(c):
            first_in.set()
            gate.wait(timeout=30)
            return c * 2, c + 1

        return (lambda x: x), search

    router = PP.QueryRouter(
        PP.ReplicaSet([slow_pair(), slow_pair()],
                      config=PS.ServingConfig(queue_depth=8, policy="block")), clock=clk)
    spec = PA.TierSpec(**dict(SPEC, high_water=0.9))
    scaler = _scaler(PORT, router, spec, clk, [0.0])
    try:
        batches = W.batches(PORT, 8)
        tickets = [router.submit(b) for b in batches]
        assert first_in.wait(timeout=10)
        done = []
        th = threading.Thread(target=lambda: done.append(scaler.tick()))
        th.start()
        assert router.wait_state(1, ("draining",), timeout=10)  # the drain has begun
        gate.set()
        th.join(timeout=30)
        assert not th.is_alive() and done == ["scale-down"]
        assert router.states()[1] == "retired"
        results = [t.result(timeout=30) for t in tickets]
        for b, (vals, ids) in zip(batches, results):
            assert torch.equal(vals, b * 2) and torch.equal(ids, b + 1)
        vals, ids = router.submit(batches[0]).result(timeout=10)
        assert torch.equal(ids, batches[0] + 1)
    finally:
        gate.set()
        router.close()


def _admission(side):
    clk = side.clock.FakeClock()
    calls = []
    router = _tier(side, clk, n=1)
    warm = [side.array(np.full((4,), 100, dtype=np.int64))]
    canary = side.array(np.full((4,), 200, dtype=np.int64))

    def factory(slot):
        def search(c):
            calls.append(int(W.host(c).ravel()[0]))
            return c * 2, c + 1

        return (lambda x: x), search

    scaler = side.autoscale.Autoscaler(router, side.autoscale.TierSpec(**SPEC), clock=clk,
                                       replica_factory=factory, warm_batches=warm,
                                       canary=canary, pressure_fn=lambda: 0.9)
    try:
        decision = scaler.tick()
        admission = list(calls)
        for b in W.batches(side, 4):  # round-robin over both: the new slot serves
            router.submit(b).result(timeout=10)
        states = router.states()
    finally:
        router.close()
    return decision, admission, calls[len(admission):], states


def test_scale_up_replica_is_warmed_and_probed_before_traffic():
    decision, admission, traffic, states = _run_both(_admission)
    assert decision == "scale-up"
    # the warm batch on both drivers, then the canary, and no traffic before either
    assert admission == [100, 100, 200]
    assert traffic == [1, 3] and states == {0: "healthy", 1: "healthy"}


def _failed_canary(side):
    clk = side.clock.FakeClock()
    served = []
    router = _tier(side, clk, n=1)

    def broken_factory(slot):
        def search(c):
            served.append(int(W.host(c).ravel()[0]))
            raise RuntimeError("bad build")

        return (lambda x: x), search

    scaler = side.autoscale.Autoscaler(router, side.autoscale.TierSpec(**SPEC), clock=clk,
                                       replica_factory=broken_factory, warm_batches=None,
                                       canary=W.batches(side, 1)[0], pressure_fn=lambda: 0.9)
    try:
        decision = scaler.tick()
        seen = [scaler.probe_failures, router.states(), router.active_replicas(), list(served)]
        for b in W.batches(side, 4):
            router.submit(b).result(timeout=10)
        seen.append(list(served))
    finally:
        router.close()
    return decision, seen


def test_failed_canary_retires_the_slot_before_it_ever_serves():
    decision, seen = _run_both(_failed_canary)
    assert decision == "scale-up-failed"
    assert seen == [1, {0: "healthy", 1: "retired"}, [0], [0], [0]]


# ---------------------------------------------------------------------------
# replicas from the spec's own builder over a snapshot
# ---------------------------------------------------------------------------


def _spec_built(side, cd, cq):
    clk = side.clock.FakeClock()
    snap = side.lifecycle.CorpusSnapshot(codes=cd, n_levels=W.LEVELS, embedding_version="v1")
    spec = side.autoscale.TierSpec(**dict(SPEC, index="ivf", build_params=dict(
        W.BUILDER_PARAMS["ivf"], backend="auto" if side is PORT else "xla")))
    encode = lambda q: q  # noqa: E731
    batches = W.code_batches(side, cq)
    first = spec.make_index_builder(**({"device": "cpu"} if side is PORT else {}))
    router = side.proxy.QueryRouter(side.proxy.ReplicaSet(
        [(encode, first.build(snap))], share_device=True), clock=clk)
    kw = {"device": "cpu"} if side is PORT else {}
    scaler = side.autoscale.Autoscaler(router, spec, snapshot=snap, encode_fn=encode,
                                       warm_batches=batches[:1], clock=clk,
                                       pressure_fn=lambda: 0.9, **kw)
    try:
        decision = scaler.tick()
        results = [router.submit(b).result(timeout=60) for b in batches * 2]
        versions = {i: getattr(v, "tag", v) for i, v in router.versions().items()}
    finally:
        router.close()
    return results, decision, versions, W.det_stats(router.stats())


def test_spec_built_replicas_equal_reference(monkeypatch):
    W.hand_over_reference_inputs(monkeypatch, W.BUILDER_PARAMS["ivf"]["seed"])
    cd, cq = W.code_corpus()
    got = _spec_built(PORT, cd, cq)
    want = _spec_built(REF, cd, cq)
    assert W.same_results(want[0], got[0]) and got[1:] == want[1:]
    assert got[1] == "scale-up" and got[2][0] is None and got[2][1].startswith("ivf:v1:")
    assert got[3]["per_replica"][1][1] == 1 + 3  # its canary, then its share of the stream


# ---------------------------------------------------------------------------
# background loop + clock integration
# ---------------------------------------------------------------------------


def _background(side):
    clk = side.clock.FakeClock()
    router = _tier(side, clk, n=1)
    spec = side.autoscale.TierSpec(**dict(SPEC, window_s=2.0, tick_s=0.5))
    scaler = _scaler(side, router, spec, clk, [0.9])
    try:
        scaler.start()
        scaler.start()  # idempotent while alive
        for _ in range(4):
            clk.tick(0.5)
        scaler.stop()
    finally:
        router.close()
    return _decisions(scaler), scaler.summary(), router.active_replicas()


def test_background_loop_ticks_on_the_clock_and_stops_cleanly():
    decisions, summary, active = _run_both(_background)
    assert len(decisions) == 4 and summary["scale_ups"] == 1 and active == [0, 1]


def test_router_close_interrupts_a_parked_retry_backoff():
    clk = PC.FakeClock()
    gate, started = threading.Event(), threading.Event()

    def encode(x):
        started.set()
        gate.wait(timeout=30)
        return x

    router = PP.QueryRouter(
        PP.ReplicaSet([(encode, lambda c: (c * 2, c + 1))],
                      config=PS.ServingConfig(queue_depth=1, policy="shed")), clock=clk)
    try:
        b = W.batches(PORT, 3)
        router.submit(b[0])
        assert started.wait(timeout=5)
        router.submit(b[1])  # fills the queue
        errs = []

        def work():
            try:
                router.submit_with_retry(b[2], attempts=10, base_delay_s=3600.0)
            except (PS.PipelineClosed, PS.RequestShed) as e:
                errs.append(e)

        th = threading.Thread(target=work)
        th.start()
        assert clk.wait_for_sleepers(1)  # parked on a one-hour backoff
        gate.set()
        before = clk.now()
        router.close()
        th.join(timeout=10)
        assert not th.is_alive() and clk.now() == before
        assert len(errs) == 1 and isinstance(errs[0], PS.PipelineClosed)
    finally:
        gate.set()
        router.close()


def test_autoscaler_requires_a_canary_and_a_replica_source():
    for side in (PORT, REF):
        clk = side.clock.FakeClock()
        router = _tier(side, clk, n=1)
        spec = side.autoscale.TierSpec(min_replicas=1, max_replicas=2)
        try:
            side_errs = [
                W.error_of(side.autoscale.Autoscaler, router, spec, clock=clk,
                           replica_factory=lambda s: W.identity_replica(side, s)),
                W.error_of(side.autoscale.Autoscaler, router, spec, clock=clk,
                           canary=W.batches(side, 1)[0])]
        finally:
            router.close()
        assert "canary" in side_errs[0][1] and "replica_factory" in side_errs[1][1]
        if side is PORT:
            port_errs = side_errs
    assert port_errs == side_errs
