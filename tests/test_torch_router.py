"""The replicated serving tier of the port (``repro_torch/launch/proxy.py``)
against the reference (``repro/launch/proxy.py``).

Parity cases run one scenario on both packages — the reference's router
over the reference's closures (JAX on the CPU, ``backend="xla"``), the
port's router over the port's CPU closures, on the same numpy codes and
the same ``FaultPlan`` — and compare every result bit for bit, the
replica each ticket was routed to and the deterministic stats (requests,
sheds, failovers, revivals, states, ...). The port's inverse norms and
k-means picks are the reference's (``_torch_tier.hand_over_reference_inputs``).
The concurrency cases of the reference's suite (shedding across
replicas, failover mid-stream, watchdogs, deadlines, retry, flap
suppression, degradation) run on the port's tier with the reference's
assertions, timed by a ``FakeClock`` where the tier takes one. The
``gpu`` cases serve CUDA closures through the router on the card.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tier as W  # noqa: E402
from repro_torch.launch import clock as PC  # noqa: E402
from repro_torch.launch import faults as PF  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402
from repro_torch.launch import serving as PS  # noqa: E402
from repro_torch.launch.mesh import make_replica_meshes  # noqa: E402

PORT, REF = W.PORT, W.REF
KINDS = ["flat", "ivf", "hnsw"]


def _tier(side, replicas, *, route="round-robin", clock=None, **cfg):
    """A router over ``replicas`` under routing policy ``route``; ``cfg`` is
    the replicas' ``ServingConfig``."""
    kw = {} if clock is None else {"clock": clock}
    return side.proxy.QueryRouter(
        side.proxy.ReplicaSet(replicas, config=side.serving.ServingConfig(**cfg)),
        policy=route, **kw)


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------


def _round_robin(side):
    calls = []
    replicas = [W.identity_replica(side, t, calls) for t in range(3)]
    results, stats = side.proxy.serve_replicated(replicas, W.batches(side, 9),
                                                 policy="round-robin")
    served = {t: sorted(b for (r, b) in calls if r == t) for t in range(3)}
    return results, served, W.det_stats(stats)


def test_round_robin_spreads_batches_evenly_as_the_reference():
    results, served, stats = _round_robin(PORT)
    want = _round_robin(REF)
    assert W.same_results(want[0], results) and (served, stats) == want[1:]
    W.check_identity(results, 9)
    assert served == {0: [0, 3, 6], 1: [1, 4, 7], 2: [2, 5, 8]}
    assert stats["requests"] == 9 and stats["queries"] == 36
    assert stats["router"] == "round-robin"


def test_least_outstanding_avoids_the_busy_replica():
    gate, started, calls = threading.Event(), threading.Event(), []

    def slow_encode(x):
        started.set()
        gate.wait(timeout=10)
        return x

    _, slow_search = W.identity_replica(PORT, 0, calls)
    router = _tier(PORT, [(slow_encode, slow_search), W.identity_replica(PORT, 1, calls)],
                   route="least-outstanding", queue_depth=8)
    try:
        t0 = router.submit(W.batches(PORT)[0])  # ties break to replica 0
        assert started.wait(timeout=5)
        for b in W.batches(PORT, 5)[1:]:
            router.submit(b).result(timeout=10)
        assert all(r == 1 for (r, _) in calls)
        gate.set()
        t0.result(timeout=10)
        assert t0.replica == 0
    finally:
        gate.set()
        router.close()


def test_policies_and_their_errors_equal_reference():
    assert sorted(PP.ROUTING_POLICIES) == sorted(W.RP.ROUTING_POLICIES)
    assert PP.REPLICA_STATES == W.RP.REPLICA_STATES
    got, want = (W.error_of(_tier, side, [W.identity_replica(side, 0)], route="random")
                 for side in (PORT, REF))
    assert got == want and "unknown routing policy" in got[1]
    rr, lo = PP.RoundRobin(), PP.LeastOutstanding()
    rrr, rlo = W.RP.RoundRobin(), W.RP.LeastOutstanding()
    for healthy, out in (([0, 1, 2], {0: 2, 1: 0, 2: 1}), ([1, 2], {1: 1, 2: 1}),
                         ([0, 2, 3], {})):
        assert rr.order(healthy, out) == rrr.order(healthy, out)
        assert lo.order(healthy, out) == rlo.order(healthy, out)


# ---------------------------------------------------------------------------
# cross-replica shedding
# ---------------------------------------------------------------------------


def _saturate(side):
    gates = [threading.Event(), threading.Event()]
    started = [threading.Event(), threading.Event()]

    def gated(i):
        def encode(x):
            started[i].set()
            gates[i].wait(timeout=10)
            return x

        return encode, (lambda c: (c * 2, c + 1))

    router = _tier(side, [gated(0), gated(1)], queue_depth=1, policy="shed")
    b = W.batches(side, 5)
    try:
        tickets = [router.submit(x) for x in b[:2]]
        assert started[0].wait(timeout=5) and started[1].wait(timeout=5)
        tickets += [router.submit(x) for x in b[2:4]]  # bounce, then land: no proxy shed
        before = router.shed_count
        err = W.error_of(router.submit, b[4])
        stats = router.stats()
        for g in gates:
            g.set()
        results = [t.result(timeout=10) for t in tickets]
    finally:
        for g in gates:
            g.set()
        router.close()
    return results, before, err, router.shed_count, stats["shed"], stats["replica_shed"] >= 2


def test_proxy_sheds_only_when_every_replica_is_saturated():
    got = _saturate(PORT)
    want = _saturate(REF)
    assert W.same_results(want[0], got[0]) and got[1:] == want[1:]
    assert got[1:] == (0, ("RequestShed", "all healthy replicas saturated"), 1, 1, True)


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


def test_replica_death_mid_stream_redispatches_without_loss_or_reorder():
    calls = []

    def slow_search(c):
        time.sleep(0.005)
        calls.append((1, int(W.host(c).ravel()[0])))
        return c * 2, c + 1

    dying = PF.FaultInjector(lambda x: x, slow_search, PF.FaultPlan.fail_after(1),
                             name="r1").pair
    router = _tier(PORT, [W.identity_replica(PORT, 0, calls), dying], queue_depth=16)
    try:
        tickets = [router.submit(b) for b in W.batches(PORT, 12)]
        W.check_identity([t.result(timeout=30) for t in tickets], 12)
        stats = router.stats()
        assert stats["healthy"] == [0] and stats["failovers"] >= 1
        assert stats["requests"] == 12
        assert sum(1 for (r, _) in calls if r == 1) == 1
    finally:
        router.close()


def test_eager_failover_redispatches_before_client_awaits():
    router = _tier(PORT, [W.identity_replica(PORT, 0), W.identity_replica(PORT, 1,
                                                                         fail_after=0)],
                   queue_depth=8)
    try:
        tickets = [router.submit(b) for b in W.batches(PORT, 6)]
        deadline = time.time() + 15
        while time.time() < deadline and not all(t.done() for t in tickets):
            time.sleep(0.005)
        assert all(t.done() for t in tickets)
        W.check_identity([t.result() for t in tickets], 6)
        assert router.healthy() == [0]
    finally:
        router.close()


def _all_down(side):
    router = _tier(side, [W.identity_replica(side, i, fail_after=0) for i in range(2)],
                   queue_depth=8)
    try:
        t = router.submit(W.batches(side, 1)[0])
        err = W.error_of(t.result, timeout=15)
        healthy = router.healthy()
        down = W.error_of(router.submit, W.batches(side, 2)[1])
        retry = W.error_of(router.submit_with_retry, W.batches(side, 2)[1], attempts=8,
                           base_delay_s=0.2)
    finally:
        router.close()
    return err, healthy, down, retry, W.det_stats(router.stats())


def test_all_replicas_down_surfaces_error_and_rejects_submits_as_the_reference():
    got = _all_down(PORT)
    assert got == _all_down(REF)
    assert got[0] == ("InjectedFault", "injected fail (r1.search call 0)")  # the last hop
    assert got[1] == [] and got[2][0] == got[3][0] == "AllReplicasDown"


# ---------------------------------------------------------------------------
# a deterministic tier over the index closures, held against the reference
# ---------------------------------------------------------------------------


def _failover_and_revival(side, kind, policy, cd, cq, packed):
    """Submit-and-await over two replicas of one index closure. The replica
    the policy sends traffic to second (replica 1 under round-robin, 0
    under least-outstanding, whose ties go to the lower index) fails its
    second scan (``FaultPlan.fail_at(1)``); that ticket fails over, the
    canary probe (checked against the sequential answer) revives the
    replica, and the stream goes on. Every step is ordered, so the routing
    and the stats are fixed."""
    search = W.index_closure(side, kind, cd, packed=packed)
    encode = lambda q: q  # noqa: E731  codes in, codes out: isolates the tier
    batches = W.code_batches(side, cq, width=4)
    seq = side.serving.serve_sequential(encode, search, batches)
    bad = 1 if policy == "round-robin" else 0
    inj = side.faults.FaultInjector(encode, search, side.faults.FaultPlan.fail_at(1),
                                    name=f"r{bad}")
    pairs = [(encode, search), (encode, search)]
    pairs[bad] = inj.pair
    router = _tier(side, pairs, route=policy, queue_depth=4)
    results, routed = [], []
    try:
        for i, b in enumerate(batches + batches):
            if i == len(batches):
                revived = router.probe(bad, batches[0], expect=seq[0])
                states = router.states()
            t = router.submit(b)
            results.append(t.result(timeout=60))
            routed.append((t.replica, t.redispatches))
    finally:
        router.close()
    return dict(results=results, seq=seq, routed=routed, revived=revived, states=states,
                log=inj.log, stats=W.det_stats(router.stats()))


@pytest.mark.parametrize("policy", ["round-robin", "least-outstanding"])
@pytest.mark.parametrize("kind", KINDS)
def test_failover_and_revival_equal_reference(monkeypatch, kind, policy):
    W.hand_over_reference_inputs(monkeypatch, W.BUILDER_PARAMS[kind].get("seed", 0))
    cd, cq = W.code_corpus()
    packed = kind == "flat"
    want = _failover_and_revival(REF, kind, policy, cd, cq, packed)
    got = _failover_and_revival(PORT, kind, policy, cd, cq, packed)
    assert W.same_results(want["results"], got["results"])
    assert W.same_results(want["seq"], got["seq"])
    for key in ("routed", "revived", "states", "log", "stats"):
        assert got[key] == want[key], key
    # every routed result is the sequential loop's, in order
    assert W.same_results(got["seq"] * 2, got["results"])
    assert got["revived"] is True and got["stats"]["revivals"] == 1
    assert got["stats"]["failovers"] == 1 and got["log"] == [("search", 1, "fail")]
    assert got["states"] == {0: "healthy", 1: "healthy"}
    if policy == "round-robin":
        assert got["routed"][:4] == [(0, 0), (1, 0), (0, 0), (0, 1)]
    else:
        assert got["routed"][:3] == [(0, 0), (1, 1), (1, 0)]


@pytest.mark.parametrize("kind", KINDS)
def test_router_bit_identical_to_sequential_and_reference(monkeypatch, kind):
    W.hand_over_reference_inputs(monkeypatch, W.BUILDER_PARAMS[kind].get("seed", 0))
    cd, cq = W.code_corpus()
    runs = {}
    for side in (REF, PORT):
        search = W.index_closure(side, kind, cd)
        encode = lambda q: q  # noqa: E731
        batches = W.code_batches(side, cq)
        seq = side.serving.serve_sequential(encode, search, batches)
        routed, stats = side.proxy.serve_replicated([(encode, search)] * 2, batches,
                                                    policy="round-robin", share_device=True)
        runs[side.name] = (seq, routed, W.det_stats(stats))
    seq, routed, stats = runs["port"]
    assert W.same_results(seq, routed)
    assert W.same_results(runs["ref"][1], routed) and stats == runs["ref"][2]
    assert stats["requests"] == 3 and stats["replicas"] == 2
    assert all(isinstance(v, torch.Tensor) for v, _ in routed)


def test_stats_aggregate_per_replica_rows():
    results, stats = PP.serve_replicated([W.identity_replica(PORT, i) for i in range(2)],
                                         W.batches(PORT, 8))
    W.check_identity(results, 8)
    assert len(stats["per_replica"]) == 2
    assert sum(s["requests"] for s in stats["per_replica"]) == 8
    for s in stats["per_replica"]:
        for key in ("replica", "healthy", "requests", "queries", "shed", "device_idle_frac",
                    "generation", "state", "version", "embedding_version", "degraded"):
            assert key in s
    assert stats["latency_p99_ms"] >= stats["latency_p50_ms"]
    want = PP.serve_replicated([W.identity_replica(REF, i) for i in range(2)],
                               W.batches(REF, 8))[1]
    assert sorted(stats) == sorted(want)
    assert sorted(stats["per_replica"][0]) == sorted(want["per_replica"][0])


def test_probe_compares_results_on_the_host_bit_for_bit():
    eq = PP._host_equal
    a = torch.tensor([1.0, 2.0])
    assert eq(a, np.array([1.0, 2.0])) and eq(a, torch.tensor([1, 2]))
    assert not eq(a, torch.nextafter(a, a + 1)) and not eq(a, torch.tensor([1.0]))
    assert not eq(torch.tensor([float("nan")]), torch.tensor([float("nan")]))


# ---------------------------------------------------------------------------
# robustness: deadlines, stuck-scan watchdog, retry, degradation
# ---------------------------------------------------------------------------


def test_ticket_result_timeout_then_late_resolution_no_leaks():
    t = PS.Ticket(0, 4)
    with pytest.raises(TimeoutError, match="not ready"):
        t.result(timeout=0.02)
    assert not t.done()
    fired = []
    t.add_done_callback(lambda tk: fired.append("a"))
    t.add_done_callback(lambda tk: fired.append("b"))
    assert t._resolve(value=("v", "i")) is True
    assert t.result(timeout=1) == ("v", "i")
    assert t._resolve(error=RuntimeError("late loser")) is False
    assert t.result() == ("v", "i") and t.error() is None
    assert fired == ["a", "b"] and t._callbacks == []
    t.add_done_callback(lambda tk: fired.append("c"))
    assert fired == ["a", "b", "c"] and t._callbacks == []


def test_watchdog_fails_over_stuck_scan_without_loss_or_reorder():
    calls = []
    stuck = PF.FaultInjector(*W.identity_replica(PORT, 0, calls), plan=PF.FaultPlan.stick_at(0),
                             name="r0")
    router = _tier(PORT, [stuck.pair, W.identity_replica(PORT, 1, calls)], queue_depth=16)
    try:
        router.start_watchdogs(0.05)
        tickets = [router.submit(b) for b in W.batches(PORT, 8)]
        W.check_identity([t.result(timeout=30) for t in tickets], 8)
        assert router.wait_state(0, ("unhealthy",), timeout=10)
        stats = router.stats()
        assert stats["watchdog_stalls"] >= 1 and stats["failovers"] >= 1
        assert isinstance(router._errors[0], PS.ScanStalled)
        assert all(r == 1 for (r, _) in calls)
    finally:
        stuck.release()  # un-wedge the scan thread before close() joins
        router.close()


def test_deadline_expired_sheds_at_dequeue_replica_stays_healthy():
    gate, started, calls = threading.Event(), threading.Event(), []

    def search(c):
        started.set()
        gate.wait(timeout=10)
        calls.append(int(W.host(c).ravel()[0]))
        return c * 2, c + 1

    router = _tier(PORT, [((lambda x: x), search)], queue_depth=8)
    try:
        deadline = time.perf_counter() + 0.03
        tickets = [router.submit(b, deadline=deadline) for b in W.batches(PORT, 4)]
        assert started.wait(timeout=5)
        time.sleep(max(0.0, deadline - time.perf_counter()) + 0.01)
        gate.set()
        outcomes = []
        for t in tickets:
            try:
                t.result(timeout=30)
                outcomes.append("ok")
            except PS.DeadlineExpired:
                outcomes.append("expired")
        assert outcomes[0] == "ok" and outcomes.count("expired") == 3
        assert calls == [0]  # expired work never reached the scan
        stats = router.stats()
        assert stats["deadline_expired"] == 3
        assert stats["shed"] == 0 and stats["failovers"] == 0
        assert router.healthy() == [0]
    finally:
        gate.set()
        router.close()


def _expired_at_submit(side):
    router = _tier(side, [W.identity_replica(side, 0)])
    try:
        err = W.error_of(router.submit, W.batches(side, 1)[0],
                         deadline=time.perf_counter() - 1.0)
    finally:
        router.close()
    return err, W.det_stats(router.stats())


def test_submit_rejects_already_expired_deadline_as_the_reference():
    got = _expired_at_submit(PORT)
    assert got == _expired_at_submit(REF)
    assert got[0] == ("DeadlineExpired", "deadline already expired at submit")
    assert got[1]["deadline_expired"] == 1 and got[1]["requests"] == 0


def _gated_tier(clock):
    gate, started = threading.Event(), threading.Event()

    def encode(x):
        started.set()
        gate.wait(timeout=30)
        return x

    router = _tier(PORT, [(encode, lambda c: (c * 2, c + 1))], clock=clock, queue_depth=1,
                   policy="shed")
    head, rest = W.batches(PORT, 2)
    tickets = [router.submit(head)]
    assert started.wait(timeout=5)
    tickets.append(router.submit(rest))
    return router, gate, tickets


def test_submit_with_retry_succeeds_once_pressure_clears():
    clk = PC.FakeClock()
    router, gate, tickets = _gated_tier(clk)
    try:
        result = {}

        def work():
            t = router.submit_with_retry(W.batches(PORT, 3)[2], attempts=20, base_delay_s=0.5,
                                         max_delay_s=2.0)
            result["vals"] = t.result(timeout=10)[0]

        w = threading.Thread(target=work)
        w.start()
        clk.wait_for_sleepers(1)
        assert router.shed_count >= 1
        gate.set()
        deadline = time.time() + 10
        while w.is_alive() and time.time() < deadline:
            clk.advance(2.0)
            time.sleep(0.005)
        w.join(timeout=10)
        assert not w.is_alive()
        assert np.array_equal(W.host(result["vals"]), np.full((4,), 4))
        for tk in tickets:
            tk.result(timeout=10)
    finally:
        gate.set()
        router.close()


def test_submit_with_retry_deadline_cuts_backoff_short():
    clk = PC.FakeClock()
    router, gate, _ = _gated_tier(clk)
    try:
        t0 = clk.now()
        with pytest.raises(PS.DeadlineExpired, match="retry backoff"):
            router.submit_with_retry(W.batches(PORT, 3)[2], deadline=clk.now() + 0.05,
                                     attempts=50, base_delay_s=0.2, jitter=0.0)
        assert clk.now() == t0  # failed by deadline math: no simulated time served
        assert router.stats()["deadline_expired"] >= 1
    finally:
        gate.set()
        router.close()


def _transiently_empty(side):
    router = _tier(side, [W.identity_replica(side, 0)], queue_depth=4)
    try:
        deadline = time.perf_counter() + 30.0
        router.drain(0, timeout=5)
        shed = W.error_of(router.submit, W.batches(side, 1)[0], deadline=deadline)
        router.mark_unhealthy(0, RuntimeError("boom"))
        down = W.error_of(router.submit, W.batches(side, 1)[0], deadline=deadline)
    finally:
        router.close()
    return shed, down, W.det_stats(router.stats())


def test_transiently_empty_tier_sheds_retryable_as_the_reference():
    got = _transiently_empty(PORT)
    assert got == _transiently_empty(REF)
    assert got[0] == ("RequestShed", "no routable replica (index swap or probe in progress)")
    assert got[1][0] == "AllReplicasDown"


def test_stop_health_probe_raises_when_probe_thread_is_wedged():
    clk = PC.FakeClock()
    stuck = PF.FaultInjector(*W.identity_replica(PORT, 0), plan=PF.FaultPlan.stick_at(0),
                             name="r0")
    router = _tier(PORT, [stuck.pair], clock=clk, queue_depth=4)
    try:
        router.mark_unhealthy(0, RuntimeError("down"))
        router.start_health_probe(W.batches(PORT, 1)[0], interval=1.0, timeout=30.0)
        clk.wait_for_sleepers(1)
        clk.advance(1.0)
        deadline = time.time() + 10
        while time.time() < deadline and stuck.stuck_count == 0:
            time.sleep(0.005)
        assert stuck.stuck_count == 1
        with pytest.raises(RuntimeError, match="did not exit"):
            router.stop_health_probe(timeout=0.05)
        stuck.release()
        assert router.wait_state(0, ("healthy",), timeout=10)
    finally:
        stuck.release()
        router.close()


def _flapper(side):
    clk = side.clock.FakeClock()
    flaky = side.faults.FaultInjector(*W.identity_replica(side, 1),
                                      plan=side.faults.FaultPlan.fail_after(0), name="r1")
    router = _tier(side, [W.identity_replica(side, 0), flaky.pair], clock=clk, queue_depth=8)
    try:
        for b in W.batches(side, 4):
            router.submit(b).result(timeout=15)  # submit-and-await: replica 1 dies once
        assert router.wait_state(1, ("unhealthy",), timeout=10)
        router.start_health_probe(W.batches(side, 1)[0], interval=1.0, timeout=2.0)
        fails = []
        for _ in range(16):  # 16 simulated seconds, lockstep with the loop
            clk.tick(1.0)
            fails.append(router.probe_failures().get(1, 0))
        states = router.states()
    finally:
        router.close()
    return fails, states, flaky.log, W.det_stats(router.stats())


def test_flap_suppression_backs_off_as_the_reference():
    got = _flapper(PORT)
    assert got == _flapper(REF)
    fails = got[0]
    assert 2 <= fails[-1] <= 6 and got[1][1] == "unhealthy"
    # probes at t = 1, 2, 4, 8, 16: backed off, but still retried
    assert [fails[t - 1] - (fails[t - 2] if t > 1 else 0) for t in (1, 2, 4, 8, 16)] \
        == [1, 1, 1, 1, 1]


def _degradation(side):
    gate, started = threading.Event(), threading.Event()

    def encode(x):
        started.set()
        gate.wait(timeout=30)
        return x

    knob = side.proxy.EffortKnob(2)
    router = _tier(side, [(encode, lambda c: (c * 2, c + 1))], queue_depth=1, policy="shed")
    router.enable_degradation(knob, high_water=0.5, low_water=0.0)
    seen = []
    try:
        b = W.batches(side, 4)
        t0 = router.submit(b[0])
        assert started.wait(timeout=5)
        t1 = router.submit(b[1])  # pressure 1.0 >= 0.5: degrades first
        seen.append((knob.level, knob.degrade_count))
        seen.append(W.error_of(router.submit, b[2]))  # the knob at its floor: a real shed
        seen.append(router.stats()["effort_level"])
        gate.set()
        results = [t0.result(timeout=10), t1.result(timeout=10)]
        seen.append(router.stats()["degraded"])
        t3 = router.submit(b[0])  # pressure cleared: restores full effort
        seen.append((knob.level, knob.restore_count))
        results.append(t3.result(timeout=10))
        seen.append(router.stats()["effort_level"])
        seen.append(W.error_of(router.enable_degradation, knob, high_water=0.2, low_water=0.5))
    finally:
        gate.set()
        router.close()
    return results, seen


def test_degradation_steps_down_before_shedding_as_the_reference():
    results, seen = _degradation(PORT)
    want = _degradation(REF)
    assert W.same_results(want[0], results) and seen == want[1]
    W.check_identity(results[:2], 2)
    assert seen[0] == (1, 1) and seen[1][0] == "RequestShed" and seen[2] == 1
    assert seen[3] >= 1 and seen[4] == (0, 1) and seen[5] == 0


# ---------------------------------------------------------------------------
# engine replicas, one LeafMesh each
# ---------------------------------------------------------------------------


def test_engine_replicas_on_their_meshes_route_and_fail_over():
    """Two replicas of the distributed engine, each on its own (2, 1)
    LeafMesh (devices repeated on the CPU), each sharding the whole corpus:
    routed results equal the replicas' own, and killing replica 1 loses
    nothing (a replica holds the whole corpus)."""
    cd, cq = W.code_corpus(n=2048, q=32, dim=64)
    meshes = make_replica_meshes(2, (2, 1), devices=["cpu"] * 4)
    builder = W.PL.EngineBuilder(meshes, n_levels=W.LEVELS, k=10)
    snap = W.PL.CorpusSnapshot(cd, W.LEVELS)
    fns = [builder.build(snap, replica=r) for r in (0, 1)]
    encode = lambda q: q  # noqa: E731
    batches = W.code_batches(PORT, cq)
    want = PS.serve_sequential(encode, fns[0], batches)
    assert W.same_results(want, PS.serve_sequential(encode, fns[1], batches))
    results, stats = PP.serve_replicated([(encode, f) for f in fns], batches * 2)
    assert W.same_results(want * 2, results) and stats["healthy"] == [0, 1]
    dying = PF.FaultInjector(encode, fns[1], PF.FaultPlan.fail_after(1), name="r1").pair
    results, stats = PP.serve_replicated([(encode, fns[0]), dying], batches * 2)
    assert W.same_results(want * 2, results)
    assert stats["healthy"] == [0] and stats["requests"] == 2 * len(batches)


# ---------------------------------------------------------------------------
# the CLI's routed run
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--docs", "2000", "--queries", "32", "--dim", "32", "--code-dim", "16",
       "--batch", "8", "--rounds", "3", "--steps", "0"]


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_cli_routes_heals_and_swaps_on_the_cpu(capsys, tmp_path, index):
    from repro_torch.launch import serve

    serve.main(CLI + ["--ckpt-cache", str(tmp_path), "--index", index, "--replicas", "2", "--router", "least-outstanding",
                      "--chaos", "r0.fail@0", "--probe-every", "0.02", "--swap-after", "4",
                      "--deadline-ms", "60000", "--scan-budget-ms", "60000"])
    out = capsys.readouterr().out
    for tag in ("[serve] recall@10: float=", "[serve] sequential:",
                "[serve] routed (2 replica(s), least-outstanding):", "[serve]   replica 1:",
                f"[swap] rolling swap -> {index}:v1:", "[swap]   replica 1: drain",
                "(generation ", "[deadline] 60000 ms budget: 0 expired (0/12 batches unanswered)",
                "[watchdog] 60000 ms scan budget: 0 stall(s)",
                "[chaos] replica 0: 1 fault(s) fired (search#0:fail)"):
        assert tag in out, (tag, out)
    assert "[probe] canary re-probe every 0.02s:" in out


def test_cli_tier_spec_runs_the_autoscaler_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve

    spec = tmp_path / "spec.json"
    spec.write_text('{"min_replicas": 1, "max_replicas": 2, "index": "flat", '
                    '"build_params": {"k": 10}, "queue_depth": 2, "cooldown_s": 0.0, '
                    '"window_s": 0.02, "tick_s": 0.01, "swap_every_s": 1.0}')
    serve.main(CLI + ["--ckpt-cache", str(tmp_path), "--tier-spec", str(spec)])
    out = capsys.readouterr().out
    assert f"[tier-spec] {spec}: index=flat replicas=[1, 2] router=round-robin policy=shed" in out
    assert "[serve] routed (1 replica(s), round-robin):" in out
    assert "[swap] rolling swap -> flat:v1:" in out and "[autoscale] spec [1, 2]:" in out


@pytest.mark.parametrize("extra, message", [
    (["--swap-after", "2", "--upgrade-after", "3"],
     "--swap-after and --upgrade-after are mutually exclusive"),
    (["--chaos", "r1.explode@3"], "bad chaos clause 'r1.explode@3'"),
    (["--router", "random"], "invalid choice: 'random'"),
])
def test_cli_refuses_what_it_cannot_run(capsys, tmp_path, extra, message):
    from repro_torch.launch import serve

    if extra[0] == "--chaos":  # refused when the tier is built, after training
        with pytest.raises(ValueError, match=message):
            serve.main(CLI + ["--ckpt-cache", str(tmp_path)] + extra)
        return
    with pytest.raises(SystemExit) as e:
        serve.main(CLI + extra)
    assert e.value.code == 2 and message in capsys.readouterr().err


def test_cli_refuses_a_malformed_tier_spec(tmp_path, capsys):
    from repro_torch.launch import serve

    spec = tmp_path / "spec.json"
    spec.write_text('{"min_replicas": 2, "max_replicas": 1}')
    with pytest.raises(SystemExit) as e:
        serve.main(CLI + ["--tier-spec", str(spec)])
    assert e.value.code == 2
    assert "--tier-spec: max_replicas must be an int >= min_replicas (2), got 1" in \
        capsys.readouterr().err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["round-robin", "least-outstanding"])
@pytest.mark.parametrize("packed", [False, True])
def test_routed_tier_on_card_bit_identical_to_sequential(card, policy, packed):
    from repro_torch.index.flat import FlatSDC
    from repro_torch.kernels.sdc import sdc

    cd, cq = W.code_corpus(n=20_000, q=64, dim=128)
    index = FlatSDC.build(cd, W.LEVELS, packed=packed, device=card)
    search = lambda q: index.search(q, 10)  # noqa: E731
    encode = lambda q: q  # noqa: E731
    batches = [torch.from_numpy(cq[i:i + 16]).to(card) for i in range(0, 64, 16)]
    seq = PS.serve_sequential(encode, search, batches)
    for n in (1, 2, 4):
        PS.warmup_replicas([(encode, search)] * n, batches)
        sdc.sdc_topk.launches = 0
        routed, stats = PP.serve_replicated([(encode, search)] * n, batches * 2, policy=policy,
                                            share_device=n > 1)
        assert sdc.sdc_topk.launches == 2 * len(batches)
        assert all(v.device.type == "cuda" for v, _ in routed)
        assert W.same_results(seq * 2, routed) and stats["requests"] == 2 * len(batches)


@pytest.mark.gpu
def test_chaos_fails_a_replica_on_card_and_the_canary_revives_it(card):
    from repro_torch.index.flat import FlatSDC
    from repro_torch.kernels.sdc import sdc

    cd, cq = W.code_corpus(n=20_000, q=64, dim=128)
    index = FlatSDC.build(cd, W.LEVELS, device=card)
    search = lambda q: index.search(q, 10)  # noqa: E731
    encode = lambda q: q  # noqa: E731
    batches = [torch.from_numpy(cq[i:i + 16]).to(card) for i in range(0, 64, 16)]
    seq = PS.serve_sequential(encode, search, batches)
    replicas, injectors = PF.apply_chaos([(encode, search)] * 2, "r1.fail@1")
    router = PP.QueryRouter(PP.ReplicaSet(replicas, share_device=True))
    try:
        sdc.sdc_topk.launches = 0
        results = [router.submit(b).result(timeout=60) for b in batches]
        # the failed scan raised before its kernel: one launch per answered batch
        assert sdc.sdc_topk.launches == len(batches)
        assert router.states()[1] == "unhealthy" and router.failover_count == 1
        assert router.probe(1, batches[0], expect=seq[0])
        results += [router.submit(b).result(timeout=60) for b in batches]
    finally:
        router.close()
    assert W.same_results(seq * 2, results)
    assert router.stats()["revivals"] == 1 and injectors[1].log == [("search", 1, "fail")]
