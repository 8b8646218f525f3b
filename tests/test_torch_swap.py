"""The swap half of the port's live index lifecycle (``RollingSwapController``,
``run_stream_with_swap``) and the router's health state machine (drain,
rebuild, canary probe, revival, generations) against the reference's
(``repro/launch/lifecycle.py``, ``repro/launch/proxy.py``).

Parity cases run one scenario on both packages, over each package's
closures on the same numpy codes (the port's builds take the reference's
inverse norms and k-means picks), and compare the results bit for bit,
the ``SwapReport`` fields other than times, the ``IndexVersion`` tags, the
deterministic stats and the errors. The cases whose outcome depends on
thread timing (a swap under live traffic, stragglers, stuck scans) run on
the port with the reference suite's assertions and hold the port's
results against the reference's sequential answers. The ``gpu`` case
swaps a tier on the card.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tier as W  # noqa: E402
from repro_torch.launch import clock as PC  # noqa: E402
from repro_torch.launch import faults as PF  # noqa: E402
from repro_torch.launch import lifecycle as PL  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402
from repro_torch.launch import serving as PS  # noqa: E402

PORT, REF = W.PORT, W.REF
LEVELS = W.LEVELS
KINDS = ["flat", "ivf", "hnsw"]


def _router(side, pairs, clock=None, queue_depth=8):
    kw = {} if clock is None else {"clock": clock}
    return side.proxy.QueryRouter(side.proxy.ReplicaSet(
        pairs, config=side.serving.ServingConfig(queue_depth=queue_depth)), **kw)


def _identity():
    return (lambda x: x), (lambda c: (c * 2, c + 1))


def _report(report):
    """A ``SwapReport`` without its times."""
    return (report.version.tag, report.swapped,
            [{k: v for k, v in row.items() if not k.endswith("_s")} for row in report.replicas])


@pytest.fixture
def handed_over(monkeypatch):
    def hand_over(kind):
        W.hand_over_reference_inputs(monkeypatch, W.BUILDER_PARAMS[kind].get("seed", 0))
    return hand_over


def test_swap_constants_and_errors_equal_reference():
    assert PL.COMPAT_RECALL_FLOOR == W.RL.COMPAT_RECALL_FLOOR == 0.55
    assert issubclass(PL.SwapFailed, RuntimeError)
    assert [f for f in PL.SwapReport.__dataclass_fields__] == \
        [f for f in W.RL.SwapReport.__dataclass_fields__]
    for side in (PORT, REF):
        side_err = W.error_of(side.lifecycle.RollingSwapController,
                              _router(side, [_identity()]), None)
        assert side_err == ("ValueError", "need a canary batch (or warm_batches)")


# ---------------------------------------------------------------------------
# rolling swap: reports, versions, results
# ---------------------------------------------------------------------------


def _idle_swap(side, kind, cd, cq):
    """A rolling swap of two idle replicas, then the stream: every step
    ordered, so the report, the versions and the stats are fixed."""
    snap = side.lifecycle.CorpusSnapshot(codes=cd, n_levels=LEVELS, embedding_version="v7")
    builder = W.make_builder(side, kind)
    encode = lambda q: q  # noqa: E731
    batches = W.code_batches(side, cq)
    router = _router(side, [(encode, builder.build(snap)) for _ in range(2)])
    try:
        controller = side.lifecycle.RollingSwapController(
            router, W.make_builder(side, kind), warm_batches=batches[:1])
        report = controller.swap_all(snap)
        results = [router.submit(b).result(timeout=60) for b in batches]
        versions = {i: v.tag for i, v in router.versions().items()}
    finally:
        router.close()
    return results, _report(report), versions, W.det_stats(router.stats())


@pytest.mark.parametrize("kind", KINDS)
def test_swap_report_versions_and_results_equal_reference(handed_over, kind):
    handed_over(kind)
    cd, cq = W.code_corpus()
    got = _idle_swap(PORT, kind, cd, cq)
    want = _idle_swap(REF, kind, cd, cq)
    assert W.same_results(want[0], got[0]) and got[1:] == want[1:]
    tag, swapped, rows = got[1]
    assert tag.startswith(f"{kind}:v7:") and swapped == 2
    assert rows == [{"replica": 0, "version": tag, "generation": 1},
                    {"replica": 1, "version": tag, "generation": 1}]
    assert got[2] == {0: tag, 1: tag} and got[3]["states"] == {0: "healthy", 1: "healthy"}


@pytest.mark.parametrize("kind", KINDS)
def test_rolling_swap_under_live_traffic_bit_identical(handed_over, kind):
    """The reference suite's live swap on the port: zero lost, zero
    reordered, every result the sequential loop's — and the reference's."""
    handed_over(kind)
    cd, cq = W.code_corpus()
    want = REF.serving.serve_sequential(lambda q: q, W.index_closure(REF, kind, cd),
                                        W.code_batches(REF, cq))
    snap = PL.CorpusSnapshot(codes=cd, n_levels=LEVELS)
    encode = lambda q: q  # noqa: E731
    batches = W.code_batches(PORT, cq)
    ref = PS.serve_sequential(encode, W.make_builder(PORT, kind).build(snap), batches)
    assert W.same_results(want, ref)
    router = _router(PORT, [(encode, W.make_builder(PORT, kind).build(snap)) for _ in range(2)])
    swap_started = [threading.Event() for _ in range(2)]

    def on_event(msg):
        for i, ev in enumerate(swap_started):
            if msg.startswith(f"replica {i}: draining"):
                ev.set()

    controller = PL.RollingSwapController(router, W.make_builder(PORT, kind),
                                          warm_batches=batches[:1], drain_timeout=15.0,
                                          probe_timeout=60.0, on_event=on_event)
    stream = batches * 8
    tickets = []

    def feeder():
        for j, b in enumerate(stream):
            if j == len(stream) // 3:
                assert swap_started[0].wait(timeout=30)
            elif j == (2 * len(stream)) // 3:
                assert swap_started[1].wait(timeout=30)
            while True:
                try:
                    tickets.append(router.submit(b))
                    break
                except PS.RequestShed:
                    time.sleep(1e-3)

    try:
        th = threading.Thread(target=feeder)
        th.start()
        report = controller.swap_all(snap)
        th.join(timeout=60)
        assert not th.is_alive()
        results = [t.result(timeout=60) for t in tickets]
        assert W.same_results(ref * 8, results)  # zero lost, zero reordered, identical
        assert report.swapped == 2
        stats = router.stats()
        assert stats["states"] == {0: "healthy", 1: "healthy"}
        assert [p["generation"] for p in stats["per_replica"]] == [1, 1]
        assert [p["version"] for p in stats["per_replica"]] == [report.version.tag] * 2
    finally:
        router.close()


def _stream_with_swap(side, cd, cq):
    """``run_stream_with_swap`` over two replicas, swapping after 3 of 12
    submissions: the results do not depend on which replica served them."""
    snap = side.lifecycle.CorpusSnapshot(codes=cd, n_levels=LEVELS, embedding_version="v1")
    encode = lambda q: q  # noqa: E731
    batches = W.code_batches(side, cq)
    router = _router(side, [(encode, W.make_builder(side, "flat").build(snap))] * 2,
                     queue_depth=2)
    controller = side.lifecycle.RollingSwapController(
        router, W.make_builder(side, "flat", packed=True), warm_batches=batches[:1],
        encode_fn=encode)
    try:
        results, report = side.lifecycle.run_stream_with_swap(
            router, batches * 4, controller=controller, snapshot=snap, swap_after=3)
    finally:
        router.close()
    stats = W.det_stats(router.stats())
    return (results, _report(report),
            {k: stats[k] for k in ("requests", "states", "shed", "revivals", "failovers")})


def test_run_stream_with_swap_equals_reference(handed_over):
    handed_over("flat")
    cd, cq = W.code_corpus()
    got = _stream_with_swap(PORT, cd, cq)
    want = _stream_with_swap(REF, cd, cq)
    assert W.same_results(want[0], got[0]) and got[1:] == want[1:]
    assert got[1][1] == 2 and got[2]["requests"] == 12  # canaries go to the pipelines


def test_single_replica_swap_sheds_then_recovers(handed_over):
    handed_over("flat")
    cd, cq = W.code_corpus(n=256)
    snap = PL.CorpusSnapshot(codes=cd, n_levels=LEVELS)
    encode = lambda q: q  # noqa: E731
    batches = W.code_batches(PORT, cq)
    ref = PS.serve_sequential(encode, W.make_builder(PORT, "flat").build(snap), batches)
    router = _router(PORT, [(encode, W.make_builder(PORT, "flat").build(snap))], queue_depth=4)
    controller = PL.RollingSwapController(router, W.make_builder(PORT, "flat"),
                                          warm_batches=batches[:1])
    try:
        done = threading.Event()
        errors = []

        def feeder():
            while not done.is_set():
                try:
                    router.submit(batches[0]).result(timeout=30)
                except PS.RequestShed:
                    time.sleep(1e-3)
                except Exception as e:  # noqa: BLE001 - any other error fails the test
                    errors.append(e)
                    return

        th = threading.Thread(target=feeder)
        th.start()
        report = controller.swap_all(snap)
        done.set()
        th.join(timeout=30)
        assert not th.is_alive() and errors == []  # shed, never AllReplicasDown
        assert report.swapped == 1
        assert W.same_results([ref[1]], [router.submit(batches[1]).result(timeout=30)])
    finally:
        router.close()


def _reclaim_dead(side, cd, cq):
    snap = side.lifecycle.CorpusSnapshot(codes=cd, n_levels=LEVELS)
    encode = lambda q: q  # noqa: E731
    built = W.make_builder(side, "flat").build(snap)
    fail = [0]

    def flaky(c):
        if fail[0] > 0:
            fail[0] -= 1
            raise RuntimeError("transient")
        return built(c)

    router = _router(side, [(encode, built), (encode, flaky)])
    batches = W.code_batches(side, cq)
    try:
        fail[0] = 1
        for b in batches:  # round-robin, submit-and-await: the fault lands on replica 1
            router.submit(b).result(timeout=30)
        before = router.states()
        controller = side.lifecycle.RollingSwapController(
            router, W.make_builder(side, "flat"), warm_batches=batches[:1])
        report = controller.swap_all(snap)
        after = router.states()
        result = router.submit(batches[0]).result(timeout=30)
    finally:
        router.close()
    return result, before, _report(report), after, router.revival_count, \
        W.det_stats(router.stats())


def test_swap_all_reclaims_an_unhealthy_replica_in_place(handed_over):
    handed_over("flat")
    cd, cq = W.code_corpus(n=256)
    got = _reclaim_dead(PORT, cd, cq)
    want = _reclaim_dead(REF, cd, cq)
    assert W.same_results([want[0]], [got[0]]) and got[1:] == want[1:]
    assert got[1][1] == "unhealthy" and got[2][1] == 2
    assert got[3] == {0: "healthy", 1: "healthy"} and got[4] == 1


class _RaisingBuilder:
    kind = "flat"
    params: dict = {}

    def build(self, snapshot, *, replica=0):
        raise RuntimeError("build exploded")


class _BrokenBuilder:
    kind = "flat"
    params: dict = {}

    def build(self, snapshot, *, replica=0):
        def bad(codes):
            raise RuntimeError("bad rebuilt index")

        return bad


def _build_error_downs_tier(side):
    snap = side.lifecycle.CorpusSnapshot(codes=np.zeros((8, 4), np.int8), n_levels=LEVELS)
    router = _router(side, [_identity()])
    controller = side.lifecycle.RollingSwapController(router, _RaisingBuilder(),
                                                      canary=W.batches(side, 1)[0])
    try:
        err = W.error_of(side.lifecycle.run_stream_with_swap, router, W.batches(side, 64),
                         controller=controller, snapshot=snap, swap_after=2)
        past_end = W.error_of(side.lifecycle.run_stream_with_swap, router, W.batches(side, 4),
                              controller=controller, snapshot=snap, swap_after=100)
        states = router.states()
    finally:
        router.close()
    return err, past_end, states


def test_run_stream_with_swap_surfaces_build_error_as_the_reference():
    got = _build_error_downs_tier(PORT)
    assert got == _build_error_downs_tier(REF)
    assert got[0] == ("RuntimeError", "build exploded") and got[2] == {0: "unhealthy"}
    assert got[1][0] == "ValueError" and "would never fire" in got[1][1]


def _failed_canary(side):
    snap = side.lifecycle.CorpusSnapshot(codes=np.zeros((8, 4), np.int8), n_levels=LEVELS)
    router = _router(side, [_identity(), _identity()])
    controller = side.lifecycle.RollingSwapController(router, _BrokenBuilder(),
                                                      canary=W.batches(side, 1)[0])
    try:
        err = W.error_of(controller.swap_all, snap)
        states, healthy = router.states(), router.healthy()
        result = router.submit(W.batches(side, 2)[1]).result(timeout=10)
    finally:
        router.close()
    return err, states, healthy, result


def test_swap_failed_canary_leaves_replica_unhealthy_but_tier_up():
    got = _failed_canary(PORT)
    want = _failed_canary(REF)
    assert got[:3] == want[:3] and W.same_results([want[3]], [got[3]])
    assert got[0][0] == "SwapFailed" and "canary probe" in got[0][1]
    assert got[1][0] == "unhealthy" and got[2] == [1]
    assert np.array_equal(W.host(got[3][0]), np.full((4,), 2))


def _aborted_swap(side):
    snap = side.lifecycle.CorpusSnapshot(codes=np.zeros((8, 4), np.int8), n_levels=LEVELS)
    router = _router(side, [_identity(), _identity()])
    controller = side.lifecycle.RollingSwapController(router, _RaisingBuilder(),
                                                      canary=W.batches(side, 1)[0])
    try:
        err = W.error_of(controller.swap_replica, 0, snap)
        seen = [router.states()[0], router.healthy(), router.probe(0, W.batches(side, 1)[0]),
                router.states()[0], router.revival_count]
    finally:
        router.close()
    return err, seen


def test_aborted_swap_parks_replica_unhealthy_and_reclaimable():
    got = _aborted_swap(PORT)
    assert got == _aborted_swap(REF)
    assert got == (("RuntimeError", "build exploded"), ["unhealthy", [1], True, "healthy", 1])


# ---------------------------------------------------------------------------
# drain semantics and the state machine
# ---------------------------------------------------------------------------


def test_drain_stops_routing_and_redispatches_stragglers():
    gate, started, calls = threading.Event(), threading.Event(), []

    def slow_search(c):
        started.set()
        gate.wait(timeout=10)
        calls.append(("slow", int(W.host(c).ravel()[0])))
        return c * 2, c + 1

    def fast_search(c):
        calls.append(("fast", int(W.host(c).ravel()[0])))
        return c * 2, c + 1

    router = _router(PORT, [((lambda x: x), slow_search), ((lambda x: x), fast_search)])
    try:
        b = W.batches(PORT, 2)
        t0 = router.submit(b[0])
        assert started.wait(timeout=5)
        router.drain(0, timeout=0.05)  # stuck replica: the drain times out, re-dispatches
        assert router.states()[0] == "draining"
        vals, _ = t0.result(timeout=10)
        assert np.array_equal(W.host(vals), np.full((4,), 0))
        assert router.failover_count >= 1
        router.submit(b[1]).result(timeout=10)
        assert all(tag == "fast" for tag, _ in calls)
    finally:
        gate.set()
        router.close()


def _misuse(side):
    router = _router(side, [_identity()], queue_depth=4)
    b = W.batches(side, 1)[0]
    seen = []
    try:
        seen.append(router.states())
        seen.append(W.error_of(router.begin_rebuild, 0))
        seen.append(router.probe(0, b))  # healthy: a no-op
        router.drain(0, timeout=1.0)
        seen.append(W.error_of(router.drain, 0, timeout=0.1))
        seen.append(W.error_of(router.probe, 0, b))
        router.begin_rebuild(0)
        seen.append(router.states()[0])
        seen.append(router.probe(0, b))  # only the swap controller may hand it back
        seen.append(router.states()[0])
        seen.append(router.probe(0, b, from_rebuild=True))
        seen.append(router.states()[0])
        seen.append(W.error_of(router.wait_state, 0, ("bogus",)))
        seen.append(router.wait_state(0, ("healthy",), timeout=1.0))
    finally:
        router.close()
    return seen


def test_state_machine_guards_misuse_as_the_reference():
    got = _misuse(PORT)
    assert got == _misuse(REF)
    assert got[0] == {0: "healthy"} and "need 'draining'" in got[1][1] and got[2] is True
    assert "need 'healthy'" in got[3][1] and "draining" in got[4][1]
    assert got[5:10] == ["rebuilding", False, "rebuilding", True, "healthy"]


# ---------------------------------------------------------------------------
# canary revival + generation-tagged stats
# ---------------------------------------------------------------------------


def _flaky_replica(side, fail_times):
    """Identity replica whose search fails ``fail_times[0]`` more times: a
    re-armable ``FaultEvent`` on the shared ``FaultInjector``."""
    class Countdown(side.faults.FaultEvent):
        def applies(self, i, rng=None):
            if self._times[0] > 0:
                self._times[0] -= 1
                return True
            return False

    ev = Countdown("fail")
    object.__setattr__(ev, "_times", fail_times)  # frozen dataclass
    return side.faults.FaultInjector(*_identity(), side.faults.FaultPlan([ev]),
                                     name="flaky").pair


def _revive(side):
    fail = [0]
    router = _router(side, [_identity(), _flaky_replica(side, fail)])
    b = W.batches(side, 8)
    seen = []
    try:
        results = [router.submit(b[i]).result(timeout=10) for i in range(4)]
        seen.append(router.stats()["per_replica"][1]["requests"])
        fail[0] = 1
        results += [router.submit(b[i]).result(timeout=10) for i in (4, 5)]
        seen += [router.states()[1], router.healthy()]
        seen.append(router.probe(1, b[0]))
        seen += [router.states()[1], router.revival_count]
        pr = router.stats()["per_replica"][1]
        seen.append((pr["generation"], pr["requests"], pr["lifetime_requests"]))
    finally:
        router.close()
    return results, seen, W.det_stats(router.stats())


def test_canary_probe_revives_and_separates_generations():
    got = _revive(PORT)
    want = _revive(REF)
    assert W.same_results(want[0], got[0]) and got[1:] == want[1:]
    W.check_identity(got[0], 6)
    assert got[1] == [2, "unhealthy", [0], True, "healthy", 1, (1, 1, 3)]
    assert got[2]["revivals"] == 1


def _periodic_probe(side):
    clk = side.clock.FakeClock()
    fail = [10**9]
    router = _router(side, [_identity(), _flaky_replica(side, fail)], clock=clk)
    seen = []
    try:
        router.start_health_probe(W.batches(side, 1)[0], interval=1.0)
        b = W.batches(side, 6)
        for i in range(4):
            router.submit(b[i]).result(timeout=10)
        seen.append(router.states()[1])
        for _ in range(3):  # probes fail at t=1, t=2; t=3 backs off
            clk.tick(1.0)
        seen += [router.states()[1], router.probe_failures().get(1, 0)]
        fail[0] = 0  # the fault clears: the next due probe revives
        ticks = 0
        for _ in range(16):
            clk.tick(1.0)
            ticks += 1
            if router.states()[1] == "healthy":
                break
        seen += [ticks, router.states()[1], router.revival_count]
        for i in range(4):
            router.submit(b[i]).result(timeout=10)
        seen.append(router.stats()["per_replica"][1]["requests"])
    finally:
        router.close()
    return seen


def test_periodic_health_probe_revives_when_fault_clears_as_the_reference():
    got = _periodic_probe(PORT)
    assert got == _periodic_probe(REF)
    assert got[0] == got[1] == "unhealthy" and got[2] >= 2
    assert got[4:6] == ["healthy", 1] and got[6] >= 1


def test_probe_refuses_revival_while_old_generation_scan_is_stuck():
    gate, fail = threading.Event(), [1]

    def search1(c):
        if fail[0] > 0:
            fail[0] -= 1
            raise RuntimeError("die once")
        gate.wait(timeout=10)
        return c * 2, c + 1

    router = _router(PORT, [_identity(), ((lambda x: x), search1)])
    try:
        b = W.batches(PORT, 4)
        router.submit(b[0]).result(timeout=10)
        router.submit(b[1]).result(timeout=10)  # replica 1 dies, fails over
        assert router.states()[1] == "unhealthy"
        straggler = router.replicas.pipelines[1].submit(b[2], force_block=True)
        assert router.probe(1, b[3], timeout=0.05) is False  # the quiesce times out
        assert router.states()[1] == "unhealthy"
        gate.set()
        straggler.result(timeout=10)
        assert router.probe(1, b[3]) is True and router.states()[1] == "healthy"
    finally:
        gate.set()
        router.close()


def test_failover_during_drain_parks_ticket_until_revival():
    fail = [1]

    def search1(c):
        if fail[0] > 0:
            fail[0] -= 1
            raise RuntimeError("die once")
        return c * 2, c + 1

    router = _router(PORT, [_identity(), ((lambda x: x), search1)])
    try:
        router.drain(0, timeout=1.0)
        t = router.submit(W.batches(PORT, 1)[0])
        assert router.wait_state(1, ("unhealthy",), timeout=10)
        time.sleep(0.05)
        assert not t.done()  # parked, not dropped
        assert router.probe(1, W.batches(PORT, 2)[1]) is True  # the revival flushes it
        vals, ids = t.result(timeout=10)
        assert np.array_equal(W.host(vals), np.full((4,), 0))
        assert np.array_equal(W.host(ids), np.full((4,), 1))
    finally:
        router.close()


def _mismatch(side):
    router = _router(side, [_identity(), _flaky_replica(side, [1])], queue_depth=4)
    b = W.batches(side, 4)
    try:
        for i in range(2):
            router.submit(b[i]).result(timeout=10)
        seen = [router.states()[1]]
        wrong = (side.array(np.zeros((4,))), side.array(np.zeros((4,))))
        seen += [router.probe(1, b[0], expect=wrong), router.states()[1]]
        good = (b[0] * 2, b[0] + 1)
        seen += [router.probe(1, b[0], expect=good), router.states()[1]]
        seen.append(type(router._errors.get(1)).__name__)
    finally:
        router.close()
    return seen


def test_probe_canary_mismatch_fails_the_probe():
    got = _mismatch(PORT)
    assert got == _mismatch(REF)
    assert got == ["unhealthy", False, "unhealthy", True, "healthy", "NoneType"]


# ---------------------------------------------------------------------------
# pipeline-level drain-without-close (quiesce / swap_fns / new_generation)
# ---------------------------------------------------------------------------


def test_quiesce_swap_fns_and_generation_on_live_pipeline():
    pipe = PS.ServingPipeline(*_identity(), config=PS.ServingConfig(queue_depth=4))
    try:
        b = W.batches(PORT, 3)
        for i in range(2):
            pipe.submit(b[i]).result(timeout=10)
        assert pipe.quiesce(timeout=10) is True
        s = pipe.stats()
        assert s["generation"] == 0 and s["requests"] == 2
        pipe.swap_fns(search_fn=lambda c: (c * 3, c + 7))
        assert pipe.new_generation() == 1
        vals, ids = pipe.submit(b[2]).result(timeout=10)
        assert np.array_equal(W.host(vals), np.full((4,), 6))
        assert np.array_equal(W.host(ids), np.full((4,), 9))
        s = pipe.stats()
        assert s["generation"] == 1 and s["requests"] == 1 and s["lifetime_requests"] == 3
    finally:
        pipe.close()


def test_quiesce_times_out_while_scan_is_stuck():
    gate = threading.Event()

    def stuck(c):
        gate.wait(timeout=10)
        return c, c

    pipe = PS.ServingPipeline(lambda x: x, stuck, config=PS.ServingConfig(queue_depth=4))
    try:
        t = pipe.submit(W.batches(PORT, 1)[0])
        assert pipe.quiesce(timeout=0.05) is False
        gate.set()
        t.result(timeout=10)
        assert pipe.quiesce(timeout=10) is True
    finally:
        gate.set()
        pipe.close()


def test_watchdog_clock_and_probe_loop_use_the_router_clock():
    """The probe loop parks on the injected clock: with no tick it never
    probes, whatever real time passes."""
    clk = PC.FakeClock()
    inj = PF.FaultInjector(*_identity(), PF.FaultPlan.fail_first(1), name="r0")
    router = PP.QueryRouter(PP.ReplicaSet([inj.pair, _identity()]), clock=clk)
    try:
        router.submit(W.batches(PORT, 1)[0]).result(timeout=10)
        assert router.states()[0] == "unhealthy"
        router.start_health_probe(W.batches(PORT, 1)[0], interval=1.0)
        assert clk.wait_for_sleepers(1)
        time.sleep(0.02)
        assert router.states()[0] == "unhealthy" and inj.calls["search"] == 1
        clk.tick(1.0)
        assert router.wait_state(0, ("healthy",), timeout=10)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_rolling_swap_on_card_bit_identical():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.index.flat import FlatSDC
    from repro_torch.kernels.sdc import sdc

    cd, cq = W.code_corpus(n=20_000, q=64, dim=128)
    dev = torch.device("cuda")
    index = FlatSDC.build(cd, LEVELS, device=dev)
    search = lambda q: index.search(q, 10)  # noqa: E731
    encode = lambda q: q  # noqa: E731
    batches = [torch.from_numpy(cq[i:i + 16]).to(dev) for i in range(0, 64, 16)]
    seq = PS.serve_sequential(encode, search, batches)
    router = PP.QueryRouter(PP.ReplicaSet([(encode, search)] * 2, share_device=True))
    snap = PL.CorpusSnapshot(codes=cd, n_levels=LEVELS, embedding_version="v1")
    controller = PL.RollingSwapController(router, PL.make_builder("flat", k=10),
                                          warm_batches=batches[:1], encode_fn=encode)
    try:
        sdc.sdc_topk.launches = 0
        results, report = PL.run_stream_with_swap(router, batches * 4, controller=controller,
                                                  snapshot=snap, swap_after=3)
    finally:
        router.close()
    assert W.same_results(seq * 4, results) and report.swapped == 2
    assert all(v.device.type == "cuda" for v, _ in results)
    # the stream, each replica's warmup (sequential + a pipeline) and canary
    assert sdc.sdc_topk.launches == 16 + 2 * (2 + 1)
    assert report.version.tag == W.RL.builder_version(
        W.RL.make_builder("flat", k=10), W.RL.CorpusSnapshot(cd, LEVELS, "v1")).tag
