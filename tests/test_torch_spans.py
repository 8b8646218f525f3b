"""The port's span recorder (``repro_torch/spans.py``) on the serving
path, on the CPU: off, the sites call nothing; on, every request carries
one id from its admission to its reply, through a failover re-dispatch,
the scan thread's spans tile its loop without overlapping, the host
rerank lies inside its dispatch, the answers are the bits of a run with
the recorder off, and the pipeline's ``device_idle_frac`` counts as idle
the time its ``scan.wait_input`` spans hold. A port-only module: the reference has no
twin to hold it against."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.index.flat import BiGranularFlat  # noqa: E402
from repro_torch.launch import faults as PF  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402
from repro_torch.launch import serving as PS  # noqa: E402
from repro_torch import spans  # noqa: E402

SCAN = ("scan.wait_input", "scan.wait_device", "scan.reply", "scan.dispatch")
LEVELS = 4


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    yield
    spans.stop()


def _batches(n, rows=3, dim=4):
    return [torch.full((rows, dim), float(i)) for i in range(n)]


def _identity_search(codes):
    time.sleep(0.002)  # a scan long enough for the stages to overlap
    return codes * 2, codes + 1


def _serve(pipe_or_router, batches):
    tickets = [pipe_or_router.submit(b) for b in batches]
    return [t.result(timeout=30) for t in tickets]


def _threads(pipe):
    return pipe._encode_thread.native_id, pipe._scan_thread.native_id


def _of(recorded, thread=None, names=None):
    return [s for s in recorded.spans
            if (thread is None or s.thread == thread) and (names is None or s.name in names)]


def _bigranular(seed=3, n=300, q=5, dim=16):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, 2 ** LEVELS, size=(n, dim)).astype(np.int8)
    queries = [torch.as_tensor(rng.integers(0, 2 ** LEVELS, size=(q, dim)).astype(np.int8))
               for _ in range(4)]
    index = BiGranularFlat.build(docs, LEVELS, coarse_levels=2, k_coarse=12, device="cpu")
    assert isinstance(index.fine_codes, np.ndarray)  # the host tier: the gather path
    return index, queries


def test_off_the_sites_call_nothing(monkeypatch):
    """With the recorder off no site calls into it (so nothing is allocated
    or locked there): every entry point raises if called, and a routed,
    re-ranked run over a pipeline still serves every request."""
    def called(*args, **kwargs):
        raise AssertionError("the recorder was called while off")

    class NoLock:
        def __enter__(self):
            raise AssertionError("the recorder's lock was taken while off")

        def __exit__(self, *exc):
            return False

    for name in ("record", "record_here", "enter"):
        monkeypatch.setattr(spans, name, called)
    monkeypatch.setattr(spans, "_lock", NoLock())
    index, queries = _bigranular()
    router = PP.QueryRouter(PP.ReplicaSet([(lambda c: c, lambda c: index.search(c, 5))]))
    try:
        got = _serve(router, queries)
    finally:
        router.close()
    assert len(got) == len(queries)
    assert spans._spans == []


def test_each_request_carries_one_id_and_the_scan_thread_never_overlaps():
    batches = _batches(10)
    spans.start()
    pipe = PS.ServingPipeline(lambda b: b, _identity_search)
    try:
        _serve(pipe, batches)
    finally:
        pipe.close()
    recorded = spans.stop()
    assert recorded.dropped == 0
    enc, scan = _threads(pipe)
    for name, thread in (("serve.queued", enc), ("scan.dispatch", scan),
                         ("scan.wait_device", scan), ("scan.reply", scan)):
        got = _of(recorded, thread, {name})
        assert sorted(s.rid for s in got) == list(range(len(batches))), name
    queued = _of(recorded, enc, {"serve.queued"})
    assert all(s.start <= s.end for s in queued)
    loop = sorted(_of(recorded, scan, SCAN), key=lambda s: s.start)
    assert {s.name for s in loop} == set(SCAN)
    assert all(a.end <= b.start for a, b in zip(loop, loop[1:]))
    assert all(s.rid is None for s in loop if s.name == "scan.wait_input")
    assert all(s.parent is None for s in recorded.spans)


def test_a_routed_request_is_named_by_the_router_across_replicas():
    spans.start()
    router = PP.QueryRouter(PP.ReplicaSet([(lambda b: b, _identity_search)] * 2))
    try:
        _serve(router, _batches(8))
    finally:
        router.close()
    recorded = spans.stop()
    scans = {p._scan_thread.native_id for p in router.replicas.pipelines}
    dispatched = [s for s in _of(recorded, names={"scan.dispatch"}) if s.thread in scans]
    assert sorted(s.rid for s in dispatched) == list(range(8))
    assert len({s.thread for s in dispatched}) == 2  # round-robin over both replicas


def test_answers_are_the_same_bits_with_the_recorder_on_and_off():
    index, queries = _bigranular(seed=5)

    def run():
        router = PP.QueryRouter(PP.ReplicaSet([(lambda c: c, lambda c: index.search(c, 5))]))
        try:
            return _serve(router, queries)
        finally:
            router.close()

    off = run()
    spans.start()
    on = run()
    assert len(spans.stop().spans) > 0
    for (s0, i0), (s1, i1) in zip(off, on):
        assert torch.equal(s0.view(torch.int32), s1.view(torch.int32))
        assert torch.equal(i0, i1)


def test_the_host_rerank_lies_inside_its_dispatch():
    index, queries = _bigranular(seed=7)
    spans.start()
    pipe = PS.ServingPipeline(lambda c: c, lambda c: index.search(c, 5))
    try:
        _serve(pipe, queries)
    finally:
        pipe.close()
    recorded = spans.stop()
    _, scan = _threads(pipe)
    dispatch = {s.rid: s for s in _of(recorded, scan, {"scan.dispatch"})}
    reranks = _of(recorded, names={"rerank.host"})
    assert sorted(s.rid for s in reranks) == sorted(dispatch) == list(range(len(queries)))
    for r in reranks:
        d = dispatch[r.rid]
        assert (r.parent, r.thread) == ("scan.dispatch", scan)
        assert d.start <= r.start <= r.end <= d.end


def test_a_direct_search_records_its_rerank_under_no_request():
    index, queries = _bigranular(seed=9)
    out = []
    thread = threading.Thread(target=lambda: out.append(index.search(queries[0], 5)))
    spans.start()
    thread.start()
    thread.join()
    recorded = spans.stop()
    (r,) = _of(recorded, names={"rerank.host"})
    assert (r.rid, r.parent, r.thread) == (None, None, thread.native_id)


def test_a_failover_redispatch_keeps_the_request_id():
    dying = PF.FaultInjector(lambda x: x, _identity_search, PF.FaultPlan.fail_after(1),
                             name="r1").pair
    spans.start()
    router = PP.QueryRouter(PP.ReplicaSet([(lambda b: b, _identity_search), dying],
                                          config=PS.ServingConfig(queue_depth=16)))
    try:
        tickets = [router.submit(b) for b in _batches(8)]
        results = [t.result(timeout=30) for t in tickets]
    finally:
        router.close()
    recorded = spans.stop()
    assert len(results) == 8 and router.stats()["failovers"] >= 1
    moved = [t.seq for t in tickets if t.redispatches]
    assert moved
    encoders = {p._encode_thread.native_id for p in router.replicas.pipelines}
    for rid in moved:
        queued = [s for s in _of(recorded, names={"serve.queued"}) if s.rid == rid]
        assert {s.thread for s in queued} == encoders  # queued on both replicas
        assert len({s.start for s in queued}) == 1  # from the one submit
        assert len([s for s in _of(recorded, names={"scan.dispatch"}) if s.rid == rid]) == 1


def test_device_idle_frac_is_the_share_of_the_scan_waits_for_input():
    spans.start()
    pipe = PS.ServingPipeline(lambda b: b, _identity_search,
                              config=PS.ServingConfig(encode_ahead=2))
    try:
        for b in _batches(6):
            _serve(pipe, [b])  # one at a time: the scan thread waits for each
        _serve(pipe, _batches(6))
    finally:
        pipe.close()
    recorded = spans.stop()
    _, scan = _threads(pipe)
    total = {name: sum(s.end - s.start for s in _of(recorded, scan, {name})) for name in SCAN}
    idle = total["scan.wait_input"]
    assert idle > 0 and total["scan.dispatch"] > 0
    assert pipe._scan_idle_s == pytest.approx(idle / 1e9, rel=1e-9)
    # busy: the awaited scans' waits, and each dispatch up to its search's return
    # (the dispatch span runs on to the in-flight append)
    frac = pipe.stats()["device_idle_frac"]
    assert idle / (idle + total["scan.wait_device"] + total["scan.dispatch"]) <= frac
    assert frac < idle / (idle + total["scan.wait_device"])


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.start()
    for i in range(5):
        spans.record("x", i, i, i + 1)
    recorded = spans.stop()
    assert [s.rid for s in recorded.spans] == [0, 1, 2] and recorded.dropped == 2
    spans.record("late", None, 0, 1)  # off again: nothing kept
    spans.start()
    assert spans.stop() == ([], 0)
