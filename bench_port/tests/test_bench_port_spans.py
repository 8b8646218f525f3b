"""The readers of the port's own spans (``program_spans.py`` and the five
``metrics/`` files that read it) on a hand-worked trace and spans: the idle
split by the scan thread's span, the means, the join of a request to its
admission span, the launches inside their dispatch, and nothing read
without spans."""

import pytest

from bench_port.tests._tiny import CHECKOUT  # noqa: F401  (puts src/ on the path)

from bench_port import cell, load, program_spans as P, spec  # noqa: E402
from bench_port.trace import DeviceEvent, Launch, Trace  # noqa: E402
from repro_torch.spans import Span  # noqa: E402

SCAN, ENCODE = 42, 43
READERS = ("admission_wait_ms", "encode_stall_ms", "idle_starved", "idle_issue",
           "rerank_host_ms")


def _trace():
    dev = [DeviceEvent("void sdc_scan_kernel<128, true>", 100, 400, 7),
           DeviceEvent("sdc_merge_kernel", 350, 450, 8), DeviceEvent("Memcpy DtoH", 450, 460, 9),
           DeviceEvent("encode", 600, 700, 11)]
    launches = [Launch("cudaLaunchKernel", 85, 7042, 7), Launch("cudaLaunchKernel", 95, SCAN, 8),
                Launch("cudaMemcpyAsync", 96, SCAN, 9), Launch("cudaGraphLaunch", 65, ENCODE, 11)]
    # perf_counter_ns 1000 and 2000 sit at trace times 0 and 1000; idle: (0, 100),
    # (460, 600), (700, 1000)
    return Trace(dev, launches, [(1000, 0), (2000, 1000)], 1000, 2000)


def _spans():
    def s(name, rid, start, end, thread=SCAN, parent=None):
        return Span(name, rid, parent, thread, start, end)

    return [s("scan.wait_input", None, 1000, 1080), s("scan.dispatch", 0, 1080, 1090),
            s("rerank.host", 0, 1085, 1088, parent="scan.dispatch"),
            s("scan.wait_device", 0, 1090, 1470), s("scan.reply", 0, 1470, 1480),
            s("scan.wait_input", None, 1480, 1650), s("scan.dispatch", 1, 1650, 1720),
            s("scan.wait_device", 1, 1720, 1900),
            s("serve.queued", 0, 900, 1050, ENCODE), s("serve.queued", 1, 1000, 1400, ENCODE),
            s("encode.upload", None, 500, 600, ENCODE), s("encode.upload", 0, 1052, 1055, ENCODE),
            s("encode.upload", 1, 1402, 1410, ENCODE)]


def _run(spans=None, trace=True):
    reqs = []
    for seq, (enc, host) in enumerate([((1051, 1060), 1500), ((1401, 1420), 1950)]):
        r = load.Request(client=0, seq=seq, offset=0, n_queries=64)
        r.t_submit, r.t_encode, r.t_host = enc[0] - 200, enc, host
        r.t_search, r.search_thread = (enc[1] + 10, enc[1] + 20), (SCAN, 7042)
        reqs.append(r)
    run = cell.Run(cfg={}, traffic={}, t0=1000, t1=2000, requests=reqs, setup_s=1.0,
                   serve_mem_bytes=None, search_need=lambda q: (0, 0), query_need_s=1e-6,
                   trace=_trace() if trace else None)
    if spans is not None:
        run.spans = spans
    return run


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_the_idle_split_puts_each_gap_under_the_scan_threads_span():
    run = _run(_spans())
    assert P.idle_split(run) == {"scan.wait_input": 80 + 120, "scan.wait_device": 10 + 10 + 180,
                                 "scan.reply": 10, "scan.dispatch": 10 + 20, "none": 100}
    assert sum(P.idle_split(run).values()) == sum(g1 - g0 for g0, g1 in run.trace.idle_gaps())
    assert _read("idle_starved", run) == pytest.approx(20.0)
    assert _read("idle_issue", run) == pytest.approx(4.0)


def test_the_means_the_admission_join_and_the_launches_inside_their_dispatch():
    run = _run(_spans())
    assert _read("admission_wait_ms", run) == pytest.approx((150 + 400) / 2 / 1e6)
    assert _read("encode_stall_ms", run) == pytest.approx((3 + 8) / 2 / 1e6)  # the window's two
    assert _read("rerank_host_ms", run) == pytest.approx(3 / 1e6)
    # the scan kernel's launch (thread 7042, the scan thread's pthread id) lies in
    # dispatch 0; the merge's, at 95, in the wait that follows it
    assert P.launch_coverage(run) == [1, 2]


def test_without_spans_every_reader_returns_nothing():
    for run in (_run(), _run([]), _run(_spans(), trace=False)):
        for name in ("idle_starved", "idle_issue"):
            assert _read(name, run) is None
        assert P.idle_split(run) is None
    for run in (_run(), _run([])):
        assert all(_read(name, run) is None for name in READERS)
        assert P.launch_coverage(run) in (None, [0, 2])
    two = _spans() + [Span("scan.wait_input", None, None, SCAN + 1, 1000, 1100)]
    assert P.idle_split(_run(two)) is None  # two scan threads: no single split


@pytest.mark.parametrize("name", READERS)
def test_no_entry_names_a_span_metric_yet(name):
    """The harness does not start the recorder, so no run has spans: an entry
    would ask every traced run for a metric it cannot read. Each reader loads
    by its name and reads nothing from a run without spans."""
    bench = spec.benchmark()
    assert name not in {m["name"] for m in bench["per_layer"] + bench["end_to_end"]}
    for cellname in ("web-flat.q64-c8", "video-bigr.q64-c8"):
        for trace in (False, True):
            assert name not in {m["name"] for m in spec.cell_metrics(bench, cellname, trace)}
    assert _read(name, _run()) is None
