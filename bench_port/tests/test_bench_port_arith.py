"""The window's arithmetic, the need-based counts, the trace's union and
attribution, and the reference's ordering keys, on hand-worked cases."""

import math
import types

import pytest
import torch

from bench_port.tests._tiny import CHECKOUT  # noqa: F401  (sets sys.path)
from bench_port import cell, load, spec, yardstick
from bench_port.indexes import bigranular, flat
from bench_port.reference import sdc
from bench_port.reference.binarizer import to_tf32
from bench_port.trace import DeviceEvent, Launch, Trace

MS = 1_000_000


def _req(t_submit_ms, t_host_ms, q=64, error=None):
    r = load.Request(client=0, seq=0, offset=0, n_queries=q)
    r.t_submit, r.t_host, r.error = t_submit_ms * MS, t_host_ms * MS, error
    return r


def _run(requests, t0_ms=1000, t1_ms=3000, **kw):
    return cell.Run(cfg={}, traffic={}, t0=t0_ms * MS, t1=t1_ms * MS, requests=requests,
                    setup_s=1.0, serve_mem_bytes=None, search_need=lambda q: (0, 0),
                    query_need_s=1e-6, **kw)


def test_qps_counts_every_answer_inside_the_window_over_its_length():
    reqs = [_req(900, 1100), _req(1500, 2900), _req(2900, 3100), _req(2000, 2500, error="x"),
            _req(1200, 1300, q=1)]
    # answered inside [1 s, 3 s] without error: 64 + 64 + 1 queries over 2 s
    assert spec.metric_reader("qps")(_run(reqs)) == pytest.approx(129 / 2.0)


def test_p95_is_taken_over_all_requests_of_the_window():
    reqs = [_req(1000 + i, 1000 + i + (i + 1), q=1) for i in range(100)]
    lat = sorted(i + 1 for i in range(100))  # 1 .. 100 ms
    want = lat[94] + 0.05 * (lat[95] - lat[94])  # linear between order statistics
    assert spec.metric_reader("p95_ms")(_run(reqs)) == pytest.approx(want)
    assert cell.percentile([5.0], 95) == 5.0
    assert cell.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0


def test_window_owes_requests_sent_or_answered_inside_it():
    reqs = [_req(900, 1100), _req(2999, 0), _req(500, 900), _req(3100, 3200)]
    owed = load.window_requests(reqs, 1000 * MS, 3000 * MS)
    assert owed == reqs[:2]


def test_need_counts_of_the_web_and_video_leaves():
    web = {"n_docs": 100_000_000, "code_dim": 128, "n_levels": 4, "k": 10}
    nbytes, ops = flat.need(web, 64)
    assert nbytes == 100_000_000 * (64 + 4) + 64 * 64 + 64 * 10 * 8
    assert ops == 2 * 64 * 100_000_000 * 128
    assert yardstick.least_time_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)
    video = {"n_docs": 200_000_000, "code_dim": 64, "n_levels": 4, "k": 20,
             "coarse_levels": 2, "k_coarse": 160}
    nbytes, ops = bigranular.need(video, 64)
    assert nbytes == 200_000_000 * (16 + 4) + 64 * 160 * (32 + 4) + 64 * 32 + 64 * 20 * 8
    assert ops == 2 * 64 * 200_000_000 * 64 + 2 * 64 * 160 * 64


def test_binarizer_flops_of_the_web_binarizer():
    cfg = {"input_dim": 256, "code_dim": 128, "n_levels": 4, "hidden_dim": 512}
    w = 2 * (256 * 512 + 512 * 128)
    r = 2 * (128 * 512 + 512 * 256)
    assert yardstick.binarizer_flops(cfg) == 4 * w + 3 * r
    want = (4 * w + 3 * r) / 67e12 + 2e9 / 1979e12
    assert yardstick.query_need_s(cfg, 2e9) == pytest.approx(want)


def _trace():
    dev = [DeviceEvent("scan", 100, 400, 7), DeviceEvent("merge", 350, 450, 8),
           DeviceEvent("Memcpy DtoH", 450, 460, 9), DeviceEvent("encode", 600, 700, 11)]
    launches = [Launch("cudaLaunchKernel", 50, 42, 7), Launch("cudaLaunchKernel", 60, 42, 8),
                Launch("cudaMemcpyAsync", 70, 42, 9), Launch("cudaGraphLaunch", 65, 43, 11)]
    # perf_counter_ns 1000 and 2000 sit at trace times 0 and 1000
    return Trace(dev, launches, [(1000, 0), (2000, 1000)], 1000, 2000)


def test_trace_union_gaps_and_attribution_by_thread_and_time():
    tr = _trace()
    assert tr.busy_intervals() == [(100, 460), (600, 700)]
    assert tr.busy_s() == pytest.approx(460e-9)
    assert tr.idle_gaps() == [(0, 100), (460, 600), (700, 1000)]
    # the span [1040, 1080] on thread 42 launched scan and merge (the copy is no kernel)
    assert tr.kernel_ns((1040, 1080), (42, 99)) == 300 + 100
    assert tr.kernel_ns((1040, 1080), (43,)) == 100
    assert tr.kernel_ns((1000, 1030), (42,)) is None
    assert tr.top_ops(2) == [["scan", 300e-9], ["merge", 100e-9]]


def test_roofline_and_idle_readers_on_a_trace():
    r = _req(1000, 1500)
    r.t_search, r.search_thread = (1040, 1080), (42,)
    run = _run([r], t0_ms=0, t1_ms=2, trace=_trace())
    run.t0, run.t1 = 1000, 2000
    run.search_need = lambda q: (3.35e12 * 100e-9, 0)  # 100 ns at the byte bound
    assert spec.metric_reader("scan_roofline")(run) == pytest.approx(25.0)
    assert spec.metric_reader("scan_device_ms")(run) == pytest.approx(400e-6)
    assert spec.metric_reader("device_idle")(run) == pytest.approx(100 * (1 - 460 / 1000))


def test_readers_without_a_trace_return_nothing():
    run = _run([_req(1100, 1200)])
    for name in ("scan_roofline", "scan_device_ms", "device_idle", "request_mfu"):
        assert spec.metric_reader(name)(run) is None
    assert spec.metric_reader("serve_mem_gb")(run) is None


def test_request_mfu_counts_queries_not_requests():
    run = _run([_req(1100, 1200, q=64), _req(1200, 1300, q=1)],
               trace=types.SimpleNamespace(device_events=[]))
    assert spec.metric_reader("request_mfu")(run) == pytest.approx(100 * 65 * 1e-6 / 2.0)


def test_order_keys_rank_by_score_then_lower_id():
    s = torch.tensor([[0.5, -1.0, 0.5, 2.0, -0.0, 0.0, -3.5]])
    ids = torch.arange(7)[None]
    keys = sdc.order_keys(s, ids)
    order = torch.argsort(keys, dim=1, descending=True)[0].tolist()
    assert order == [3, 0, 2, 5, 4, 1, 6]
    back_s, back_ids = sdc.decode_keys(keys)
    assert torch.equal(back_s, s) and torch.equal(back_ids, ids)


def test_scores_follow_the_affine_identity():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(0, 16, (3, 8), generator=g, dtype=torch.int8)
    d = torch.randint(0, 16, (5, 8), generator=g, dtype=torch.int8)
    a, beta = sdc.affine(4)
    vq, vd = q.double() * a + beta, d.double() * a + beta
    want = (vq @ vd.t()) / vd.norm(dim=1)
    got = sdc.scores(q, d, sdc.inv_norms(d, 4), 4).double()
    assert torch.allclose(got, want, rtol=1e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, math.pi])
    assert to_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, 3.140625]
