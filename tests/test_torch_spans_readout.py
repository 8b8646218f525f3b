"""``tools/serving_spans.py``: a traced run of each benchmark cell at small
sizes on the CPU with the port's span recorder on, read by the span
readers (``bench_port/metrics/``; hand-worked cases in
``bench_port/tests/test_bench_port_spans.py``)."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("serving_spans", ROOT / "tools" / "serving_spans.py")
T = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(T)  # puts the checkout and src/ on sys.path

from bench_port import program_spans, spec  # noqa: E402
from bench_port.tests._tiny import CELLS, overrides  # noqa: E402


@pytest.mark.parametrize("cellname", CELLS)
def test_a_traced_run_reads_the_cells_spans(cellname):
    bench = spec.benchmark()
    base = spec.config(bench, spec.workload(bench, cellname)["config"])
    # A window long enough that requests submitted after the recorder started
    # are answered in it (the CPU's queue waits reach a second).
    result, run, dropped = T.traced_run(cellname, 2147483659, 3.0, device="cpu", bench=bench,
                                        overrides=overrides(base))
    out = T.readout(result, run, dropped)
    assert out["correct"] and out["dropped"] == 0
    assert {"admission_wait_ms", "idle_starved", "idle_issue"} <= set(out)
    assert ("rerank_host_ms" in out) == (base["index"] == "bigranular")
    assert "encode_stall_ms" not in out  # the captured encode's span: on the card only
    assert out["admission_wait_ms"] > 0
    split = out["idle_split_ms"]
    assert sum(split.values()) == pytest.approx(out["window_ms"])  # no device work here
    scan = sorted((s for s in run.spans if s.name in program_spans.SCAN_SPANS),
                  key=lambda s: s.start)
    assert len({s.thread for s in scan}) == 1
    assert all(a.end <= b.start for a, b in zip(scan, scan[1:]))
    assert out["metrics"]["queue_wait_ms"]["value"] > 0
