#!/usr/bin/env python3
"""The serving path's own spans over a traced run of a benchmark cell.

    python3 tools/serving_spans.py --workload web-flat.q64-c8 --seed 7 [--seconds 10] \
        [--out chiprun_out/spans.jsonl]

Runs the cell as ``bench_port/run.py --trace 1`` does (``cell.run_cell``),
with the port's span recorder (``repro_torch/spans.py``) on from just
before the profiler starts to just after it stops, as the harness does not
yet, and prints one JSON line (appended to ``--out`` too): ``correct``, the
run's per-layer metrics, and what the span readers make of the run with
``run.spans`` set, laid over the device trace by its clock marks:

  admission_wait_ms, encode_stall_ms, idle_starved, idle_issue,
  rerank_host_ms     the readers ``bench_port/metrics/<name>.py``, which
                     no entry of ``BENCHMARK.json`` names yet
  idle_split_ms      the device's idle time in the window by the scan
                     thread's span open then (``none``: in none of them)
  launch_coverage    [inside, all]: the window's ``sdc_topk`` launch calls,
                     and those inside a ``scan.dispatch`` of their thread
  dropped            spans past the recorder's cap

(``bench_port/program_spans.py``.) One replica: the split wants one scan
thread, the admission join one encode thread. Needs a CUDA card, as the
benchmark does; the tests call ``traced_run`` on the CPU at small sizes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
for _p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SPAN_METRICS = ("admission_wait_ms", "encode_stall_ms", "idle_starved", "idle_issue",
                "rerank_host_ms")


def traced_run(workload: str, seed: int, seconds: float, **run_cell_kw):
    """``cell.run_cell`` traced, with the recorder on over the profiler's
    session; returns (result, run with ``spans``, dropped)."""
    from bench_port import cell, trace
    from repro_torch import spans

    box = {}
    start, stop, breakdown = trace.Profiler.start, trace.Profiler.stop, cell.breakdown

    def start_both(prof):
        spans.start()
        start(prof)

    def stop_both(prof):
        stop(prof)
        box["recorded"] = spans.stop()

    def keep_run(run):
        box["run"] = run
        return breakdown(run)

    trace.Profiler.start, trace.Profiler.stop, cell.breakdown = start_both, stop_both, keep_run
    try:
        result = cell.run_cell(workload, seed, seconds, True, t_start=T_START, **run_cell_kw)
    finally:
        trace.Profiler.start, trace.Profiler.stop, cell.breakdown = start, stop, breakdown
        spans.stop()
    run, recorded = box["run"], box["recorded"]
    run.spans = recorded.spans
    return result, run, recorded.dropped


def readout(result, run, dropped) -> dict:
    from bench_port import program_spans, spec

    out = {"correct": result["correct"], "metrics": result["metrics"],
           "spans": len(run.spans), "dropped": dropped}
    for name in SPAN_METRICS:
        value = spec.metric_reader(name)(run)
        if value is not None:
            out[name] = value
    split = program_spans.idle_split(run)
    if split is not None:
        out["idle_split_ms"] = {k: v / 1e6 for k, v in split.items()}
        out["window_ms"] = (run.trace.w1 - run.trace.w0) / 1e6
    out["launch_coverage"] = program_spans.launch_coverage(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", help="a file to append the JSON line to")
    args = ap.parse_args(argv)

    import bench_port.run  # noqa: F401  (the benchmark's cache directories)

    result, run, dropped = traced_run(args.workload, args.seed, args.seconds)
    line = json.dumps({"workload": args.workload, "seed": args.seed,
                       **readout(result, run, dropped)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
