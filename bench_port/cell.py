"""One run of one cell: set-up, the measured window, the check.

Set-up: the binarizer's weights and the corpus from the seed; the corpus
encoded by the port's encode (``make_encode_fn``) and indexed by the
port's build a chunk at a time (``assemble``); the query pool; one ``ServingPipeline`` replica
behind a ``QueryRouter``, whose encode is the port's captured encode and
whose search is the index's; the clients started and run until each has
finished its warm-up requests (which captures the encode graph at the
request's shape and loads the kernels). The window opens then, and
lasts ``seconds``. Afterwards the clients stop, every request of the
window is waited for, the port's threads are closed, and ``check.judge``
holds a sample of the answers and the index to the reference.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from bench_port import assemble, check, load, spec, weights as weights_lib, yardstick
from bench_port.corpus import Corpus

# Seconds a run waits for the warm-up, and for the window's last replies.
WARM_TIMEOUT_S = 300.0
DRAIN_TIMEOUT_S = 60.0


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cfg: dict
    traffic: dict
    t0: int  # window, perf_counter_ns
    t1: int
    requests: List[load.Request]  # every request of the run
    setup_s: float
    serve_mem_bytes: Optional[int]
    search_need: Callable[[int], tuple]  # q -> (bytes, int8 ops) of one search
    query_need_s: float  # seconds of the chip's peak one query needs
    trace: Optional[object] = None  # trace.Trace of a traced run

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def completed(self) -> List[load.Request]:
        return load.completed_in(self.requests, self.t0, self.t1)

    def searched(self) -> List[load.Request]:
        """Requests whose search call lay wholly inside the window."""
        return [r for r in self.requests
                if r.t_search and self.t0 <= r.t_search[0] and r.t_search[1] <= self.t1]

    def search_kernel_ns(self, r: load.Request) -> Optional[int]:
        """Device time of the kernels the request's search call launched."""
        return self.trace.kernel_ns(r.t_search, r.search_thread)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, t_start: int,
             device="cuda", bench: Optional[dict] = None, overrides: Optional[dict] = None,
             wrap_search: Optional[Callable] = None) -> dict:
    """Run ``cell`` once; returns the result line's object.

    ``t_start`` is the process's start (``perf_counter_ns``). ``overrides``
    replaces configuration keys (small sizes in tests); ``wrap_search(search, index, cfg)``
    returns the search the pipeline gets (faults planted by tests). Both are for tests
    and leave the runs of the benchmark alone.
    """
    from repro_torch.core.binarize_lib import BinarizerConfig, binarizer_from_numpy, make_encode_fn
    from repro_torch.kernels import _build
    from repro_torch.launch.proxy import QueryRouter, ReplicaSet
    from repro_torch.launch.serving import ServingConfig

    bench = spec.benchmark() if bench is None else bench
    w = spec.workload(bench, cell)
    cfg = {**spec.config(bench, w["config"]), **(overrides or {})}
    traffic = spec.traffic(w["traffic"])
    kind, ref_kind = spec.index_kind(cfg["index"]), spec.reference_kind(cfg["index"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    log(f"cell {cell}: config {w['config']}, traffic {w['traffic']}, seed {seed}, "
        f"N {cfg['n_docs']}, {traffic['clients']} clients x {traffic['queries_per_request']} "
        f"queries")

    def since_start() -> str:
        return f"{(time.perf_counter_ns() - t_start) / 1e9:.1f} s"

    if on_card:
        _build.build([_build.INCLUDE_DIRS[0] / s for s in kind.KERNEL_SOURCES])
        log(f"kernels built or found: {since_start()}")
    params, state = weights_lib.make(cfg, seed, dev)
    bcfg = BinarizerConfig(input_dim=cfg["input_dim"], code_dim=cfg["code_dim"],
                           n_levels=cfg["n_levels"], hidden_dim=cfg["hidden_dim"])
    model = binarizer_from_numpy(params, state, bcfg, device=dev)

    # The corpus, encoded by the port and indexed by its build a chunk at a time.
    corpus = Corpus(cfg, seed, dev)
    rows = assemble.Rows(cfg["n_docs"])
    corpus_encode = make_encode_fn(model)
    for c in range(corpus.n_chunks):
        s, e = corpus.bounds(c)
        raw = corpus.raw(c)
        corpus.collect(c, raw)
        rows.add(s, e - s, kind.build(cfg, corpus_encode(corpus.docs(c, raw)), dev))
    del corpus_encode, raw
    pool = corpus.queries()
    index = rows.finish()
    search = kind.searcher(index, cfg)
    del rows, corpus
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    held = assemble.held_bytes(index, cfg["n_docs"])
    log(f"index: {cfg['n_docs']} documents, {held['device']} bytes on the device, "
        f"{held['host']} in host memory: {since_start()}")

    if wrap_search is not None:
        search = wrap_search(search, index, cfg)
    spans = load.Spans()
    pair = (spans.encode(make_encode_fn(model)), spans.search(search))
    serving = cfg["serving"]
    replicas = ReplicaSet([pair] * serving["replicas"],
                          config=ServingConfig(queue_depth=serving["queue_depth"],
                                               policy=serving["policy"]),
                          share_device=serving["replicas"] > 1)
    router = QueryRouter(replicas, policy=serving["router"])
    clients = load.Clients(router, pool, traffic, spans)
    prof = smi = None
    try:
        clients.start()
        clients.wait_warm(WARM_TIMEOUT_S)
        log(f"warm: {since_start()}")
        if trace:
            from bench_port.trace import Profiler

            prof = Profiler()
            prof.start()
        setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter_ns()
        time.sleep(seconds)
        t1 = time.perf_counter_ns()
        serve_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        smi = nvidia_smi() if on_card else None  # the card's clocks and power, still loaded
        all_back = clients.stop(DRAIN_TIMEOUT_S)
        if prof is not None:
            prof.stop()  # once no thread issues device work
    finally:
        clients.stop(DRAIN_TIMEOUT_S)
        router.close()
    if smi is not None:
        log(f"nvidia-smi as the window closed (name, power limit, draw, SM clock, max SM clock): "
            f"{smi.read()}")
    if not all_back:
        log("a client was still waiting for its reply a minute after the window")

    owed = load.window_requests(clients.requests, t0, t1)
    failed = [r for r in owed if r.error is not None or not r.done]
    done = load.completed_in(clients.requests, t0, t1)
    log(f"window: {(t1 - t0) / 1e9:.3f} s, {len(owed)} requests attempted, {len(failed)} failed, "
        f"{len(done)} answered inside it")
    for r in failed[:3]:
        log(f"failed request (client {r.client}, #{r.seq}): {r.error or 'no reply'}")
    log(f"queries answered in each second of the window: {per_second(done, t0, t1)}")

    run = Run(cfg=cfg, traffic=traffic, t0=t0, t1=t1, requests=clients.requests,
              setup_s=(t0 - t_start) / 1e9, serve_mem_bytes=serve_peak,
              search_need=lambda q: kind.need(cfg, q),
              query_need_s=yardstick.query_need_s(cfg, kind.need(cfg, 1)[1]))
    result: Dict = {"correct": False, "attempted": len(owed), "failed": len(failed)}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1,
                   "memory_peak_bytes": max(setup_peak, serve_peak) if on_card else 0,
                   "window_memory_peak_bytes": serve_peak if on_card else 0}
    if prof is not None:
        t_read = time.perf_counter()
        run.trace = prof.trace(t0, t1)
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run)
        attributed = sum(run.search_kernel_ns(r) is not None for r in run.searched())
        log(f"trace read in {time.perf_counter() - t_read:.1f} s: "
            f"{len(run.trace.device_events)} device operations, "
            f"{len(run.trace.launches)} runtime calls; kernels found for {attributed} of "
            f"{len(run.searched())} search calls")
        if run.searched() and not attributed:
            log(f"runtime calls' threads {sorted({ln.thread for ln in run.trace.launches})[:8]}, "
                f"search threads {sorted({r.search_thread for r in run.searched()})[:4]}")

    metrics = {}
    for m in spec.cell_metrics(bench, cell, trace):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info

    # The check, with the port's threads closed and the window's memory read.
    t_check = time.perf_counter()
    sampled = check.sample(done, traffic["check_queries"], seed)
    numbers = check.judge(cfg, seed, dev, (params, state), kind, ref_kind, index, pool, sampled)
    numbers["failed"] = len(failed)
    numbers["answered"] = len(done)
    limits = dict(cfg["limits"], answered=None)
    correct = check.verdict(numbers, cfg["limits"]) and len(done) > 0
    log(f"check of {sum(r.n_queries for r in sampled)} queries in "
        f"{len(sampled)} requests: {time.perf_counter() - t_check:.1f} s")
    result["correct"] = correct
    result["checks"] = {k: {"value": numbers[k], "limit": limits.get(k)} for k in numbers}
    return result


def breakdown(run: Run) -> dict:
    """The traced window's costliest device operations, and its longest idle
    stretches, each named by the harness span open on the host then."""
    tr = run.trace
    spans = []  # (start, end, name) on the trace clock
    for r in run.requests:
        if r.t_submit and r.t_admitted:
            spans.append((tr.at(r.t_submit), tr.at(r.t_admitted), "router submit"))
        if r.t_encode:
            spans.append((tr.at(r.t_encode[0]), tr.at(r.t_encode[1]), "encode"))
        if r.t_search:
            spans.append((tr.at(r.t_search[0]), tr.at(r.t_search[1]), "search"))
        if r.t_encode and r.t_search:
            spans.append((tr.at(r.t_encode[1]), tr.at(r.t_search[0]), "handoff to search"))
        if r.t_search and r.done:
            spans.append((tr.at(r.t_search[1]), tr.at(r.t_host), "handoff to host"))
    rank = {"search": 0, "encode": 1, "router submit": 2, "handoff to search": 3,
            "handoff to host": 4}
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        open_ = [name for s, e, name in spans if s <= mid <= e]
        label = min(open_, key=rank.get) if open_ else "no harness span"
        named.append([label, (g1 - g0) / 1e9])
    return {"device_ops": tr.top_ops(10), "idle_gaps": named}


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile (0 < p < 100), linear between order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    at = (len(xs) - 1) * p / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


class nvidia_smi:
    """``nvidia-smi``'s reading of the card, started now, read later."""

    QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm"

    def __init__(self):
        import subprocess

        try:
            self._proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={self.QUERY}",
                                           "--format=csv,noheader"], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            self._proc, self._error = None, str(e)

    def read(self) -> str:
        import subprocess

        if self._proc is None:
            return f"unavailable ({self._error})"
        try:
            out, _ = self._proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.communicate()
            return "unavailable (timed out)"
        return out.strip()


def per_second(done: List[load.Request], t0: int, t1: int) -> List[int]:
    counts = [0] * max(1, math.ceil((t1 - t0) / 1e9))
    for r in done:
        counts[min(len(counts) - 1, (r.t_host - t0) // 1_000_000_000)] += r.n_queries
    return counts

