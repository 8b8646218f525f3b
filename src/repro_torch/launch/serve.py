"""BEBR serving launcher, flat, IVF and HNSW indexes (ports the
``--index flat|ivf|hnsw`` paths of ``repro/launch/serve.py``, bi-granular
mode included).

    PYTHONPATH=src python -m repro_torch.launch.serve --index flat --docs 20000 --queries 64
    PYTHONPATH=src python -m repro_torch.launch.serve --index ivf [--probe-budget 2080]
    PYTHONPATH=src python -m repro_torch.launch.serve --index hnsw [--ef 64 --beam 8]
    PYTHONPATH=src python -m repro_torch.launch.serve --index flat|ivf|hnsw \
        --coarse-levels 2 --k-coarse 64

End to end on the card: a clustered synthetic corpus -> eval-mode
recurrent binarizer -> integer codes (nibble-packed with ``--packed``)
-> ``FlatSDC`` scanned by the CUDA ``sdc_topk`` kernel, or an IVF index
(nlist 64, nprobe 32, k-means seed 1, the reference CLI's parameters)
whose probed lists the CUDA ``sdc_gather_topk`` kernel scans, or an NSW
graph (M 16, ef_construction 64, seed 0, built on the host in O(N^2))
walked by the batched-frontier search, whose hops the same gather kernel
scores (``--ef`` results, ``--beam`` nodes expanded a hop, at most 64
hops), served through ``ServingPipeline``. ``--coarse-levels C
--k-coarse K'`` serves any family in bi-granular mode: the index covers
the first C levels of the codes (hot tier, on the card) and the top-K'
survivors of each query are reranked on the full-level codes, which
stay in host memory (cold tier) and are gathered there per request. Recall@k against the
float-embedding exhaustive baseline, index bytes, and sequential vs
pipelined ms/batch. Training is not ported yet: ``--ckpt`` loads a
checkpoint written by the reference, and without it the binarizer has
seeded random weights (recall is then low; the run says so). ``--device
cpu`` runs the plain scoring path on the CPU. As in the reference CLI, a
lifecycle builder (``cli_builder``) holds every build parameter, and
bi-granular mode serves that builder's closure over a snapshot of the
codes.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, List

import numpy as np
import torch

from repro_torch.core.binarize_lib import (
    BinarizerConfig,
    RecurrentBinarizer,
    init_binarizer,
    make_encode_fn,
)
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.index import hnsw_lite, ivf
from repro_torch.index.flat import FlatFloat, FlatSDC
from repro_torch.kernels.sdc import ref as sdc_ref
from repro_torch.launch import binarizer_cache, lifecycle, serving


def cli_builder(index: str, *, k: int = 10, packed: bool = False, ef: int = 64, beam: int = 8,
                coarse_levels=None, k_coarse=None, probe_budget=None, device="cuda"):
    """The lifecycle builder the CLI serves ``index`` from, with the
    reference CLI's parameters (``repro/launch/serve.py``: IVF nlist 64,
    nprobe 32, seed 1; HNSW M 16, ef_construction 64; the builders'
    defaults otherwise). Its ``params`` are the single source of the build
    parameters: every branch of the CLI reads them, so the index served and
    a rebuild from a snapshot are the same index."""
    kw = dict(k=k, packed=packed, coarse_levels=coarse_levels, k_coarse=k_coarse,
              device=device)
    if index == "flat":
        return lifecycle.FlatBuilder(**kw)
    if index == "ivf":
        return lifecycle.IVFBuilder(nlist=64, nprobe=32, seed=1, probe_budget=probe_budget, **kw)
    return lifecycle.HNSWBuilder(M=16, ef_construction=64, ef=ef, beam=beam, **kw)


def encode_codes(model: RecurrentBinarizer, emb, batch: int = 4096) -> torch.Tensor:
    """Integer codes [N, code_dim] int8 of embeddings [N, dim], ``batch`` rows at a time."""
    encode = make_encode_fn(model)
    return torch.cat([encode(emb[i:i + batch]) for i in range(0, emb.shape[0], batch)], 0)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"


def serve_pipelined(encode_fn, search_fn, stream: List[Any], config: serving.ServingConfig):
    """Run ``stream`` through one ``ServingPipeline`` under ``config``'s policy.

    With the shed policy a rejected submit waits for the oldest
    outstanding request and is tried again. Returns (results in
    submission order, pipeline stats, number of sheds).
    """
    pipe = serving.ServingPipeline(encode_fn, search_fn, config=config)
    tickets, sheds = [], 0
    try:
        for b in stream:
            while True:
                try:
                    tickets.append(pipe.submit(b))
                    break
                except serving.RequestShed:
                    sheds += 1
                    pending = [t for t in tickets if not t.done()]
                    if pending:
                        pending[0].result()
        results = [t.result() for t in tickets]
    finally:
        pipe.close()
    return results, pipe.stats(), sheds


def recall_at_k(ids: torch.Tensor, gt) -> float:
    gt_t = torch.as_tensor(np.asarray(gt), device=ids.device).reshape(-1, 1)
    return float((ids.to(torch.int64) == gt_t).any(-1).float().mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", choices=["flat", "ivf", "hnsw"], default="flat",
                    help="index family")
    ap.add_argument("--docs", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--code-dim", type=int, default=128)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--coarse-levels", type=int, default=0, metavar="C",
                    help="bi-granular mode: coarse-scan the first C "
                         "residual levels (hot tier), then rerank the "
                         "--k-coarse survivors on the full-level codes "
                         "(cold tier); 0 disables (set with --k-coarse)")
    ap.add_argument("--k-coarse", type=int, default=0, metavar="K'",
                    help="bi-granular mode: survivors kept per query by "
                         "the coarse scan and rescored at full depth; "
                         "0 disables (set with --coarse-levels)")
    ap.add_argument("--ef", type=int, default=64,
                    help="hnsw: result-list width (and per-hop top-k)")
    ap.add_argument("--beam", type=int, default=8,
                    help="hnsw: frontier nodes expanded per hop")
    ap.add_argument("--packed", action="store_true",
                    help="int4 nibble-packed code storage (2 dims/byte; "
                         "halves scan bytes, bit-identical scores)")
    ap.add_argument("--probe-budget", type=int, default=0, metavar="B",
                    help="ivf: occupancy-weighted probe allocation — B "
                         "per-centroid rank slots are split across the "
                         "coarse centroids in proportion to list "
                         "occupancy instead of a flat per-query "
                         "nprobe; B = nprobe*nlist costs the same "
                         "scans as flat nprobe (and is bit-identical at "
                         "exact multiples); 0 disables")
    ap.add_argument("--batch", type=int, default=0,
                    help="serving batch size (0: all queries in one batch)")
    ap.add_argument("--rounds", type=int, default=4,
                    help="times the query stream is replayed for timing")
    ap.add_argument("--queue-depth", type=int, default=8,
                    help="admission-queue depth (requests)")
    ap.add_argument("--policy", choices=["block", "shed"], default="block",
                    help="admission policy when the queue is full")
    ap.add_argument("--seed", type=int, default=0,
                    help="corpus seed, and the weight seed without --ckpt")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="binarizer checkpoint written by the reference "
                         "(repro.launch.binarizer_cache); default: seeded "
                         "untrained weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if bool(args.coarse_levels) != bool(args.k_coarse):
        ap.error("--coarse-levels and --k-coarse must be set together")
    if args.coarse_levels and not 0 < args.coarse_levels < args.levels:
        ap.error(f"--coarse-levels must be in [1, {args.levels - 1}] "
                 f"(got {args.coarse_levels} of --levels {args.levels})")
    if args.probe_budget and args.index != "ivf":
        ap.error("--probe-budget only applies to --index ivf")
    device = resolve_device(args.device)
    where = device_name(device)

    print(f"[data] {args.docs} docs, {args.queries} queries, dim={args.dim}")
    docs, queries, gt = synthetic.clustered_corpus(args.seed, args.docs, args.queries, args.dim)

    bcfg = BinarizerConfig(input_dim=args.dim, code_dim=args.code_dim,
                           n_levels=args.levels, hidden_dim=2 * args.dim)
    if args.ckpt:
        model = binarizer_cache.load_checkpoint(args.ckpt, bcfg, device)
        print(f"[binarizer] {bcfg.total_bits} bits, loaded {args.ckpt}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = init_binarizer(bcfg, gen, device)
        print(f"[binarizer] {bcfg.total_bits} bits, weights UNTRAINED (seed "
              f"{args.seed}; training is not ported yet, pass --ckpt for "
              "trained weights): recall is not meaningful")

    d_codes = encode_codes(model, docs)
    flat_float = FlatFloat.build(docs, device=device)
    cl, kc = args.coarse_levels or None, args.k_coarse or None
    builder = cli_builder(args.index, k=args.k, packed=args.packed, ef=args.ef, beam=args.beam,
                          coarse_levels=cl, k_coarse=kc, probe_budget=args.probe_budget or None,
                          device=device)
    p = builder.params
    if args.index == "hnsw":
        print("[index] building NSW graph (host-side, O(N^2) incremental "
              "construction — use --docs <= 20000 for a quick demo)")
        t0 = time.perf_counter()
    if cl is not None:
        # Bi-granular mode serves the builder's closure over a host copy of
        # the codes: the cold fine tier stays in host memory, as in the
        # reference CLI.
        snapshot = lifecycle.CorpusSnapshot(codes=d_codes.cpu().numpy(),
                                            n_levels=bcfg.n_levels, embedding_version="v1")
        search = builder.build(snapshot)
        per_doc = lambda lv: (args.code_dim * lv + 7) // 8 + 4  # noqa: E731
        coarse_b = args.docs * per_doc(cl)
        fine_b = args.docs * per_doc(args.levels)
        nbytes = coarse_b + fine_b
        print(f"[index] bi-granular tiers (serialized): "
              f"coarse {coarse_b/2**20:.2f} MiB (hot, {cl}/{args.levels} "
              f"levels), fine {fine_b/2**20:.2f} MiB (cold), "
              f"rerank k'={kc}")
    elif args.index == "flat":
        index = FlatSDC.build(d_codes, bcfg.n_levels, packed=p["packed"], backend=p["backend"],
                              device=device)
        search = lambda q: index.search(q, p["k"])  # noqa: E731
        nbytes = index.nbytes()
    elif args.index == "hnsw":
        inv = sdc_ref.doc_inv_norms(d_codes, bcfg.n_levels).cpu().numpy()
        graph = hnsw_lite.build_hnsw(d_codes.cpu().numpy(), inv, n_levels=bcfg.n_levels,
                                     M=p["M"], ef_construction=p["ef_construction"],
                                     seed=p["seed"], packed=p["packed"])
        tables = hnsw_lite.prepare_batched(graph, device=device)
        search = lambda q: hnsw_lite.search_hnsw_batched(  # noqa: E731
            tables, q, k=p["k"], ef=p["ef"], beam=p["beam"], max_hops=p["max_hops"],
            backend=p["backend"])
        nbytes = graph.nbytes()
    else:
        index = ivf.build_ivf(d_codes, n_levels=bcfg.n_levels, nlist=p["nlist"],
                              kmeans_iters=p["kmeans_iters"], packed=p["packed"],
                              seed=p["seed"], device=device)
        if p["probe_budget"]:
            search = lambda q: ivf.search_budget(  # noqa: E731
                index, q, probe_budget=p["probe_budget"], k=p["k"], backend=p["backend"])
        else:
            search = lambda q: ivf.search(  # noqa: E731
                index, q, nprobe=p["nprobe"], k=p["k"], backend=p["backend"])
        nbytes = index.nbytes()
    if args.index == "hnsw":
        print(f"[index] NSW graph built in {time.perf_counter() - t0:.2f} s (host)")
    float_bytes = flat_float.nbytes()
    print(f"[index] {args.index}: {nbytes/2**20:.2f} MiB "
          f"(float flat: {float_bytes/2**20:.2f} MiB, "
          f"saving {100*(1-nbytes/float_bytes):.1f}%)")

    _, idx_f = flat_float.search(queries, args.k)
    encode = make_encode_fn(model)
    batch = args.batch or args.queries
    batches = [queries[i:i + batch] for i in range(0, args.queries, batch)]
    stream = batches * args.rounds
    n_q = args.queries * args.rounds

    serving.warmup(encode, search, batches)
    t0 = time.perf_counter()
    serving.serve_sequential(encode, search, stream)
    dt_seq = time.perf_counter() - t0

    pcfg = serving.ServingConfig(queue_depth=args.queue_depth, policy=args.policy)
    t0 = time.perf_counter()
    results, stats, sheds = serve_pipelined(encode, search, stream, pcfg)
    dt_pipe = time.perf_counter() - t0

    idx_b = torch.cat([ids for _, ids in results[: len(batches)]], 0)
    print(f"[serve] recall@{args.k}: float={recall_at_k(idx_f, gt):.4f} "
          f"BEBR={recall_at_k(idx_b, gt):.4f}")
    print(f"[serve] sequential: {1e3 * dt_seq / len(stream):.3f} ms/batch "
          f"({n_q / dt_seq:.0f} QPS on {where}, warmed)")
    shed = f", {sheds} shed" if sheds else ""
    print(f"[serve] pipelined: {1e3 * dt_pipe / len(stream):.3f} ms/batch "
          f"({n_q / dt_pipe:.0f} QPS on {where}; "
          f"p50={stats['latency_p50_ms']:.3f} ms p99={stats['latency_p99_ms']:.3f} ms, "
          f"scan stage idle {100 * stats['device_idle_frac']:.0f}%{shed})")


if __name__ == "__main__":
    main()
