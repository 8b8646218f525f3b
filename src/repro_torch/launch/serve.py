"""BEBR serving launcher (ports ``repro/launch/serve.py``): train the
binarizer, build a flat, IVF or HNSW index, and serve through the
replicated tier.

    PYTHONPATH=src python -m repro_torch.launch.serve --index flat --docs 20000 --queries 64
    PYTHONPATH=src python -m repro_torch.launch.serve --steps 300 --ckpt-cache DIR
    PYTHONPATH=src python -m repro_torch.launch.serve --index ivf [--probe-budget 2080]
    PYTHONPATH=src python -m repro_torch.launch.serve --index hnsw [--ef 64 --beam 8]
    PYTHONPATH=src python -m repro_torch.launch.serve --index flat|ivf|hnsw \
        --coarse-levels 2 --k-coarse 64
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
        --router least-outstanding --chaos r1.fail@2 --probe-every 0.05 --swap-after 4
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 --upgrade-after 4
    PYTHONPATH=src python -m repro_torch.launch.serve --autotune [--tune-cache DIR]
    PYTHONPATH=src python -m repro_torch.launch.serve --backend auto|pallas|xla

End to end on the card: a clustered synthetic corpus -> the recurrent
binarizer, trained emb2emb for ``--steps`` steps with the reference CLI's
``TrainConfig`` (``cli_train_config``; the checkpoint is cached under a
content digest, so only the first launch pays for training:
``--ckpt-cache``, else ``$REPRO_BEBR_CACHE``, else ``~/.cache/repro-bebr``;
see ``launch/binarizer_cache.py``), or loaded from ``--ckpt`` -> integer
codes (nibble-packed with ``--packed``) -> ``FlatSDC`` scanned by the
CUDA ``sdc_topk`` kernel, or an IVF index (nlist 64, nprobe 32, k-means
seed 1, the reference CLI's parameters) whose probed lists the CUDA
``sdc_gather_topk`` kernel scans, or an NSW graph (M 16, ef_construction
64, seed 0, built on the host in O(N^2)) walked by the batched-frontier
search, whose hops the same gather kernel scores (``--ef`` results,
``--beam`` nodes expanded a hop, at most 64 hops). As in the reference
CLI the stream is always served through the router (``serve_routed``):
``--replicas`` pipelines on the one device, sharing its index tensors,
behind a ``QueryRouter`` (``--router``), with optional chaos, canary
re-probe, deadlines, stuck-scan watchdogs, a rolling swap from a
snapshot of the codes (``--swap-after``), a live embedding-version
upgrade (``--upgrade-after``: a drifted backbone, the next version's
binarizer trained backward-compatibly, compat encoders registered both
ways, then a rolling swap to its index under mixed-version traffic) and
the shed-pressure autoscaler (``--tier-spec``). ``--coarse-levels C
--k-coarse K'`` serves any family in bi-granular mode: the index covers
the first C levels of the codes (hot tier, on the card) and the top-K'
survivors of each query are reranked on the full-level codes, which
stay in host memory (cold tier) and are gathered there per request.
Recall@k against the float-embedding exhaustive baseline, index bytes,
and sequential vs routed ms/batch. ``--device cpu`` trains and runs the
plain scoring path on the CPU. As in the reference CLI, a lifecycle
builder (``cli_builder``) holds every build parameter, and bi-granular
mode serves that builder's closure over a snapshot of the codes.
``--autotune`` sweeps the scan's launch geometry and the rerank's group
for the live shapes before serving and persists the winners
(``launch/autotune.py``, ``--tune-cache``); the encode is one CUDA-graph
replay a batch on the card (``binarize_lib.make_encode_fn``).
``--backend`` takes the reference CLI's names (``CLI_BACKENDS``): auto
(the CUDA kernels for tensors on the card), pallas (the CUDA kernels,
refused off the card before anything runs) and xla (the plain PyTorch
versions, only because they were asked for); interpret, Pallas's
interpreter, is refused with a message. ``main`` returns the routed run
(``RoutedRun``: each batch's scores and ids).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import losses
from repro_torch.core.binarize_lib import BinarizerConfig, RecurrentBinarizer, make_encode_fn
from repro_torch.core.trainer import TrainConfig, TrainState, bc_train_step, init_train_state
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.index import hnsw_lite, ivf
from repro_torch.index.flat import FlatFloat, FlatSDC
from repro_torch.kernels.sdc import ref as sdc_ref
from repro_torch.kernels.sdc.defaults import plan_for
from repro_torch.kernels.sdc.ops import resolve_backend
from repro_torch.launch import (
    autoscale,
    binarizer_cache,
    faults,
    lifecycle,
    proxy,
    serving,
)
from repro_torch.train import optim


def cli_train_config(dim: int = 256, code_dim: int = 128, levels: int = 4) -> TrainConfig:
    """The reference CLI's training configuration (``repro/launch/serve.py``):
    hidden width 2 * dim, a 4,096-row queue mining the top 64, Adam at lr
    2e-3 clipped at 5.0, the ``TrainConfig`` defaults otherwise."""
    bcfg = BinarizerConfig(input_dim=dim, code_dim=code_dim, n_levels=levels,
                           hidden_dim=2 * dim)
    return TrainConfig(
        binarizer=bcfg,
        queue=losses.QueueConfig(length=4096, dim=code_dim, top_k=64),
        adam=optim.AdamConfig(lr=2e-3, clip_norm=5.0),
    )


def train_binarizer(docs: np.ndarray, cfg: TrainConfig, steps: int = 300, batch: int = 256,
                    seed: int = 0, cache_dir: Optional[str] = None,
                    device="cuda") -> binarizer_cache.BinarizerCheckpoint:
    """Train the binarizer once per (corpus, config, steps, seed) digest.

    Later launches with identical inputs reload the checkpointed weights
    instead of re-running the emb2emb loop; see ``launch/binarizer_cache.py``.
    Returns a ``BinarizerCheckpoint`` (``.model`` is the binarizer).
    """
    return binarizer_cache.trained_binarizer(docs, cfg, steps=steps, batch=batch, seed=seed,
                                             cache_dir=cache_dir, device=device)


def bc_train_binarizer(old: RecurrentBinarizer, old_docs: np.ndarray, new_docs: np.ndarray,
                       cfg: TrainConfig, steps: int = 300, batch: int = 256, seed: int = 7,
                       device="cuda") -> TrainState:
    """Backward-compatible training (paper §3.2.3): warm-start phi_new
    from phi_old and anchor its output space to phi_old's on the shared
    items, so new-backbone queries can search the old binary index. The
    batches are the reference's numpy draws; ``old`` stays unchanged."""
    device = resolve_device(device)
    state = init_train_state(cfg, prng.key(seed, device), device)
    state = state._replace(model=copy.deepcopy(old), m_model=copy.deepcopy(old))
    rng = np.random.default_rng(seed + 1)
    dim = old_docs.shape[-1]
    for _ in range(steps):
        idx = rng.integers(0, old_docs.shape[0], batch)
        noise = rng.normal(size=(batch, dim)).astype(np.float32) * 0.02
        a = new_docs[idx] + noise
        a /= np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12
        # float32 as the reference's jnp.asarray makes them (backbone_upgrade
        # returns float64)
        state, _ = bc_train_step(state, old, torch.from_numpy(a).to(device, torch.float32),
                                 torch.from_numpy(old_docs[idx]).to(device, torch.float32), cfg)
    return state


def _next_version(tag: str) -> str:
    if tag.startswith("v") and tag[1:].isdigit():
        return f"v{int(tag[1:]) + 1}"
    return tag + "+1"


# The reference CLI's --backend names as the port's SDC backends: "pallas"
# (the hand-written kernels; raises without CUDA tensors), "xla" (the plain
# PyTorch versions, only where asked for) and "auto" (the kernels for CUDA
# tensors). Its "interpret" (Pallas's interpreter) has no counterpart.
CLI_BACKENDS = {"auto": "auto", "pallas": "cuda", "xla": "torch"}


def cli_builder(index: str, *, k: int = 10, packed: bool = False, ef: int = 64, beam: int = 8,
                coarse_levels=None, k_coarse=None, probe_budget=None, block_plan=None,
                backend: str = "auto", device="cuda"):
    """The lifecycle builder the CLI serves ``index`` from, with the
    reference CLI's parameters (``repro/launch/serve.py``: IVF nlist 64,
    nprobe 32, seed 1; HNSW M 16, ef_construction 64; the builders'
    defaults otherwise). Its ``params`` are the single source of the build
    parameters: every branch of the CLI reads them, so the index served and
    a rebuild from a snapshot are the same index. ``block_plan`` is
    ``--autotune``'s ``{kind: plan}``; ``backend`` the port's name of the
    SDC backend (``CLI_BACKENDS``)."""
    kw = dict(k=k, packed=packed, coarse_levels=coarse_levels, k_coarse=k_coarse,
              block_plan=block_plan, backend=backend, device=device)
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


@dataclasses.dataclass
class RoutedRun:
    """What ``serve_routed`` did: the results in stream order (``None`` for
    a batch that missed its deadline), the router's stats after close, the
    stream's wall seconds, the swap's report, the autoscaler's summary and
    the chaos injectors by replica."""

    results: List[Any]
    stats: dict
    seconds: float
    swap: Optional[lifecycle.SwapReport]
    autoscale: Optional[dict]
    injectors: Dict[int, faults.FaultInjector]


def serve_routed(encode, search, stream: List[Any], *, warm_batches: List[Any],
                 replicas: int = 1, router: str = "round-robin",
                 config: serving.ServingConfig = serving.ServingConfig(),
                 chaos: Optional[str] = None, builder=None, snapshot=None,
                 swap_after: int = 0, probe_every: float = 0.0,
                 scan_budget_s: float = 0.0, deadline_s: Optional[float] = None,
                 spec: Optional[autoscale.TierSpec] = None, embedding_version: str = "v1",
                 compat: Optional[proxy.CompatibilityMatrix] = None, swap_encode=None,
                 device="cuda") -> RoutedRun:
    """The reference CLI's routed run (``repro/launch/serve.py``): ``replicas``
    pipelines over the one ``(encode, search)`` pair behind a
    ``QueryRouter``, the stream driven by ``lifecycle.run_stream_with_swap``.

    The caller warms the pair first. ``chaos`` wraps the replicas after
    that (the fault schedule counts calls, and warmup must not consume
    it). Replicas on one device share it (``share_device``): also when a
    tier spec may add replicas later. ``swap_after`` rolls ``builder``
    over ``snapshot`` after that many submissions (a spec's
    ``swap_every_s`` sets it to mid-stream when unset);
    ``probe_every`` runs the canary re-probe loop; ``scan_budget_s`` arms
    the stuck-scan watchdogs; ``deadline_s`` gives each batch a budget;
    ``spec`` runs the shed-pressure ``Autoscaler`` over the stream, its
    replicas built on ``device`` from ``snapshot``. ``compat`` is the
    tier's ``CompatibilityMatrix`` (cross-version encoders) and
    ``swap_encode`` the encode the swap installs (default ``encode``): an
    upgrade swaps to the next version's snapshot and encoder. Stuck scans
    are released and every thread joined before this returns.
    """
    replica_fns, injectors = faults.apply_chaos([(encode, search)] * replicas, chaos)
    share = replicas > 1 or (spec is not None and spec.max_replicas > 1)
    tier = proxy.QueryRouter(
        proxy.ReplicaSet(replica_fns, config=config, share_device=share), policy=router,
        compat=compat)
    for r in range(replicas):
        tier.set_version(r, embedding_version)
    if spec is not None and spec.swap_every_s > 0 and not swap_after:
        # The spec's swap cadence, mapped onto a finite stream: one
        # rolling swap at mid-stream.
        swap_after = max(1, len(stream) // 2)
    controller = None
    if swap_after:
        controller = lifecycle.RollingSwapController(
            tier, builder, warm_batches=warm_batches[:1],
            encode_fn=encode if swap_encode is None else swap_encode)
    scaler = None
    try:
        if probe_every:
            tier.start_health_probe(warm_batches[0], interval=probe_every)
        if scan_budget_s:
            tier.start_watchdogs(scan_budget_s)
        if spec is not None:
            scaler = autoscale.Autoscaler(
                tier, spec, snapshot=snapshot, encode_fn=encode,
                warm_batches=warm_batches[:1], device=device,
                on_event=lambda msg: print(f"[autoscale] {msg}", flush=True))
            scaler.start()
        t0 = time.perf_counter()
        results, swap_report = lifecycle.run_stream_with_swap(
            tier, stream, controller=controller, snapshot=snapshot,
            swap_after=swap_after, deadline_s=deadline_s)
        seconds = time.perf_counter() - t0
    finally:
        if scaler is not None:
            scaler.stop()
        for inj in injectors.values():
            inj.release()  # a still-stuck scan would wedge close()'s joins
        tier.close()
    return RoutedRun(results=results, stats=tier.stats(), seconds=seconds, swap=swap_report,
                     autoscale=scaler.summary() if scaler is not None else None,
                     injectors=injectors)


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
    ap.add_argument("--steps", type=int, default=300,
                    help="binarizer training steps (and backward-compatible "
                         "training steps of --upgrade-after)")
    ap.add_argument("--ckpt-cache", default=None, metavar="DIR",
                    help="binarizer checkpoint cache dir (default: "
                         "$REPRO_BEBR_CACHE, else ~/.cache/repro-bebr); "
                         "training runs once per (corpus, config, steps, "
                         "seed, device type) digest and later launches "
                         "reload the weights")
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
    ap.add_argument("--backend", default="auto", choices=["auto", "pallas", "interpret", "xla"],
                    help="SDC scoring backend, the reference CLI's names: auto (the "
                         "CUDA kernels for tensors on the card, the plain PyTorch "
                         "versions on the CPU), pallas (the CUDA kernels; raises "
                         "without the card), xla (the plain PyTorch versions); "
                         "interpret (Pallas's interpreter) is refused")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep launch plans for the live corpus/kernel "
                         "signatures on startup and serve with the winners "
                         "(launch/autotune.py): on the card the sdc_topk "
                         "scan's geometry (queries per block, documents "
                         "per slice), and the bi-granular rerank's group; "
                         "winners persist in the tune cache so replicas "
                         "and later launches share one plan; scores are "
                         "bit-identical with or without this flag")
    ap.add_argument("--tune-cache", default=None, metavar="DIR",
                    help="block-plan tune cache dir (default: "
                         "$REPRO_BEBR_CACHE, else ~/.cache/repro-bebr); "
                         "the first launch to tune a signature pays the "
                         "sweep, everyone else loads its winner")
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
                    help="admission-queue depth (requests, per replica)")
    ap.add_argument("--policy", choices=["block", "shed"], default="block",
                    help="admission policy when a replica queue is full "
                         "(the proxy sheds only when EVERY replica is "
                         "saturated)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas behind the query router (on one "
                         "device they share it and the index tensors; each "
                         "still gets its own pipeline + admission queue)")
    ap.add_argument("--router", choices=sorted(proxy.ROUTING_POLICIES),
                    default="round-robin",
                    help="replica routing policy")
    ap.add_argument("--tier-spec", default=None, metavar="SPEC.json",
                    help="declarative tier spec (launch/autoscale.py "
                         "TierSpec JSON): replica min/max, index kind + "
                         "build params, router policy, admission policy/"
                         "queue depth, swap cadence, and scale thresholds. "
                         "Overrides --replicas/--router/--queue-depth/"
                         "--policy/--index, starts the tier at "
                         "min_replicas, and runs the shed-pressure "
                         "autoscaler over the stream (scale-up replicas "
                         "are built from the spec's index params, warmed, "
                         "and canary-probed before taking traffic; "
                         "scale-down drains losslessly). swap_every_s > 0 "
                         "schedules one rolling swap mid-stream when "
                         "--swap-after/--upgrade-after are unset")
    ap.add_argument("--embedding-version", default="v1",
                    help="embedding-version tag for the trained binarizer, "
                         "the corpus snapshot, and the tier's replicas; "
                         "typed SearchRequests are routed by this tag")
    ap.add_argument("--upgrade-after", type=int, default=0, metavar="N",
                    help="after N batches, run a LIVE embedding-version "
                         "migration: bc-train the next-version binarizer "
                         "against a drifted backbone "
                         "(data/synthetic.backbone_upgrade), register "
                         "cross-version compat encoders, and rolling-swap "
                         "every replica to the new index while the stream "
                         "mixes old- and new-version queries; 0 disables "
                         "(mutually exclusive with --swap-after)")
    ap.add_argument("--swap-after", type=int, default=0, metavar="N",
                    help="after N batches of the routed stream, run a "
                         "rolling index swap (drain -> rebuild -> warm -> "
                         "canary re-probe, one replica at a time) under "
                         "the live traffic; 0 disables")
    ap.add_argument("--probe-every", type=float, default=0.0, metavar="S",
                    help="period (s) of the router's canary health "
                         "re-probe loop — unhealthy replicas that answer "
                         "the canary are revived; 0 disables")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection on the serving "
                         "fns: comma-joined clauses "
                         "'[rN.][stage.]kind[@AT][xCOUNT][~PROB][:ARG]' "
                         "with kind in fail|delay|stick|flap (see "
                         "launch/faults.py). e.g. "
                         "'r0.search.fail@3,r1.search.delay~0.5:0.01' — "
                         "pair with --probe-every / --scan-budget-ms to "
                         "watch the tier heal")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-batch deadline (ms) enforced through the "
                         "tier: expired work is shed at dequeue (counted, "
                         "never scanned) and lands as a None result; "
                         "0 disables")
    ap.add_argument("--scan-budget-ms", type=float, default=0.0,
                    help="stuck-scan watchdog budget (ms): a scan running "
                         "past it marks its replica unhealthy and fails "
                         "its in-flight work over to the survivors; "
                         "0 disables")
    ap.add_argument("--seed", type=int, default=0,
                    help="corpus seed, and the training seed without --ckpt")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="binarizer checkpoint to load instead of training "
                         "(the port's cache files or the reference's "
                         "repro.launch.binarizer_cache archives)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.swap_after and args.upgrade_after:
        ap.error("--swap-after and --upgrade-after are mutually exclusive "
                 "(the upgrade IS a rolling swap, to the next-version index)")
    if bool(args.coarse_levels) != bool(args.k_coarse):
        ap.error("--coarse-levels and --k-coarse must be set together")
    if args.coarse_levels and not 0 < args.coarse_levels < args.levels:
        ap.error(f"--coarse-levels must be in [1, {args.levels - 1}] "
                 f"(got {args.coarse_levels} of --levels {args.levels})")
    if args.probe_budget and args.index != "ivf":
        ap.error("--probe-budget only applies to --index ivf")
    if args.backend == "interpret":
        ap.error("--backend interpret runs the Pallas kernels in Pallas's interpreter, "
                 "which has no CUDA counterpart: use pallas (the CUDA kernels) or xla "
                 "(the plain PyTorch versions)")
    backend = CLI_BACKENDS[args.backend]

    # Declarative tier spec: ONE artifact describes the tier's desired
    # state; the flags it covers are overridden so an operator cannot
    # half-apply it. The autoscaler re-applies the same spec as it
    # resizes.
    spec = None
    if args.tier_spec:
        try:
            spec = autoscale.TierSpec.from_file(args.tier_spec)
        except autoscale.InvalidTierSpec as e:
            ap.error(f"--tier-spec: {e}")
        args.index = spec.index
        args.replicas = spec.min_replicas
        args.router = spec.router
        args.queue_depth = spec.queue_depth
        args.policy = spec.policy
        print(f"[tier-spec] {args.tier_spec}: index={spec.index} "
              f"replicas=[{spec.min_replicas}, {spec.max_replicas}] "
              f"router={spec.router} policy={spec.policy} "
              f"water=({spec.low_water}, {spec.high_water}) "
              f"cooldown={spec.cooldown_s}s window={spec.window_s}s")
    device = resolve_device(args.device)
    where = device_name(device)
    resolve_backend(backend, device)  # --backend pallas off the card raises here

    print(f"[data] {args.docs} docs, {args.queries} queries, dim={args.dim}")
    docs, queries, gt = synthetic.clustered_corpus(args.seed, args.docs, args.queries, args.dim)

    tcfg = cli_train_config(args.dim, args.code_dim, args.levels)
    bcfg = tcfg.binarizer
    if args.ckpt:
        model = binarizer_cache.load_checkpoint(args.ckpt, bcfg, device)
        print(f"[binarizer] {bcfg.total_bits} bits, loaded {args.ckpt}")
    else:
        print(f"[train] binarizer {bcfg.total_bits} bits "
              f"({32 * args.dim // bcfg.total_bits}x compression), "
              f"{args.steps} steps")
        t0 = time.perf_counter()
        ckpt = train_binarizer(docs, tcfg, steps=args.steps, seed=args.seed,
                               cache_dir=args.ckpt_cache, device=device)
        model = ckpt.model
        verb = "trained" if ckpt.trained else "loaded cached checkpoint"
        print(f"[train] {verb} ({ckpt.digest}) in {time.perf_counter() - t0:.1f}s")

    d_codes = encode_codes(model, docs)
    flat_float = FlatFloat.build(docs, device=device)
    cl, kc = args.coarse_levels or None, args.k_coarse or None

    # Adaptive execution: tune (or reload) a plan per kernel kind for the
    # live corpus shapes, at the serving batch's query count (the card's
    # default scan geometry depends on it). Plans only move launch
    # geometry: every score below is bit-identical with block_plan=None.
    block_plan = None
    if args.autotune:
        from repro_torch.launch import autotune

        block_plan = {}
        for kind in ("scan", "rerank"):
            tp = autotune.tuned_block_plan(
                kind, code_dim=args.code_dim, n_shard=args.docs, packed=args.packed,
                k=(kc or args.k), n_levels=args.levels, backend=backend,
                cache_dir=args.tune_cache, sample_q=args.batch or args.queries, device=device)
            block_plan[kind] = tp.plan
            print(f"[tune] {kind}: block_q={tp.plan.block_q} "
                  f"block_n={tp.plan.block_n} ({tp.plan.source}"
                  f"{', swept now' if tp.tuned else ''})")

    if spec is not None:
        # The spec's build params are the single source of truth: the
        # initial index, every swap and every scale-up build the same index.
        builder = spec.make_index_builder(device)
    else:
        builder = cli_builder(args.index, k=args.k, packed=args.packed, ef=args.ef,
                              beam=args.beam, coarse_levels=cl, k_coarse=kc,
                              probe_budget=args.probe_budget or None, block_plan=block_plan,
                              backend=backend, device=device)
    p = builder.params
    snapshot = None
    if cl is not None or args.swap_after or spec is not None:
        # A host copy of the codes: bi-granular mode keeps its cold fine
        # tier there, and a swap or a scale-up rebuilds from it.
        snapshot = lifecycle.CorpusSnapshot(codes=d_codes.cpu().numpy(), n_levels=bcfg.n_levels,
                                            embedding_version=args.embedding_version)
    if args.index == "hnsw":
        print("[index] building NSW graph (host-side, O(N^2) incremental "
              "construction — use --docs <= 20000 for a quick demo)")
        t0 = time.perf_counter()
    if cl is not None:
        # Bi-granular mode serves the builder's closure over the host
        # snapshot: the cold fine tier stays in host memory, and a swap of
        # the same snapshot installs the same (digest-cached) closure.
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
        scan_plan = plan_for(block_plan, "scan")
        search = lambda q: index.search(q, p["k"], block_plan=scan_plan)  # noqa: E731
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

    from_version = to_version = stream_meta = enc_new = None
    compat = proxy.CompatibilityMatrix()
    if args.upgrade_after:
        # Live embedding-version migration: bc-train the next-version
        # binarizer against a drifted backbone, register cross-version
        # compat encoders (v_new queries search the v_old index and vice
        # versa through the bc-anchored output space), then rolling-swap
        # the tier to the new index under mixed-version traffic.
        from_version = args.embedding_version
        to_version = _next_version(from_version)
        print(f"[upgrade] backbone drift + bc-training {to_version} "
              f"binarizer ({args.steps} steps)")
        new_docs = synthetic.backbone_upgrade(docs, 5)
        new_queries = synthetic.backbone_upgrade(queries, 5)
        new_state = bc_train_binarizer(model, docs, new_docs, tcfg, steps=args.steps,
                                       device=device)
        enc_new = make_encode_fn(new_state.model)
        compat.register(to_version, from_version, enc_new)
        compat.register(from_version, to_version, encode)
        snapshot = lifecycle.CorpusSnapshot(
            codes=encode_codes(new_state.model, new_docs).cpu().numpy(),
            n_levels=bcfg.n_levels, embedding_version=to_version)
        # the compat hop runs enc_new on the still-v_old replicas before
        # the swap reaches them: warm it like every other stage
        serving.warmup_replicas([(enc_new, search)], batches[:1])
        new_batches = [new_queries[i:i + batch] for i in range(0, args.queries, batch)]
        # mixed-version stream: each round alternates an old-version and a
        # new-version request per batch index
        stream, stream_meta = [], []
        for _ in range(args.rounds):
            for i, (b, nb) in enumerate(zip(batches, new_batches)):
                stream.append(serving.SearchRequest(queries=b, embedding_version=from_version))
                stream_meta.append((from_version, i))
                stream.append(serving.SearchRequest(queries=nb, embedding_version=to_version))
                stream_meta.append((to_version, i))

    # Drive the router directly so --policy is honoured: submits that shed
    # off EVERY replica's full admission queue are retried after a short
    # pause (stats["shed"]); the block policy back-pressures inside submit.
    run = serve_routed(
        encode, search, stream, warm_batches=batches, replicas=args.replicas,
        router=args.router,
        config=serving.ServingConfig(queue_depth=args.queue_depth, policy=args.policy),
        chaos=args.chaos, builder=builder, snapshot=snapshot,
        swap_after=args.swap_after or args.upgrade_after,
        probe_every=args.probe_every, scan_budget_s=args.scan_budget_ms / 1e3,
        deadline_s=(args.deadline_ms / 1e3) if args.deadline_ms else None, spec=spec,
        embedding_version=args.embedding_version, compat=compat, swap_encode=enc_new,
        device=device)
    results, stats = run.results, run.stats

    first = results[: len(batches)]
    if stream_meta is not None:
        # mixed-version stream: per-version recall over every answered
        # request across the whole migration window
        hits = {from_version: [], to_version: []}
        for (ver, i), r in zip(stream_meta, results):
            if r is None:
                continue
            ids = r[1]
            hits[ver].append(recall_at_k(ids, np.asarray(gt)[i * batch:i * batch + ids.shape[0]]))
        per_ver = " ".join(f"{v}={np.mean(h):.4f}" if h else f"{v}=n/a" for v, h in hits.items())
        print(f"[serve] recall@{args.k}: float={recall_at_k(idx_f, gt):.4f} "
              f"BEBR[{per_ver}] (across the live migration)")
    elif all(r is not None for r in first):
        idx_b = torch.cat([ids for _, ids in first], 0)
        print(f"[serve] recall@{args.k}: float={recall_at_k(idx_f, gt):.4f} "
              f"BEBR={recall_at_k(idx_b, gt):.4f}")
    else:
        # Deadline sheds are accounted answers, but recall needs the full
        # first replay of the stream.
        print(f"[serve] recall@{args.k}: float={recall_at_k(idx_f, gt):.4f} BEBR=n/a "
              f"({sum(r is None for r in first)}/{len(first)} first-round batches "
              "missed their deadline)")
    print(f"[serve] sequential: {1e3 * dt_seq / len(stream):.3f} ms/batch "
          f"({n_q / dt_seq:.0f} QPS on {where}, warmed)")
    n_q_routed = sum(getattr(b, "n_queries", None) or b.shape[0] for b in stream)
    shed = f", {stats['shed']} shed" if stats["shed"] else ""
    print(f"[serve] routed ({args.replicas} replica(s), {args.router}): "
          f"{1e3 * run.seconds / len(stream):.3f} ms/batch "
          f"({n_q_routed / run.seconds:.0f} QPS on {where}; "
          f"p50={stats['latency_p50_ms']:.3f} ms p99={stats['latency_p99_ms']:.3f} ms, "
          f"device idle {100 * stats['device_idle_frac']:.0f}%{shed})")
    if args.replicas > 1:
        for s in stats["per_replica"]:
            print(f"[serve]   replica {s['replica']}: {s['requests']} req "
                  f"({s['queries']} queries), shed {s['shed']}, device idle "
                  f"{100 * s['device_idle_frac']:.0f}%")
    if run.swap is not None:
        rep = run.swap
        print(f"[swap] rolling swap -> {rep.version.tag}: {rep.swapped} "
              f"replica(s) re-indexed in {rep.total_s * 1e3:.0f} ms under "
              f"live traffic (zero results lost)")
        for row in rep.replicas:
            print(f"[swap]   replica {row['replica']}: "
                  f"drain {row['drain_s'] * 1e3:.0f} ms, "
                  f"build {row['build_s'] * 1e3:.0f} ms, "
                  f"warm {row['warm_s'] * 1e3:.0f} ms, "
                  f"probe {row['probe_s'] * 1e3:.0f} ms "
                  f"(generation {row['generation']})")
    if to_version is not None and run.swap is not None:
        finals = [pr["embedding_version"] for pr in stats["per_replica"]]
        print(f"[upgrade] {from_version} -> {to_version} migration: "
              f"{stats['compat_dispatches']} compat-encoded dispatch(es) "
              f"covered the transition window; final replica versions "
              f"{finals}")
    if args.probe_every:
        print(f"[probe] canary re-probe every {args.probe_every}s: "
              f"{stats['revivals']} revival(s), states {stats['states']}")
    if args.deadline_ms:
        print(f"[deadline] {args.deadline_ms:.0f} ms budget: "
              f"{stats['deadline_expired']} expired "
              f"({sum(r is None for r in results)}/{len(results)} batches "
              "unanswered)")
    if args.scan_budget_ms:
        print(f"[watchdog] {args.scan_budget_ms:.0f} ms scan budget: "
              f"{stats['watchdog_stalls']} stall(s), "
              f"{stats['failovers']} failover(s)")
    if run.autoscale is not None:
        sm = run.autoscale
        print(f"[autoscale] spec [{sm['replicas_min']}, "
              f"{sm['replicas_max']}]: {sm['scale_ups']} scale-up(s), "
              f"{sm['scale_downs']} scale-down(s) over {sm['decisions']} "
              f"tick(s); replicas ended at {sm['replicas']} "
              f"(seen [{sm['min_replicas_seen']}, "
              f"{sm['max_replicas_seen']}])")
    for i, inj in sorted(run.injectors.items()):
        fired = ", ".join(f"{s}#{n}:{k}" for s, n, k in inj.log) or "none"
        print(f"[chaos] replica {i}: {len(inj.log)} fault(s) fired "
              f"({fired})")
    return run

if __name__ == "__main__":
    main()
